"""Worker processes, one per card — the port's counterpart of the JAX
reference's 1-D device mesh (its ``core/SEMANTICS.md`` §Device-sharded
sweeps).

The reference lowers a sweep's ``[K]`` scenario axis, or an RL env batch,
onto a ``jax.sharding.Mesh`` and runs one program on every device. Eager
PyTorch issues every op from the host, and the port's loops are bound by
that dispatch, so one host thread driving D cards would issue D times the
ops and gain nothing. Here a :class:`Mesh` is D worker processes instead,
each a single-worker executor on a ``spawn`` context running the port's
single-card code on its own card:

* a CUDA worker is pinned to its card by ``CUDA_VISIBLE_DEVICES``, set
  before CUDA initialises in the worker, so it sees the card as ``cuda:0``
  and runs on ``"cuda"``;
* a CPU worker runs on ``"cpu"`` with one intra-op thread; D of them stand
  in for the reference's forced host devices.

Workers start at first use and are kept, keyed by (device type, card, slot),
so later sweeps and updates reuse them (a service and a streamed run sweep
many times); :func:`shutdown` stops them, and runs at exit. Only CPU tensors
cross a process boundary, pickled by this module (:func:`dumps` refuses a
CUDA tensor; no CUDA IPC). A plain CPU tensor crosses as its view of its
storage's raw bytes, sent once a storage, and a storage of ``SPILL_BYTES``
or more through a temporary file rather than the executor's pipe.
:func:`to_host` and :func:`to_device` move a tree's tensors keeping each
tensor's storage layout (stride-0 views stay views) and which tensors share
an object. A worker that raises re-raises in the parent with its traceback
(the executor's ``__cause__``); a worker that dies raises
:class:`RuntimeError`. No block is ever rerun in the parent.

Each call sends back the worker's deltas of the launch counters
(``event_fuse.LAUNCHES``, ``flash_attention.LAUNCHES``,
``ssd_scan.LAUNCHES``) and of ``engine.HOST_SYNCS``; :meth:`Call.result`
adds them to the parent's, so the counters count the whole grid.

:func:`mesh` takes D and fills the card list with 0..D-1. Inside
:func:`pinned_cards` it takes the given list instead (``[0, 0]``: two
workers on one card), which is how ``chip_smoke.py`` drives two workers on
a one-card machine; it is not a user option.
"""
from __future__ import annotations

import atexit
import concurrent.futures as cf
import contextlib
import io
import itertools
import math
import multiprocessing
import os
import pickle
import tempfile
import threading
import weakref
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

_WORKER_DEVICE: Optional[torch.device] = None  # set in a worker only
_RESIDENT: Dict[int, Any] = {}  # a worker's state kept across calls, by token


def _init_worker(device_type: str, visible: str) -> None:
    """Executor initializer: pin a CUDA worker to its card before CUDA
    initialises; one intra-op thread for a CPU worker."""
    global _WORKER_DEVICE
    if device_type == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
        if torch.cuda.device_count() != 1:
            raise RuntimeError(
                f"shard worker pinned to card {visible!r} sees "
                f"{torch.cuda.device_count()} cards: CUDA initialised before "
                "the pin"
            )
    else:
        torch.set_num_threads(1)
    _WORKER_DEVICE = torch.device(device_type)


def worker_device() -> torch.device:
    """The device of the worker this runs in (``"cuda"`` or ``"cpu"``)."""
    if _WORKER_DEVICE is None:
        raise RuntimeError("worker_device() is only defined inside a shard worker")
    return _WORKER_DEVICE


def _counters() -> Dict[str, Any]:
    from repro_torch.core import engine
    from repro_torch.kernels import event_fuse, flash_attention, ssd_scan

    return {
        "event_fuse": dict(event_fuse.LAUNCHES),
        "flash_attention": dict(flash_attention.LAUNCHES),
        "ssd_scan": dict(ssd_scan.LAUNCHES),
        "host_syncs": engine.HOST_SYNCS,
    }


def _delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    out = {"host_syncs": after["host_syncs"] - before["host_syncs"]}
    for k in ("event_fuse", "flash_attention", "ssd_scan"):
        out[k] = {n: v - before[k].get(n, 0) for n, v in after[k].items()}
    return out


def _run(payload: "_Packed") -> "_Packed":
    """A task in a worker: ``fn(*args)`` and the counters' deltas it made,
    both packed by :func:`_pack`."""
    fn, args = _unpack(payload)
    before = _counters()
    out = fn(*args)
    return _pack((out, _delta(before, _counters())), "a worker's result")


def _open(token: int, opener: Callable, *args) -> None:
    _RESIDENT[token] = opener(*args)


def _apply(token: int, fn: Callable, *args):
    return fn(_RESIDENT[token], *args)


def _close(token: int) -> None:
    _RESIDENT.pop(token, None)


# ---------------------------------------------------------------------------
# what crosses a process boundary
# ---------------------------------------------------------------------------

class _Storage:
    """A CPU tensor storage's bytes, pickled once however many tensors view
    it (the pickler's memo), as one protocol-5 buffer: copied once into the
    stream (or the file) and once out of it."""

    def __init__(self, raw: torch.Tensor):
        self.raw = raw  # uint8 over the whole storage

    def __reduce__(self):
        return _bytes_storage, (pickle.PickleBuffer(self.raw.numpy()),)


def _bytes_storage(buf) -> torch.UntypedStorage:
    if len(buf) == 0:
        return torch.UntypedStorage(0)
    return torch.frombuffer(buf, dtype=torch.uint8).untyped_storage()


def _view(storage: torch.UntypedStorage, dtype, offset: int, size, stride) -> torch.Tensor:
    return torch.empty(0, dtype=dtype).set_(storage, offset, size, stride)


class _Pickler(pickle.Pickler):
    """Refuses a non-CPU tensor; pickles a plain CPU tensor as a view (its
    dtype, offset, size and stride) of its storage's raw bytes, so tensors
    that share a storage share it after the trip, each layout is kept and
    the bytes are copied once each way. Parameters, tensors that require
    grad and other kinds take torch's own reduction."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._storages: Dict[Tuple[int, int], _Storage] = {}

    def reducer_override(self, obj):
        if not isinstance(obj, torch.Tensor):
            return NotImplemented
        if obj.device.type != "cpu":
            raise ValueError(
                f"a {obj.device.type} tensor of shape {tuple(obj.shape)} cannot "
                "cross to a shard worker: only CPU tensors do (move it with "
                "shard.to_host)"
            )
        if (type(obj) is not torch.Tensor or obj.requires_grad or obj.layout != torch.strided
                or obj.is_quantized or obj.is_conj() or obj.is_neg()):
            return NotImplemented
        s = obj.untyped_storage()
        key = (s.data_ptr(), s.nbytes())
        if key not in self._storages:
            raw = torch.empty(0, dtype=torch.uint8).set_(s)
            self._storages[key] = _Storage(raw)
        return _view, (self._storages[key], obj.dtype, obj.storage_offset(),
                       tuple(obj.size()), tuple(obj.stride()))


def dumps(obj, what: str = "an argument", buffer_callback=None) -> bytes:
    """``obj`` pickled for a shard worker; ValueError, saying why, when it
    holds a CUDA tensor or does not pickle (a lambda, a closure).
    ``buffer_callback`` is pickle's: a storage buffer it returns a false
    value for is left out of the stream."""
    buf = io.BytesIO()
    try:
        _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL,
                 buffer_callback=buffer_callback).dump(obj)
    except (pickle.PicklingError, TypeError, AttributeError) as e:
        raise ValueError(
            f"{what} does not pickle, and a shard worker receives everything "
            f"pickled: {type(e).__name__}: {e}"
        ) from e
    return buf.getvalue()


# a storage of this many bytes or more crosses through a file: the
# executor's pipe moves 100-200 MiB/s (an 8 MiB argument took 82 ms on an
# 8-core host, 3.0 GB of pipeline stages 32 s beside an H100)
SPILL_BYTES = 1 << 20


class _Packed(NamedTuple):
    """What crosses the executor's pipe: the pickle stream, and the file
    holding its large storages' bytes (None without any) with their sizes."""
    stream: bytes
    path: Optional[str]
    sizes: Tuple[int, ...]


def _pack(obj, what: str) -> _Packed:
    """:func:`dumps`, with every storage of ``SPILL_BYTES`` or more written
    to a temporary file; :func:`_unpack` reads and removes it."""
    big: List[pickle.PickleBuffer] = []

    def in_stream(b: pickle.PickleBuffer) -> bool:
        if b.raw().nbytes < SPILL_BYTES:
            return True
        big.append(b)
        return False

    stream = dumps(obj, what, in_stream)
    if not big:
        return _Packed(stream, None, ())
    fd, path = tempfile.mkstemp(prefix="repro_torch_shard_", suffix=".bin")
    try:
        with os.fdopen(fd, "wb") as f:
            for b in big:
                f.write(b.raw())
    except BaseException:
        os.unlink(path)
        raise
    return _Packed(stream, path, tuple(b.raw().nbytes for b in big))


def _unpack(packed: _Packed):
    bufs = []
    if packed.path is not None:
        try:
            with open(packed.path, "rb", buffering=0) as f:
                for n in packed.sizes:
                    b = bytearray(n)
                    view, got = memoryview(b), 0
                    while got < n:
                        k = f.readinto(view[got:])
                        if not k:
                            raise EOFError(f"{packed.path} ended {n - got} bytes short")
                        got += k
                    bufs.append(b)
        finally:
            os.unlink(packed.path)
    return pickle.loads(packed.stream, buffers=bufs)


def _discard(packed: _Packed) -> None:
    """Remove what :func:`_pack` wrote when no one will read it."""
    if packed.path is not None:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(packed.path)


def tree_map(fn: Callable[..., torch.Tensor], tree, *others):
    """``fn`` on every tensor of ``tree`` (tensors, tuples and named tuples,
    lists, dicts); every other leaf unchanged. With ``others``, trees of the
    same structure, ``fn`` takes each one's leaf beside the tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *others, strict=True)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *others, strict=True)]
    if isinstance(tree, dict):
        for o in others:
            if not isinstance(o, dict) or o.keys() != tree.keys():
                raise ValueError(f"a tree of keys {sorted(tree)} against {o!r}")
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return tree


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, in :func:`tree_map`'s order."""
    out: List[torch.Tensor] = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def _mover(device: torch.device):
    """A tensor mover to ``device`` that keeps each tensor's storage layout
    (size, stride, offset: a stride-0 view stays one) and maps a tensor, and
    a storage, that it has seen to the same result."""
    memo: Dict[Any, Any] = {}

    def move(x: torch.Tensor) -> torch.Tensor:
        if x.device == device:
            return x
        if id(x) in memo:
            return memo[id(x)][1]
        s = x.untyped_storage()
        skey = (x.device, s.data_ptr(), s.nbytes())
        if skey not in memo:
            raw = torch.empty(0, dtype=torch.uint8, device=x.device).set_(s)
            memo[skey] = raw.to(device).untyped_storage()
        y = torch.empty(0, dtype=x.dtype, device=device).set_(
            memo[skey], x.storage_offset(), x.size(), x.stride())
        memo[id(x)] = (x, y)  # keep x alive: its id must not be reused
        return y

    return move


def to_host(tree):
    """``tree`` with every tensor on the CPU (layout and sharing kept)."""
    return tree_map(_mover(torch.device("cpu")), tree)


def to_device(tree, device):
    """``tree`` with every tensor on ``device`` (layout and sharing kept)."""
    return tree_map(_mover(torch.device(device)), tree)


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------

_WORKERS: Dict[Tuple[str, int, int], cf.ProcessPoolExecutor] = {}
_LOCK = threading.Lock()
_PINNED: Optional[Tuple[int, ...]] = None
_TOKENS = itertools.count(1)


def _add(delta: Dict[str, Any]) -> None:
    from repro_torch.core import engine
    from repro_torch.kernels import event_fuse, flash_attention, ssd_scan

    engine.HOST_SYNCS += delta["host_syncs"]
    for mod, k in ((event_fuse, "event_fuse"), (flash_attention, "flash_attention"),
                   (ssd_scan, "ssd_scan")):
        for n, v in delta[k].items():
            mod.LAUNCHES[n] = mod.LAUNCHES.get(n, 0) + v


def _visible_list() -> Optional[List[str]]:
    v = os.environ.get("CUDA_VISIBLE_DEVICES")
    return None if v is None else [c.strip() for c in v.split(",") if c.strip()]


def _worker(key: Tuple[str, int, int]) -> cf.ProcessPoolExecutor:
    device_type, card, _ = key
    with _LOCK:
        ex = _WORKERS.get(key)
        if ex is None:
            parent = _visible_list()
            visible = parent[card] if parent is not None else str(card)
            ex = cf.ProcessPoolExecutor(
                max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(device_type, visible),
            )
            _WORKERS[key] = ex
        return ex


def _drop(key) -> None:
    with _LOCK:
        ex = _WORKERS.pop(key, None)
    if ex is not None:
        ex.shutdown(wait=False, cancel_futures=True)


def shutdown() -> None:
    """Stop every worker (at exit, and between tests that want a cold pool)."""
    with _LOCK:
        workers = list(_WORKERS.values())
        _WORKERS.clear()
    for ex in workers:
        ex.shutdown(wait=True, cancel_futures=True)


atexit.register(shutdown)


class Call:
    """A task on one worker. :meth:`result` waits, adds the worker's counter
    deltas to the parent's (once) and returns what the task returned."""

    def __init__(self, future: cf.Future, key, d: int, sent: _Packed):
        self._future, self._key, self._d, self._sent = future, key, d, sent
        self._done = False
        self._out = None

    def _raw(self) -> _Packed:
        try:
            return self._future.result()
        except BrokenProcessPool as e:
            _drop(self._key)
            _discard(self._sent)
            raise RuntimeError(
                f"shard worker {self._d} ({self._key[0]} card {self._key[1]}) "
                "died before it answered; nothing was rerun in the parent"
            ) from e

    def result(self):
        if not self._done:
            out, delta = _unpack(self._raw())
            _add(delta)
            self._out, self._done = out, True
        return self._out

    def discard(self) -> None:
        """Wait for the task and drop what it returned (its spill file
        removed, its counter deltas not added); an error it raised is
        dropped too."""
        if self._done:
            return
        self._done = True
        try:
            raw = self._raw()
        except Exception:
            return
        _discard(raw)


def gather(calls: Sequence[Optional[Call]]) -> list:
    """Each call's result, in order (None for a None). Once one raises, the
    calls after it are still waited for and their results discarded
    (:meth:`Call.discard`: no spill file stays under ``TMPDIR``), and then
    the first error is raised."""
    out: list = []
    error: Optional[BaseException] = None
    for c in calls:
        if c is None:
            out.append(None)
        elif error is not None:
            c.discard()
        else:
            try:
                out.append(c.result())
            except BaseException as e:  # the rest are drained first
                error = e
    if error is not None:
        raise error
    return out


class Mesh:
    """D workers, worker ``d`` on card ``cards[d]`` of ``device_type``.
    ``shape`` names the mesh's axes and sizes, in order (the reference's
    ``mesh.shape``): ``{"data": D}`` by default, or a grid such as
    ``{"data": D, "model": M}`` whose worker ``d * M + m`` sits at (d, m)."""

    def __init__(self, device_type: str, cards: Sequence[int],
                 shape: Optional[Dict[str, int]] = None):
        self.device_type = device_type
        self.cards = tuple(int(c) for c in cards)
        self.shape = {"data": len(self.cards)} if shape is None else dict(shape)
        n = math.prod(self.shape.values())
        if n != len(self.cards):
            raise ValueError(f"a mesh of shape {self.shape} holds {n} workers, not "
                             f"{len(self.cards)}")
        seen: Dict[int, int] = {}
        self._keys = []
        for c in self.cards:
            self._keys.append((device_type, c, seen.get(c, 0)))
            seen[c] = seen.get(c, 0) + 1

    def __len__(self) -> int:
        return len(self.cards)

    def submit(self, d: int, fn: Callable, *args) -> Call:
        """``fn(*args)`` on worker ``d``; ``fn`` must be a module-level
        function and ``args`` hold CPU tensors only."""
        payload = _pack((fn, args), f"a call of {getattr(fn, '__name__', fn)!r}")
        key = self._keys[d]
        try:
            future = _worker(key).submit(_run, payload)
        except BrokenProcessPool as e:
            _drop(key)
            _discard(payload)
            raise RuntimeError(f"shard worker {d} ({key[0]} card {key[1]}) is "
                               "dead") from e
        return Call(future, key, d, payload)

    def resident(self, opener: Callable, args: Sequence[tuple]) -> "Resident":
        """State kept in the workers across calls: worker ``d`` keeps
        ``opener(*args[d])``."""
        return Resident(self, opener, args)


class Resident:
    """State that lives in the workers of a :class:`Mesh` under one token:
    :meth:`call` runs ``fn(state_d, *args)`` on every worker and returns the
    results in worker order, :meth:`call_each` the same with each worker's
    own arguments (both through :func:`gather`: when a worker raises, every
    other result is still read or discarded); :meth:`close` frees it (also
    when the handle is collected)."""

    def __init__(self, mesh: Mesh, opener: Callable, args: Sequence[tuple]):
        self.mesh, self.token = mesh, next(_TOKENS)
        gather([mesh.submit(d, _open, self.token, opener, *a) for d, a in enumerate(args)])
        self._finalizer = weakref.finalize(self, _close_all, mesh, self.token)

    def call(self, fn: Callable, *args) -> list:
        """``fn(state_d, *args)`` on every worker, waited for."""
        return gather([self.mesh.submit(d, _apply, self.token, fn, *args)
                       for d in range(len(self.mesh))])

    def call_each(self, fn: Callable, args: Sequence[Optional[tuple]]) -> list:
        """``fn(state_d, *args[d])`` on every worker ``d`` whose ``args[d]``
        is not None, all submitted before any is waited for; worker ``d``
        receives only ``args[d]``. A worker given None runs nothing, and its
        result is None."""
        if len(args) != len(self.mesh):
            raise ValueError(f"{len(args)} argument tuples for {len(self.mesh)} workers")
        return gather([None if a is None else self.mesh.submit(d, _apply, self.token, fn, *a)
                       for d, a in enumerate(args)])

    def close(self) -> None:
        self._finalizer()


def _close_all(mesh: Mesh, token: int) -> None:
    for d, key in enumerate(mesh._keys):
        if key in _WORKERS:
            with contextlib.suppress(RuntimeError, BrokenProcessPool):
                mesh.submit(d, _close, token)


@contextlib.contextmanager
def pinned_cards(cards: Sequence[int]):
    """Inside, :func:`mesh` takes ``cards`` for its card list (their length
    is the device count it accepts) and :func:`visible_cards` their count."""
    global _PINNED
    old, _PINNED = _PINNED, tuple(int(c) for c in cards)
    try:
        yield
    finally:
        _PINNED = old


def visible_cards() -> int:
    """The cards a sharded call may use: the pinned list's length, else
    ``torch.cuda.device_count()``."""
    return len(_PINNED) if _PINNED is not None else torch.cuda.device_count()


def mesh(devices: int, device: torch.device, shape: Optional[Dict[str, int]] = None) -> Mesh:
    """The D-worker mesh on ``device``'s type: cards 0..D-1, or the pinned
    list (:func:`pinned_cards`); ``shape`` as :class:`Mesh` takes it."""
    device = torch.device(device)
    if _PINNED is not None and device.type == "cuda":
        if devices != len(_PINNED):
            raise ValueError(f"devices={devices} but {len(_PINNED)} cards are "
                             f"pinned ({list(_PINNED)})")
        return Mesh("cuda", _PINNED, shape)
    return Mesh(device.type, range(devices), shape)


def block_bounds(n: int, d: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``d`` contiguous blocks of ``n`` rows, as
    ``np.array_split`` cuts them (the first ``n % d`` one row longer)."""
    q, r = divmod(n, d)
    out, lo = [], 0
    for i in range(d):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out
