"""Tensor-parallel training of the dense decoders over worker ranks — the
port's counterpart of the reference's sharded train step on a ``("data",
"model")`` mesh (``launch/train.py --model-parallel M`` over
``models/sharding.py``'s rules).

The reference places parameters and batch with ``NamedSharding``\\ s and lets
GSPMD insert the collectives. Eager PyTorch has no partitioner, so the port
writes the Megatron pairing out:

* a :class:`Grid` of D x M ranks is ``core/shard.py``'s worker processes
  (``launch/mesh.py`` ``make_host_mesh``), rank ``r = d * M + m`` at data
  coordinate d and model coordinate m, one card each on CUDA (two ranks may
  share a card inside ``shard.pinned_cards``), one intra-op thread each on
  the CPU;
* the ranks rendezvous through a ``FileStore`` in a temporary directory and
  build one ``torch.distributed`` process group a model row (the M ranks of
  one d) and one a data column (the D ranks of one m), constructed directly
  (``ProcessGroupGloo``, ``ProcessGroupNCCL``), so no global default group
  is set and one worker may serve several grids;
* each rank holds only its block of every parameter, by
  :func:`rank_layout`: ``models/sharding.py``'s ``param_spec`` (vocab rows
  of ``embed`` and ``lm_head``, ``wq``/``wk``/``wv``/``w_gate``/``w_up``
  column-parallel, ``wo``/``w_down`` row-parallel, 1-D leaves replicated),
  except that ``wk`` and ``wv`` stay whole where the KV heads do not divide
  the model axis (the reference's rule splits their columns, which would
  cut a head): each rank then reads the KV head its query heads need;
* the forward enters each column-parallel region through an identity whose
  backward sums the input's gradient over the model group, and leaves each
  row-parallel one through a sum over the group whose backward is the
  identity (:class:`ModelGroup`); the embedding is a masked lookup of the
  rank's rows, summed; the loss is the cross entropy over the vocabulary's
  blocks (a max, a sum of exps and the gold logit, reduced over the group),
  with the targets counted over the data group so the data ranks' losses
  sum to the global batch's mean (``Transformer.loss``);
* the train step (``train_step.make_train_step``) then sums each gradient
  over the data group, and a replicated leaf used inside a sharded region
  (``wk``/``wv`` kept whole, the qk-norm gains) also over the model group
  (it saw only this rank's heads); the global norm counts each element once
  (the blocks' squares summed over the model group, a replicated leaf
  taken once); AdamW runs elementwise on the blocks.

Scope: ``family == "dense"`` archs without ``fsdp`` and under the ``tp``
sharding mode, with an elementwise optimizer (AdamW, SGD) and no gradient
compression: internlm2-1.8b, glm4-9b, qwen3-14b and stablelm-3b. Any other
arch or layout raises ``NotImplementedError`` naming ROADMAP Queue 1 item
12c.6 (:func:`check_supported`).

Backend (``backend``, recorded as :attr:`Grid.backend`): ``"gloo"`` on the
CPU and where ranks share a card (NCCL refuses two ranks on one card),
``"nccl"`` where every rank has its own card. A reduction runs in the
tensor's own dtype, never upcast: the bf16 row-parallel outputs and their
gradients sum in bf16, the loss's f32 terms in f32 (gloo takes bf16 CUDA
tensors, sum and max alike: :meth:`Grid.check_collectives`, run by
``chip_smoke.py`` phase 20). Collectives time out after :data:`TIMEOUT_S`.
Each rank counts its all-reduces, their bytes and their host wall; a step
asked to time them (``Grid.step(batch, time_all_reduces=True)``) waits for
the card before and after each one, so their ms are the reductions' own
and the step carries barriers it does not otherwise need.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard
from repro_torch.models import sharding
from repro_torch.models.convert import RefLeaf, leaves_to_tree, reference_leaves, tree_values
from repro_torch.models.layers import Attention, SwiGLU
from repro_torch.models.transformer import build_model
from repro_torch.training.optimizer import Optimizer
from repro_torch.training.train_step import (
    TrainStepConfig, init_opt_state, make_train_step, opt_state_to_tree,
)

F32 = torch.float32
BACKENDS = ("gloo", "nccl")
SHARDED, REPLICATED, PARTIAL = "sharded", "replicated", "partial"
TIMEOUT_S = 300.0  # a rank's rendezvous and each collective


def check_supported(cfg: ArchConfig, model_parallel: int,
                    step_cfg: TrainStepConfig = TrainStepConfig()) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP Queue 1 item 12c.6 for
    an arch or layout the rank grid does not run."""
    why = None
    if cfg.block_program() != (("dense", cfg.n_layers),) or cfg.family != "dense":
        why = f"the {cfg.family!r} arch {cfg.name} (program {cfg.block_program()})"
    elif cfg.fsdp:
        why = "fsdp"
    elif cfg.sharding_mode != "tp":
        why = f"sharding_mode {cfg.sharding_mode!r}"
    elif cfg.optimizer != "adamw":
        why = f"the {cfg.optimizer!r} optimizer"
    elif step_cfg.compression:
        why = f"compression {step_cfg.compression!r}"
    if why is not None:
        raise NotImplementedError(
            f"--model-parallel {model_parallel}: tensor parallelism covers the dense "
            f"decoders under tp with AdamW; {why} is ROADMAP Queue 1 item 12c.6")


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How the ranks hold one reference leaf: ``spec`` over its stacked
    shape, and ``kind``: :data:`SHARDED` (a block a model coordinate),
    :data:`REPLICATED` (whole, outside any sharded region) or
    :data:`PARTIAL` (whole, but used inside a sharded region, so each rank's
    gradient is a part to sum over the model group)."""

    path: str
    spec: sharding.P
    kind: str


def rank_layout(cfg: ArchConfig, mesh: Dict[str, int], leaves: Sequence[RefLeaf]
                ) -> List[LeafLayout]:
    """The layout of each leaf of the full model (``reference_leaves``, in
    order) on a ``{"data": D, "model": M}`` grid; ``ValueError`` where a
    sharded dim does not divide M."""
    m = mesh["model"]
    heads, kv = cfg.n_heads, cfg.n_kv_heads
    if heads % m:
        raise ValueError(f"{cfg.name}: {heads} query heads do not split over model={m}")
    if kv % m and m % kv:
        raise ValueError(f"{cfg.name}: {kv} KV heads neither split over model={m} nor "
                         "divide it")
    out = []
    for leaf, spec in zip(leaves, sharding.params_specs(cfg, mesh, leaves)):
        path = sharding.leaf_path(leaf)
        name = leaf.path[-1]
        if name in ("wk", "wv") and kv % m:
            spec = sharding.P(*([None] * len(leaf.shape)))
        if "model" in spec:
            kind = SHARDED
        elif m > 1 and (name in ("wk", "wv", "q_norm", "k_norm")):
            kind = PARTIAL
        else:
            kind = REPLICATED
        if name in ("embed", "lm_head", "wq", "wo", "w_gate", "w_up", "w_down") \
                and kind != SHARDED:
            raise ValueError(f"{cfg.name}: {path} {leaf.shape} does not split over "
                             f"model={m}")
        out.append(LeafLayout(path, spec, kind))
    return out


def _tensor_spec(leaf: RefLeaf, spec: sharding.P) -> sharding.P:
    """The spec of each of ``leaf``'s port tensors: its stacked axes
    dropped (never sharded), reversed where the tensor is transposed."""
    n_stack = len(leaf.shape) - leaf.tensors[0].ndim
    if any(a is not None for a in spec[:n_stack]):
        raise ValueError(f"{leaf.name}: a stacked axis is sharded ({spec})")
    own = tuple(spec[n_stack:])
    return sharding.P(*(own[::-1] if leaf.transposed else own))


# ---------------------------------------------------------------------------
# the model group: collectives and their autograd pairs
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce(g.clone(memory_format=torch.contiguous_format)), None


class _Exit(torch.autograd.Function):
    """Summed over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class ModelGroup:
    """A rank's collectives and its place in the grid, set as ``tp`` on the
    rank's :class:`Transformer`, its attention and MLP modules."""

    def __init__(self, cfg: ArchConfig, mesh: Dict[str, int], coords: Dict[str, int],
                 model_pg, data_pg, kinds: Sequence[str], kv_heads: int):
        self.mesh, self.coords = dict(mesh), dict(coords)
        self.model_pg, self.data_pg = model_pg, data_pg
        self.kinds = list(kinds)
        self.kv_heads = kv_heads
        self.vocab_n = cfg.padded_vocab // mesh["model"]
        self.vocab_lo = coords["model"] * self.vocab_n
        self.timed = False  # wait for the card around each all-reduce
        self.n_reduces, self.reduce_s, self.reduce_bytes = 0, 0.0, 0

    # ---- collectives ----
    def _all_reduce(self, x: torch.Tensor, pg, op: str = "sum") -> torch.Tensor:
        """``x`` (contiguous, this call's own) reduced in place over ``pg``."""
        if pg is None:
            return x
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]
        sync = self.timed and x.is_cuda
        if sync:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        pg.allreduce([x], opts).wait()
        if sync:
            torch.cuda.synchronize(x.device)
        self.reduce_s += time.perf_counter() - t0
        self.n_reduces += 1
        self.reduce_bytes += x.numel() * x.element_size()
        return x

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self._all_reduce(x, self.model_pg, op)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group (a new tensor, no gradient)."""
        return self._all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                                self.data_pg)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_pg is None else _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.model_pg is None else _Exit.apply(x, self)

    # ---- the vocabulary's blocks ----
    def vocab_rows(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(each id's row in this rank's block, clamped into it; whether the
        id falls in the block)."""
        local = ids - self.vocab_lo
        inside = (local >= 0) & (local < self.vocab_n)
        return local.clamp(0, self.vocab_n - 1), inside

    def cross_entropy_terms(self, lg: torch.Tensor, tgt: torch.Tensor):
        """(log-sum-exp over the whole vocabulary, the gold logit) from this
        rank's logits ``lg`` ``[..., Vp / M]`` f32 and the global targets."""
        m = self.reduce(lg.detach().amax(-1).contiguous(), "max")
        logz = m + torch.log(self.exit(torch.exp(lg - m[..., None]).sum(-1)))
        rows, inside = self.vocab_rows(tgt)
        gold = torch.gather(lg, -1, rows[..., None])[..., 0] * inside.to(lg.dtype)
        return logz, self.exit(gold)

    # ---- the step's gradients ----
    def _bucket_sum(self, grads: List[torch.Tensor], idx: Sequence[int], pg) -> None:
        """Sum ``grads[i]`` for ``i`` in ``idx`` over ``pg``, one flat buffer
        a dtype."""
        if pg is None:
            return
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i in idx:
            by_dtype.setdefault(grads[i].dtype, []).append(i)
        for ids in by_dtype.values():
            flat = self._all_reduce(torch.cat([grads[i].reshape(-1) for i in ids]), pg)
            for i, part in zip(ids, flat.split([grads[i].numel() for i in ids])):
                grads[i] = part.view_as(grads[i])

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's gradient summed over the data group, and a
        :data:`PARTIAL` leaf's also over the model group."""
        grads = list(grads)
        self._bucket_sum(grads, range(len(grads)), self.data_pg)
        self._bucket_sum(grads, [i for i, k in enumerate(self.kinds) if k == PARTIAL],
                         self.model_pg)
        return grads

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole, unsharded gradient: the blocks' squares
        summed over the model group, a replicated leaf's taken once."""
        dev = grads[0].device
        own = torch.zeros((), dtype=F32, device=dev)
        whole = torch.zeros((), dtype=F32, device=dev)
        for g, kind in zip(grads, self.kinds):
            sq = torch.sum(torch.square(g.to(F32)))
            if kind == SHARDED:
                own = own + sq
            else:
                whole = whole + sq
        return torch.sqrt(self.reduce(own.contiguous()) + whole)


# ---------------------------------------------------------------------------
# a rank (worker side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _RankSpec:
    cfg: ArchConfig
    mesh: Dict[str, int]
    rank: int
    store: str
    backend: str
    make_optimizer: Callable[[], Optimizer]
    step_cfg: TrainStepConfig
    seed: int
    params: Optional[List[torch.Tensor]]  # this rank's blocks, or None: init from seed
    opt_state: Optional[Any]  # an OptState of this rank's blocks, or None


def _groups(spec: _RankSpec, device: torch.device):
    """This rank's model-row and data-column process groups (None for a
    group of one)."""
    n = sharding._prod(spec.mesh.values())
    store = dist.FileStore(spec.store, n)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store.set_timeout(timeout)
    c = sharding.mesh_coords(spec.mesh, spec.rank)

    def group(name: str, key: int, rank: int, size: int):
        prefixed = dist.PrefixStore(f"{name}/{key}", store)
        if spec.backend == "gloo":
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = timeout
            opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
            pg = dist.ProcessGroupGloo(prefixed, rank, size, opts)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(prefixed, rank, size, opts)
        return pg if size > 1 else None

    model_pg = group("model", c["data"], c["model"], spec.mesh["model"])
    data_pg = group("data", c["model"], c["data"], spec.mesh["data"])
    return model_pg, data_pg, c


class _Rank:
    """A rank's state in its worker: the sharded model, its train step and
    optimizer state."""

    def __init__(self, spec: _RankSpec):
        dev = shard.worker_device()
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        self.device = dev
        cfg, mesh = spec.cfg, spec.mesh
        model_pg, data_pg, coords = _groups(spec, dev)
        if spec.params is None:  # the full model from the seed, then its blocks
            model = build_model(cfg, dev)
            model.init(torch.Generator(device=dev).manual_seed(spec.seed))
        else:
            model = build_model(cfg, "meta")
        full = reference_leaves(model)
        layout = rank_layout(cfg, mesh, full)
        owner = {id(p): (mod, name) for mod in model.modules()
                 for name, p in mod._parameters.items() if p is not None}
        for leaf, lay in zip(full, layout):
            tspec = _tensor_spec(leaf, lay.spec)
            for t in leaf.tensors:
                block = sharding.shard_of(t, tspec, mesh, coords)
                new = (torch.empty(block.shape, dtype=t.dtype, device=dev) if t.is_meta
                       else block.clone(memory_format=torch.contiguous_format))
                mod, name = owner[id(t)]
                setattr(mod, name, nn.Parameter(new, requires_grad=False))
        del full
        m = mesh["model"]
        kv_sharded = cfg.n_kv_heads % m == 0
        kv_heads = cfg.n_kv_heads // m if kv_sharded else 1
        group = ModelGroup(cfg, mesh, coords, model_pg, data_pg,
                           [lay.kind for lay in layout], kv_heads)
        model.tp = group
        h_local = cfg.n_heads // m
        n_rep = cfg.n_heads // cfg.n_kv_heads
        for mod in model.modules():
            if isinstance(mod, (Attention, SwiGLU)):
                mod.tp = group
            if isinstance(mod, Attention) and not kv_sharded:
                mod.kv_select = (coords["model"] * h_local // n_rep, 1)
        self.model, self.group, self.coords = model, group, coords
        self.leaves = reference_leaves(model)
        if spec.params is not None:
            for leaf, value in zip(self.leaves, spec.params):
                leaf.write(value.to(dev))
        self.optimizer = spec.make_optimizer()
        self.step_fn = make_train_step(model, self.optimizer, spec.step_cfg)
        if spec.opt_state is None:
            self.opt_state = init_opt_state(model, self.optimizer)
        else:
            self.opt_state = shard.to_device(spec.opt_state, dev)
        self.step_s: List[float] = []
        if dev.type == "cuda":  # the peak of what the rank runs, not of its set-up
            torch.cuda.reset_peak_memory_stats()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _open_rank(spec: _RankSpec) -> _Rank:
    return _Rank(spec)


def _rank_step(r: _Rank, batch: Dict[str, Any], timed: bool) -> Dict[str, Any]:
    g = r.group
    g.timed = timed
    n0, s0 = g.n_reduces, g.reduce_s
    r.sync()
    t0 = time.perf_counter()
    r.opt_state, metrics = r.step_fn(r.opt_state, batch)
    out = {k: float(v) for k, v in metrics.items()}
    r.sync()
    r.step_s.append(time.perf_counter() - t0)
    out.update(step_ms=1e3 * r.step_s[-1], all_reduces=g.n_reduces - n0,
               all_reduce_ms=1e3 * (g.reduce_s - s0))
    return out


def _rank_state(r: _Rank) -> Tuple[List[torch.Tensor], Any]:
    """This rank's leaves (the reference's layout) and optimizer state, on
    the host."""
    return ([leaf.stack().cpu() for leaf in r.leaves], shard.to_host(r.opt_state))


def _rank_prefill(r: _Rank, tokens: torch.Tensor) -> torch.Tensor:
    logits, _ = r.model.prefill(tokens.to(r.device))
    return logits.cpu()


def _rank_collectives(r: _Rank) -> Dict[str, bool]:
    """Each of sum and max over the model group, in bf16 and f32 on the
    rank's device, against the value it must give."""
    g, m = r.group, r.coords["model"]
    size = g.mesh["model"]
    out = {}
    for dtype in (torch.bfloat16, F32):
        for op, want in (("sum", size * (size - 1) / 2), ("max", size - 1)):
            x = torch.full((4,), float(m), dtype=dtype, device=r.device)
            got = g.reduce(x, op)
            out[f"{op} {str(dtype).split('.')[1]}"] = bool((got == want).all())
    return out


def _rank_stats(r: _Rank) -> Dict[str, Any]:
    g = r.group
    out = {"rank": dict(r.coords), "all_reduces": g.n_reduces,
           "all_reduce_ms": 1e3 * g.reduce_s, "all_reduce_bytes": g.reduce_bytes,
           "params": sum(p.numel() for p in r.model.parameters())}
    if r.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


# ---------------------------------------------------------------------------
# the grid (parent side)
# ---------------------------------------------------------------------------

def _opt_blocks(state, layout: Sequence[LeafLayout], mesh, coords):
    """An optimizer state's per-leaf lists cut to the blocks at ``coords``."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)._make(_opt_blocks(x, layout, mesh, coords) for x in state)
    if isinstance(state, list):
        return [sharding.shard_of(torch.as_tensor(x), lay.spec, mesh, coords).contiguous()
                for x, lay in zip(state, layout)]
    return None if state is None else torch.as_tensor(state)


def _opt_unshard(states: Dict[int, Any], layout: Sequence[LeafLayout], mesh):
    """The inverse of :func:`_opt_blocks`, from the ranks' states."""
    first = next(iter(states.values()))
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)._make(
            _opt_unshard({r: s[i] for r, s in states.items()}, layout, mesh)
            for i in range(len(first)))
    if isinstance(first, list):
        return [sharding.unshard({r: s[i] for r, s in states.items()}, lay.spec, mesh)
                for i, lay in enumerate(layout)]
    return first


class Grid:
    """D x M tensor-parallel ranks training ``cfg``'s model.

    ``params`` is the reference's parameter tree (numpy arrays or tensors;
    ``convert.params_to_arrays``' layout) or None, in which case every rank
    draws the full model from ``seed`` on its device (the same draws as
    ``model.init(torch.Generator(device).manual_seed(seed))`` in one
    process) and keeps its blocks. ``opt_state`` is the reference's
    ``OptState`` tree of the same parameters, or None for a fresh one.
    ``make_optimizer`` builds the optimizer in each rank, so it must pickle
    (a module-level function or a ``functools.partial`` of one) and be
    elementwise. :meth:`step` takes the global batch; rank (d, m) trains on
    the d-th of D contiguous blocks of it."""

    def __init__(self, cfg: ArchConfig, model_parallel: int, devices: Optional[int] = None,
                 *, make_optimizer: Callable[[], Optimizer],
                 step_cfg: TrainStepConfig = TrainStepConfig(), params=None, opt_state=None,
                 seed: int = 0, device=None, backend: Optional[str] = None):
        from repro_torch.launch.mesh import make_host_mesh

        check_supported(cfg, model_parallel, step_cfg)
        self.cfg = cfg
        self.workers = make_host_mesh(model_parallel, devices, device)
        self.mesh = dict(self.workers.shape)
        self.backend = backend or default_backend(self.workers)
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.backend == "nccl" and (self.workers.device_type != "cuda"
                                       or len(set(self.workers.cards)) < len(self.workers)):
            raise ValueError(f"nccl takes one card a rank; ranks on {self.workers.device_type} "
                             f"cards {list(self.workers.cards)} (use gloo)")
        meta = reference_leaves(build_model(cfg, "meta"))
        self.layout = rank_layout(cfg, self.mesh, meta)
        self.shapes = [leaf.shape for leaf in meta]
        self._leaves = meta
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_tp_")
        store = os.path.join(self._tmp, "store")
        n = len(self.workers)
        values = None if params is None else [
            torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v)
            for v in tree_values(meta, params)]

        def spec(r):
            coords = sharding.mesh_coords(self.mesh, r)
            blocks = None if values is None else [
                sharding.shard_of(v, lay.spec, self.mesh, coords).contiguous()
                for v, lay in zip(values, self.layout)]
            opt = None if opt_state is None else _opt_blocks(
                _opt_lists(opt_state, meta), self.layout, self.mesh, coords)
            return (_RankSpec(cfg, self.mesh, r, store, self.backend, make_optimizer,
                              step_cfg, seed, blocks, opt),)

        try:
            self._ranks = self.workers.resident(_open_rank, [spec(r) for r in range(n)])
        except BaseException:
            shutil.rmtree(self._tmp, ignore_errors=True)
            raise

    def _batch_blocks(self, batch: Dict[str, Any]) -> List[tuple]:
        d = self.mesh["data"]
        b = int(np.shape(batch["tokens"])[0])
        if b % d:
            raise ValueError(f"a batch of {b} does not split over data={d}")
        out = []
        for r in range(len(self.workers)):
            lo, hi = shard.block_bounds(b, d)[sharding.mesh_coords(self.mesh, r)["data"]]
            out.append(({k: torch.as_tensor(np.asarray(v)[lo:hi]) if not torch.is_tensor(v)
                         else v[lo:hi].cpu() for k, v in batch.items()},))
        return out

    def step(self, batch: Dict[str, Any], time_all_reduces: bool = False
             ) -> Dict[str, float]:
        """One train step of the global ``batch``: rank 0's metrics (every
        rank's loss and norm are the same), with its ``step_ms``,
        ``all_reduces`` and ``all_reduce_ms``. ``time_all_reduces`` waits
        for the card around each all-reduce, so that ``all_reduce_ms`` is
        their device time and not their enqueue's."""
        blocks = [(*args, time_all_reduces) for args in self._batch_blocks(batch)]
        return self._ranks.call_each(_rank_step, blocks)[0]

    def _first_row(self) -> List[int]:
        return [r for r in range(len(self.workers))
                if sharding.mesh_coords(self.mesh, r)["data"] == 0]

    def state(self) -> Tuple[List[torch.Tensor], Any]:
        """(the full parameters, one tensor a reference leaf; the optimizer
        state with per-leaf lists), assembled from the first data row's
        blocks."""
        row = set(self._first_row())
        got = self._ranks.call_each(_rank_state, [() if r in row else None
                                                  for r in range(len(self.workers))])
        params = [sharding.unshard({r: got[r][0][i] for r in row}, lay.spec, self.mesh)
                  for i, lay in enumerate(self.layout)]
        opt = _opt_unshard({r: got[r][1] for r in row}, self.layout, self.mesh)
        return params, opt

    def state_tree(self) -> Dict[str, Any]:
        """``{"params": the reference's tree, "opt": its OptState}``, the
        launcher's checkpoint layout."""
        params, opt = self.state()
        return {"params": leaves_to_tree(self._leaves, params),
                "opt": opt_state_to_tree(opt, self._leaves)}

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """``Transformer.prefill``'s last-position logits ``[B, 1, Vp]`` of
        the first data row's ranks (each rank prefills the whole batch and
        returns its vocabulary block), concatenated on the host."""
        row = set(self._first_row())
        got = self._ranks.call_each(_rank_prefill, [(tokens.cpu(),) if r in row else None
                                                    for r in range(len(self.workers))])
        return torch.cat([got[r] for r in sorted(row)], -1)

    def check_collectives(self) -> List[Dict[str, bool]]:
        """Each rank's sum and max of a small bf16 and f32 tensor over its
        model group against the values they must give (a backend that
        refuses a dtype or an op raises here)."""
        return self._ranks.call(_rank_collectives)

    def stats(self) -> List[Dict[str, Any]]:
        """Each rank's all-reduce count, ms and bytes since it opened, its
        parameter count and, on CUDA, its peak device memory since it
        opened (the full model it drew at set-up already freed)."""
        return self._ranks.call(_rank_stats)

    def close(self) -> None:
        self._ranks.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "Grid":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _opt_lists(tree, leaves: Sequence[RefLeaf]):
    """An optimizer-state tree (the reference's ``OptState`` of parameter
    trees) with each parameter tree as a list in the leaves' order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(_opt_lists(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return [torch.as_tensor(v) for v in tree_values(leaves, tree)]
    return tree


def default_backend(workers: shard.Mesh) -> str:
    """``"nccl"`` where every rank has its own card, else ``"gloo"``."""
    if workers.device_type == "cuda" and len(set(workers.cards)) == len(workers):
        return "nccl"
    return "gloo"
