"""Dry run on one H100: the FLOPs, bytes and roofline of every (architecture
x input-shape) cell, counted from the port's own step functions — the
counterpart of the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder TPU devices
and parses the HLO (``launch/hlo_analysis.py``). The port emits no HLO: it
builds the model on fake CPU tensors (``launch/shapes.py``: shapes, dtypes,
no memory) and runs the cell's real step on them under :class:`Counter`, a
dispatch mode that sees every aten op. Nothing is allocated and nothing is
computed: this is a count, not a run on the CPU. The fake tensors sit on
the CPU device on purpose, so every kernel wrapper takes its plain version
(``kernels/flash_attention.py``, ``kernels/ssd_scan.py``), which does the
same arithmetic as the kernel, and training takes the plain routes as it
does on the card (``train_step.plain_routes``). The reference does the same
on placeholder CPU devices, so :func:`lower_cell` takes no device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k --out out/dryrun_torch

``--arch all --shape all --spars-rl --device cpu`` is the whole sweep (the
paper's own cell, ``spars-rl``, runs for real, on the card unless
``--device cpu``).

``--mesh DxM`` (or ``PxDxM``; the reference's ``--mesh single|multi`` are
16x16 and 2x16x16) counts each LM cell's arguments per card on that mesh
of H100s: ``args_bytes_per_device`` becomes the parameters, optimizer
state, batch and cache under ``models/sharding.py``'s specs (AdamW's
moments follow their parameters, Adafactor's statistics and the step
replicate, as the reference's dry run places them), beside
``args_bytes_one_card`` and ``fits_per_card`` against one card's
``HBM_BYTES``. FLOPs, bytes and the roofline stay the one-card counts, and
``collective_wire_bytes_per_device`` stays 0 (the step's all-reduces are
not counted yet; ``collective_note`` says so). ``--mesh 1``, the default,
writes today's one-card record.

A cell's step:

* ``train_4k``: ``make_train_step`` with the reference's accumulation
  (``shapes.train_accum_steps``), the arch's optimizer and remat;
* ``prefill_32k``: ``Transformer.prefill``;
* ``decode_32k``, ``long_500k``: ``decode_step`` against ``init_cache(B,
  S)`` at position ``S - 1``.

What :class:`Counter` counts:

* ``flops_computed``: matmul and convolution FLOPs of every op the step
  runs, by ``torch.utils.flop_counter``'s table (``FlopCounterMode``'s
  convention, the reference's ``analyze_hlo`` dot FLOPs), remat replays and
  the backward included;
* ``flops_per_device``: ``flops_computed`` less the causal attention's
  masked half: the plain route computes the whole score square, and every
  attention call's ``(B, H, Sq, Sk, hd, causal, offset)`` is recorded
  (:class:`AttentionCall`) and its masked pairs taken off in closed form,
  forward and backward. This is the work the inputs need, so a kernel that
  skips masked blocks cannot read above 100 % of the bound;
* ``op_bytes``: result and operand bytes of every non-view aten op, the
  counterpart of ``analyze_hlo``'s bytes at op level: how much the eager
  program moves (the train step's ``RefLeaf`` stacked copies included);
* ``hbm_bytes_per_device``, the bound's bytes: each input byte read once
  and each output byte written once — parameters, optimizer state, batch,
  cache and their updates (a decode step's cache writes are the bytes its
  in-place writes reach).

Loops are counted as ``hlo_analysis`` counts a scan body, by their trip
count: the sLSTM's position loop (``SLstm.scan``) as its first step once
and its second ``S - 1`` times, forward and backward (autograd hooks
weight the backward nodes the repeated step made), and the train step's
microbatches (``train_step.microbatches``) as the first one ``accum``
times; the record names each under ``trip_counted``.
``Counter(trip_count=False)`` steps every iteration.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import mesh
from repro_torch.launch.shapes import (
    SHAPE_SETS,
    ShapeSpec,
    applicable,
    batch_specs,
    decode_specs,
    fake_mode,
    fake_model,
    train_accum_steps,
)
from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models import ssm as S
from repro_torch.models.convert import reference_leaves
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import build_model
from repro_torch.training import train_step
from repro_torch.training.optimizer import OptState, _AdamMoments

MESH = "1xH100"
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, at 700 W"

# ops that move no data: views by schema, and these
_NO_BYTES = {
    torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default,
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _bytes(tree) -> int:
    """Bytes of the tensors of a pytree (each by its shape and dtype)."""
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionCall:
    """One attention call over a materialised ``[B, H, Sq, Sk]`` score
    square; ``passes`` is the matmuls over it: QKᵀ and PV forward, and in
    a step that trains, the backward's dQ, dK, dP and dV."""

    b: int
    h: int
    sq: int
    sk: int
    hd: int
    causal: bool
    q_offset: int
    passes: int

    def masked_pairs(self) -> int:
        """(query, key) pairs the causal mask hides: query i, at position
        ``q_offset + i``, sees keys ``[0, q_offset + i]``."""
        if not self.causal:
            return 0
        short = max(0, min(self.sk - self.q_offset, self.sq))  # rows that see < Sk keys
        seen = (short * (self.q_offset + 1) + short * (short - 1) // 2
                + (self.sq - short) * self.sk)
        return self.sq * self.sk - seen

    def masked_flops(self) -> int:
        return 2 * self.hd * self.b * self.h * self.masked_pairs() * self.passes


class Counter(TorchDispatchMode):
    """A dispatch mode that counts every aten op run under it: matmul
    FLOPs (``flops``), op bytes (``op_bytes``), ops (``ops``), the bytes
    in-place ops write into ``watched`` tensors' storage
    (``watched_writes``), with the attention calls and trip-counted loops
    that :func:`count` records."""

    def __init__(self, trip_count: bool = True, watched=()):
        super().__init__()
        self.trip_count = trip_count
        self.flops = 0
        self.op_bytes = 0
        self.ops = 0
        self.watched_writes = 0
        self.attention: List[AttentionCall] = []
        self.loops: Dict[str, Dict[str, int]] = {}
        self._watched = {StorageWeakRef(x.untyped_storage()) for x in _tensors(watched)}
        self._weight = [1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        w = self._weight[-1]
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.flops += w * flops(*args, **kwargs, out_val=out)
        results = _tensors(out)
        if results and not func.is_view and func not in _NO_BYTES:
            self.op_bytes += w * (_bytes((args, kwargs)) + _bytes(results))
            self.ops += w
            if self._watched:
                self._count_writes(func, args, w)
        return out

    def _count_writes(self, func, args, w: int) -> None:
        for spec, x in zip(func._schema.arguments, args):
            written = spec.alias_info is not None and spec.alias_info.is_write
            if (written and isinstance(x, torch.Tensor)
                    and StorageWeakRef(x.untyped_storage()) in self._watched):
                self.watched_writes += w * x.numel() * x.element_size()

    # ---- attention ----
    def attention_call(self, q, k, v, causal: bool, q_offset) -> None:
        b, sq, h, hd = q.shape
        passes = 2
        if torch.is_grad_enabled() and torch._C._current_graph_task_id() == -1:
            # a forward that trains (not remat's replay inside the
            # backward): the backward's matmuls over the square
            passes += (int(q.requires_grad) + int(k.requires_grad)
                       + int(q.requires_grad or k.requires_grad) + int(v.requires_grad))
        # per-row ``[B]`` positions mask by data: their square counts as needed
        fixed = isinstance(q_offset, int)
        self.attention.append(AttentionCall(b, h, sq, k.shape[1], hd, causal and fixed,
                                            q_offset if fixed else 0,
                                            passes * self._weight[-1]))

    # ---- loops counted by their trip count ----
    def repeated(self, n: int, name: str, fn: Callable, inputs, trips: int):
        """``fn()`` counted ``n`` times: its ops now, and in a later
        backward the ops of the autograd nodes it made (each weighted ``n``
        by a pre-hook and back by a hook). ``inputs`` are the tensors it
        reads, whose nodes are not its own; ``trips`` is the loop's trip
        count for the record."""
        before = {x.grad_fn for x in _tensors(inputs) if x.grad_fn is not None}
        self._weight.append(self._weight[-1] * n)
        try:
            out = fn()
        finally:
            self._weight.pop()
        loop = self.loops.setdefault(name, {"trips": 0, "calls": 0})
        loop["trips"] += trips
        loop["calls"] += 1

        def enter(grads):
            self._weight.append(self._weight[-1] * n)

        def leave(grads_in, grads_out):
            self._weight.pop()

        for node in _own_nodes(_tensors(out), before):
            node.register_prehook(enter)
            node.register_hook(leave)
        return out

    # ---- the record ----
    def masked_flops(self) -> int:
        return sum(c.masked_flops() for c in self.attention)

    def record(self) -> Dict[str, Any]:
        masked = self.masked_flops()
        return {
            "flops_computed": self.flops,
            "attention_masked_flops": masked,
            "flops_needed": self.flops - masked,
            "op_bytes": self.op_bytes,
            "n_ops": self.ops,
            "attention_calls": len(self.attention),
            "trip_counted": {k: dict(v) for k, v in self.loops.items()},
        }


def _own_nodes(outs: List[torch.Tensor], before) -> List[Any]:
    """The autograd nodes between ``outs`` and the nodes in ``before``
    (parameters' ``AccumulateGrad`` excluded)."""
    seen, todo, own = set(), [x.grad_fn for x in outs if x.grad_fn is not None], []
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in before:
            continue
        seen.add(node)
        if type(node).__name__ == "AccumulateGrad":
            continue
        own.append(node)
        todo += [nxt for nxt, _ in node.next_functions]
    return own


def _scan_by_trips(counter: Counter, stepped):
    """``SLstm.scan`` counted by trip count: step 0 once (from the given
    state), step 1 — a step like every later one — ``S - 1`` times."""

    def scan(self, x_gates, st):
        s = x_gates.shape[1]
        if s < 3:
            return stepped(self, x_gates, st)
        st0 = self.cell(x_gates[:, 0], st)
        st1 = counter.repeated(s - 1, "models/ssm.py SLstm.scan",
                               lambda: self.cell(x_gates[:, 1], st0), (x_gates, *st0), s)
        return torch.stack([st0.h] + [st1.h] * (s - 1), 1), st1

    return scan


def _microbatches_by_trips(counter: Counter, stepped):
    """``train_step.microbatches`` counted by trip count: the first
    microbatch ``n`` times (each runs the same ops, its backward
    included)."""

    def microbatches(n, body, carry):
        if n < 2:
            return stepped(n, body, carry)
        return counter.repeated(n, "training/train_step.py microbatches",
                                lambda: body(0, carry), (), n)

    return microbatches


@contextlib.contextmanager
def _recording(counter: Counter):
    """The model's attention entries record each call into ``counter``
    (and with ``trip_count``, ``SLstm.scan`` and the train step's
    microbatches count by trip count) until exit."""
    naive, flash, scan = L._masked_naive, L.flash_attention, S.SLstm.scan
    micro = train_step.microbatches

    def recorded_naive(q, k, v, causal, q_offset):
        counter.attention_call(q, k, v, causal, q_offset)
        return naive(q, k, v, causal, q_offset)

    def recorded_flash(q, k, v, *, causal=True, sm_scale=None):
        counter.attention_call(q, k, v, causal, 0)
        return flash(q, k, v, causal=causal, sm_scale=sm_scale)

    L._masked_naive, L.flash_attention = recorded_naive, recorded_flash
    if counter.trip_count:
        S.SLstm.scan = _scan_by_trips(counter, scan)
        train_step.microbatches = _microbatches_by_trips(counter, micro)
    try:
        yield counter
    finally:
        L._masked_naive, L.flash_attention, S.SLstm.scan = naive, flash, scan
        train_step.microbatches = micro


def count(fn: Callable, *args, trip_count: bool = True, watched=(), **kwargs
          ) -> Tuple[Any, Counter]:
    """``fn(*args, **kwargs)`` under a fresh :class:`Counter`: (its result,
    the counter). Works on fake tensors (the dry run) and on real ones (a
    step on the card, counted the same way)."""
    counter = Counter(trip_count, watched)
    with _recording(counter), counter:
        out = fn(*args, **kwargs)
    return out, counter


# ---------------------------------------------------------------------------
# the roofline (the reference's hlo_analysis.roofline_terms, verbatim)
# ---------------------------------------------------------------------------

def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_wire_bytes: float,
    peak_flops: float,
    hbm_bw: float,
    ici_bw: float,
) -> Dict[str, float]:
    t_compute = flops_per_device / peak_flops
    t_memory = hbm_bytes_per_device / hbm_bw
    t_collective = collective_wire_bytes / ici_bw
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
    }
    dominant = max(terms, key=terms.get)
    out = dict(terms)
    out["dominant"] = dominant.replace("t_", "").replace("_s", "")
    bound = max(t_compute, t_memory, t_collective)
    out["roofline_step_s"] = bound
    out["compute_fraction"] = t_compute / bound if bound > 0 else 0.0
    return out


def _finish(rec: Dict[str, Any], counter: Counter, hbm_bytes: int, dtype_name: str) -> None:
    """The counts, the bound's bytes and the roofline into ``rec``."""
    counts = counter.record()
    rec.update(counts)
    rec["flops_per_device"] = counts["flops_needed"]
    rec["hbm_bytes_per_device"] = hbm_bytes
    rec["collective_wire_bytes_per_device"] = 0  # one card
    peak = mesh.PEAK_FLOPS[dtype_name]
    rec["peak"] = {"flops_per_s": peak, "dtype": dtype_name, "hbm_bytes_per_s": mesh.HBM_BW,
                   "source": PEAK_SOURCE}
    rec["roofline"] = roofline_terms(rec["flops_per_device"], hbm_bytes, 0, peak,
                                     mesh.HBM_BW, mesh.NVLINK_BW)


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------

def _opt_specs(state: OptState, pspecs: List[sharding.P], mesh_shape) -> OptState:
    """The reference dry run's optimizer-state placement: AdamW's moments
    as their parameters, any other state and the step replicated."""
    inner = state.inner
    if isinstance(inner, _AdamMoments):
        inner = _AdamMoments(list(pspecs), list(pspecs))
    elif inner is not None:
        inner = sharding.replicated(mesh_shape, inner)
    return OptState(sharding.P(), inner)


def mesh_name(mesh_shape: Dict[str, int]) -> str:
    return "x".join(str(v) for v in mesh_shape.values())


def lower_cell(
    arch: str,
    shape_name: Union[str, ShapeSpec],
    accum_override: Optional[int] = None,
    config_overrides: Optional[Dict[str, Any]] = None,
    mesh_shape: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Count one (arch x shape) cell on fake tensors; return its record.
    ``shape_name`` is a key of ``SHAPE_SETS`` or a ``ShapeSpec`` of its own;
    ``mesh_shape`` (``launch/mesh.py`` ``parse_mesh``) adds the arguments'
    bytes per card on that mesh."""
    t_start = time.time()
    cfg = get_arch(arch)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    shape = SHAPE_SETS[shape_name] if isinstance(shape_name, str) else shape_name
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "mesh": MESH,
        "n_devices": 1,
        "kind": shape.kind,
    }
    ok, reason = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    if mesh_shape is not None:
        rec.update(mesh=mesh_name(mesh_shape), mesh_axes=dict(mesh_shape),
                   n_devices=sharding._prod(mesh_shape.values()))
    with fake_mode():
        model = fake_model(cfg)
        n_params = model.n_params()
        rec["n_params"] = n_params
        params = _bytes(list(model.parameters()))
        # the arguments: (tree, its specs on the mesh) a part
        if mesh_shape is not None:
            leaves = reference_leaves(model)
            pspecs = sharding.params_specs(cfg, mesh_shape, leaves)
            parts = [([leaf.tensors[0].new_empty(leaf.shape) for leaf in leaves], pspecs)]
        if shape.kind == "train":
            accum = accum_override or train_accum_steps(cfg, n_params, shape)
            rec["accum_steps"] = accum
            opt = train_step.make_optimizer(cfg.optimizer, 1e-4)
            step = train_step.make_train_step(model, opt,
                                              train_step.TrainStepConfig(accum_steps=accum))
            state = train_step.init_opt_state(model, opt)
            batch = batch_specs(cfg, shape)
            args = params + _bytes(state) + _bytes(batch)
            if mesh_shape is not None:
                parts += [(state, _opt_specs(state, pspecs, mesh_shape)),
                          (batch, sharding.batch_shardings(
                              mesh_shape, batch, shape.batch,
                              seq_over_model=cfg.sharding_mode == "fsdp_sp"))]
            _, counter = count(step, state, batch)
            # parameters and optimizer state read and written, the batch read
            hbm = 2 * (params + _bytes(state)) + _bytes(batch)
        elif shape.kind == "prefill":
            batch = batch_specs(cfg, shape)
            args = params + _bytes(batch)
            if mesh_shape is not None:
                parts.append((batch, sharding.batch_shardings(mesh_shape, batch, shape.batch)))
            (logits, cache), counter = count(
                model.prefill, batch["tokens"], image_embeds=batch.get("image_embeds"),
                encoder_frames=batch.get("encoder_frames"))
            hbm = args + _bytes(cache) + _bytes(logits)  # the new cache written
        else:
            tokens, cache, pos = decode_specs(cfg, model, shape)
            args = params + _bytes(tokens) + _bytes(cache)
            if mesh_shape is not None:
                parts += [(tokens, sharding.batch_shardings(mesh_shape, tokens, shape.batch)),
                          (cache, sharding.cache_shardings(cfg, mesh_shape, cache,
                                                           shape.batch, shape.seq))]
            (logits, _), counter = count(model.decode_step, tokens, cache, pos, watched=cache)
            # the whole cache read (pos = S - 1), and what the step writes into it
            rec["cache_write_bytes"] = counter.watched_writes
            hbm = args + counter.watched_writes + _bytes(logits)
        if mesh_shape is not None:
            per_card = sum(sharding.sharded_bytes(tree, specs, mesh_shape)
                           for tree, specs in parts)
    if mesh_shape is None:
        rec["args_bytes_per_device"] = args
        rec["fits_one_card"] = args <= mesh.HBM_BYTES
    else:
        rec["args_bytes_per_device"] = per_card
        rec["args_bytes_one_card"] = args
        rec["fits_one_card"] = args <= mesh.HBM_BYTES
        rec["fits_per_card"] = per_card <= mesh.HBM_BYTES
    _finish(rec, counter, hbm, cfg.dtype_name)
    if mesh_shape is not None:
        rec["collective_note"] = ("FLOPs, bytes and the roofline are one card's; the "
                                  "step's collectives are not counted (ROADMAP)")

    # useful-FLOPs ratio: MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE),
    # over the FLOPs the program computes (the reference's HLO count)
    rec["model_flops_ratio"] = None
    if shape.kind == "train":
        n_active = _active_params(cfg, n_params)
        model_flops = 6.0 * n_active * (shape.batch * shape.seq)
        rec["model_flops"] = model_flops
        rec["n_active_params"] = n_active
        if rec["flops_computed"] > 0:
            rec["model_flops_ratio"] = model_flops / rec["flops_computed"]
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t_start, 2)
    return rec


def _active_params(cfg, n_params: int) -> float:
    """Active params per token (MoE: the rest + top_k/E of the routed
    experts). The routed experts are the ``MoE`` modules' own ``w_gate``,
    ``w_up`` and ``w_down``; the reference's path test also takes the
    shared experts' SwiGLU (its ``moe/shared/w_*``) as routed, and so
    counts them at top_k/E (ROADMAP Queue 3)."""
    if cfg.n_experts:
        model = build_model(cfg, "meta")
        routed = sum(m.w_gate.numel() + m.w_up.numel() + m.w_down.numel()
                     for m in model.modules() if isinstance(m, MoE))
        return n_params - routed + routed * cfg.top_k / cfg.n_experts
    return float(n_params)


# ---------------------------------------------------------------------------
# the paper's own cell: the A2C update of the RL power manager
# ---------------------------------------------------------------------------

def lower_spars_rl(n_envs: int = 4096, device=None) -> Dict[str, Any]:
    """One A2C update of the reference's setting (64 nodes, 128 jobs, EASY
    with RL commands, decision interval 600, 8 steps), counted by
    :class:`Counter`. The env reads the host every step, so fake tensors
    cannot run it: the update runs for real on ``device`` (cuda unless the
    caller passes ``"cpu"``; it raises without a card)."""
    from repro_torch.core import engine
    from repro_torch.core.rl.a2c import A2CConfig, TrainState, make_update_fn
    from repro_torch.core.rl.env import (
        EnvConfig, batched_reset, make_env_grid, stack_sims,
    )
    from repro_torch.core.rl.networks import policy_init
    from repro_torch.core.types import BasePolicy, EngineConfig, PSMVariant
    from repro_torch.device import resolve_device
    from repro_torch.workloads.generator import GeneratorConfig, generate_workload
    from repro_torch.workloads.platform import PlatformSpec

    t0 = time.time()
    dev = resolve_device(device)
    rec: Dict[str, Any] = {
        "arch": "spars-rl",
        "shape": f"a2c_envs{n_envs}",
        "mesh": MESH,
        "n_devices": 1,
        "kind": "rl_train",
        "device": str(dev),
    }
    plat = PlatformSpec(nb_nodes=64)
    wl = generate_workload(GeneratorConfig(n_jobs=128, nb_res=64, seed=0))
    ecfg = EnvConfig(
        engine=EngineConfig(psm=PSMVariant.RL, base=BasePolicy.EASY, rl_decision_interval=600),
        max_steps=256,
    )
    acfg = A2CConfig(n_envs=n_envs, n_steps=8)
    const = engine.make_const(plat, ecfg.engine, device=dev)
    # the one initial state broadcast over the batch, as the reference's
    sims0 = stack_sims([engine.init_state(plat, wl, ecfg.engine, device=dev)] * n_envs)
    key = torch.Generator(device=dev).manual_seed(acfg.seed)
    params = policy_init(key, ecfg.obs_size, ecfg.n_actions, acfg.hidden)
    update, opt = make_update_fn(ecfg, const, sims0, acfg)
    opt_state = opt.init(params.parameters())
    grid = make_env_grid(const, n_envs)
    param_list = list(params.parameters())
    args = _bytes(param_list) + _bytes(opt_state) + _bytes(sims0)
    rec["n_params"] = sum(p.numel() for p in param_list)
    rec["args_bytes_per_device"] = args
    rec["fits_one_card"] = args <= mesh.HBM_BYTES

    def full_update():
        env_states, obs = batched_reset(ecfg, grid, sims0)
        ts, metrics = update(TrainState(params, opt_state, env_states, obs, key))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return ts, metrics

    t_run = time.time()
    (ts, metrics), counter = count(full_update)
    rec["update_s"] = round(time.time() - t_run, 3)
    rec["metrics"] = {k: float(v) for k, v in metrics.items()}
    # parameters, optimizer state and env states read, and written updated
    hbm = 2 * (_bytes(param_list) + _bytes(ts.opt_state) + _bytes(ts.env_states.sim))
    _finish(rec, counter, hbm, "float32")
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _line(tag: str, rec: Dict[str, Any]) -> str:
    status = rec.get("status")
    extra = ""
    if status == "ok":
        rf = rec.get("roofline", {})
        extra = (
            f" count={rec.get('total_s')}s"
            f" dominant={rf.get('dominant')}"
            f" cf={rf.get('compute_fraction', 0):.3f}"
        )
    elif status == "error":
        extra = " " + rec["error"].strip().splitlines()[-1][:120]
    return f"[{status:7s}] {tag}{extra}"


def table(results: List[Dict[str, Any]]) -> str:
    """The ``ok`` records as a markdown table: the needed and computed
    FLOPs, the bound's bytes and the eager program's, whether the
    arguments fit one card (and, on a mesh, each card of it), and the
    roofline against the peaks."""
    on_mesh = any("fits_per_card" in r for r in results)
    head = ("| cell | FLOPs needed | FLOPs computed | hbm_bytes | op_bytes | args_bytes | "
            "fits one card | " + ("args_bytes per card | fits per card | " if on_mesh else "")
            + "dominant | roofline s |")
    rows = [head, "|" + "---|" * (11 if on_mesh else 9)]
    for r in results:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        rf = r["roofline"]
        one = r.get("args_bytes_one_card", r["args_bytes_per_device"])
        per_card = (f"{r['args_bytes_per_device']:.4g} | "
                    f"{'yes' if r['fits_per_card'] else 'no'} | ") if on_mesh else ""
        rows.append(
            f"| {r['arch']} {r['shape']} | {r['flops_per_device']:.4g} | "
            f"{r['flops_computed']:.4g} | {r['hbm_bytes_per_device']:.4g} | "
            f"{r['op_bytes']:.4g} | {one:.4g} | "
            f"{'yes' if r['fits_one_card'] else 'no'} | {per_card}{rf['dominant']} | "
            f"{rf['roofline_step_s']:.4g} |")
    return "\n".join(rows)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="out/dryrun_torch")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--spars-rl", action="store_true", help="also run the RL cell")
    ap.add_argument("--device", default=None,
                    help="the RL cell's device (default cuda; the LM cells take none)")
    ap.add_argument("--mesh", default="1",
                    help="1 (one card, the default), DxM, PxDxM, or the reference's "
                         "single (16x16) or multi (2x16x16): per-card bytes on that mesh")
    args = ap.parse_args(argv)
    mesh_shape = None if args.mesh == "1" else mesh.parse_mesh(args.mesh)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPE_SETS) if args.shape == "all" else args.shape.split(",")

    results = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}" + ("" if mesh_shape is None
                                        else f"__{mesh_name(mesh_shape)}")
            try:
                rec = lower_cell(arch, shape, accum_override=args.accum, mesh_shape=mesh_shape)
            except Exception:
                rec = {"arch": arch, "shape": shape, "mesh": MESH, "status": "error",
                       "error": traceback.format_exc()}
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
            print(_line(tag, rec), flush=True)
            results.append(rec)

    if args.spars_rl:
        tag = "spars-rl"
        try:
            rec = lower_spars_rl(device=args.device)
        except Exception:
            rec = {"arch": "spars-rl", "mesh": MESH, "status": "error",
                   "error": traceback.format_exc()}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
        print(_line(tag, rec), flush=True)
        results.append(rec)

    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    n_err = sum(1 for r in results if r.get("status") == "error")
    print(f"\n{table(results)}\n\nroofline against the {PEAK_SOURCE} peaks")
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped(documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
