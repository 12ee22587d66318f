#!/usr/bin/env python3
"""Drive the PyTorch port of SPARS on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):

1. device: the card and its power limit (``nvidia-smi``); no CUDA, no run;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with the build seconds and
   the ptxas register, shared-memory and spill lines of every kernel
   variant (each event kernel, the 16 SIMT and 2 wgmma flash kernels, the
   6 ``ssd_scan`` pass kernels);
3. kernels: each event kernel against its plain PyTorch version on the
   card, bit for bit, at the engine's shapes and more (rows that start off a
   16-byte boundary, arrays at different alignments, G = 64 and
   ``MAX_GROUPS``, dead lanes, one table a row: ``[E, 5]`` watts and ``[E,
   N]`` group ids), with the allocator's free memory poisoned so an
   unwritten output cannot pass; the ledger and occupancy kernels timed at
   E = 1, 8 and 64, their cluster size at each timed shape, their ptxas lines, and the device time of a
   1-element fill (the card's practical launch floor) beside theirs, and
   each wrapper's host time in turns with the fill's (fill, wrapper,
   wrapper, fill);
   ``flash_attention``
   against its plain version at the serve path's prefill shape in bf16 and
   f32 and at MQA, Sq > Sk, a ragged KV tail, non-causal Sk > Sq, a ragged
   Sq and head dims 64 and 16 (f32 atol and rtol 2e-5, bf16 3e-2), each
   call on the variant that ``flash_attention.variant`` names (bf16 hd 64
   and 128 on the wgmma kernel, the rest on the SIMT kernel); the device
   time of each (``torch.profiler``: the kernels' own durations), the host
   time per call and the card's bound for the same work; for flash
   attention at the prefill shape in bf16, in turns in one call, the SIMT
   kernel, the wgmma kernel, the wgmma kernel and the SIMT kernel on the
   same inputs, then the plain version and
   ``scaled_dot_product_attention``;
4. labels: the paper's seven schedulers on a 16-node homogeneous and a
   16-node mixed platform on the card, and every DVFS and Forecast label
   (``scheduler_labels(include_dvfs=True, include_forecast=True)`` and
   EASY DVFS+Forecast) on the 16-node DVFS platform; then, on the grouped
   path, the seven on a 280-node Curie platform replaying a Curie-class SWF
   trace, the seven with ``+Forecast`` (horizon 1800 s) there and with
   ``+DVFS`` on the 280-node DVFS platform, and ``node_order="pack"``,
   ``allocation="partition"`` and ``merge_bursts`` under EASY PSUS and FCFS
   PSAS — each held against the port's sequential oracle (schedule exact,
   energy and the DVFS mode energy to rel 1e-5), the grouped runs with one
   occupancy-kernel launch a batch;
5. main path, dense: one simulation at CEA-Curie scale (11 200 nodes, the
   ``cea_curie`` workload, 1000 jobs, EASY PSUS, timeout 1800 s) — the
   ledger kernel must have launched once per event batch, and the schedule
   must equal the oracle's; a second run is timed;
6. main path, grouped: the first 1000 jobs of the synthesized Curie SWF
   trace replayed on the 3-group 11 200-node Curie platform, EASY PSUS,
   timeout 1800 s, grouped tables — the occupancy kernel must have launched
   once per event batch, and the schedule must equal the oracle's and a
   dense port run's of the same inputs; a second run is timed;
7. command line: ``python -m repro_torch.launch.sim`` on the card writes
   its outputs;
8. LM serve: ``repro_torch.launch.serve --per-slot-positions`` serves the
   full-width internlm2-1.8b in bf16 (16 requests of 1024 tokens, 4 slots,
   32 new tokens, cache 1280) — the flash kernel must have launched once per
   layer per request (384), every launch on the wgmma variant; two refilled
   requests are held against their own single-sequence prefill + decode
   (teacher-forced: each served token within ``REFILL_TOL`` of the greedy
   maximum), and so are the tokens that the loop serves without the flag,
   on the reference's shared counter, which must fail that check; one
   prefill (flash kernel against matmuls) and one decode step at an int and
   at ``[4]`` positions are profiled, and the two steps timed in turns;
   then, in f32, two 1024-token prompts
   go through ``prefill`` by the kernel route and by the plain route, whose
   last-position logits must agree;
9. xLSTM serve: the same loop and flags serve the full-width xlstm-350m in
   bf16 — ``ssd_scan`` must have been called twice per ``xlstm_pair`` per
   request (384, each call three launches) and no other kernel; one
   ``xlstm_pair`` block at S 1024
   is timed, its mLSTM and its sLSTM are profiled, and so is one decode
   step; then, in f32,
   two 1024-token prompts go through ``prefill`` by the kernel route and
   by the plain route, whose last-position logits must agree;
10. power rules at Curie scale, grouped: EASY PSUS+Forecast (horizon
   1800 s) on phase 6's inputs, and EASY PSUS+DVFS on the DVFS platform at
   11 200 nodes with phase 5's workload (timeout 900 s, ``node_order=
   "cheap"``, ``terminate_overrun``) — the occupancy kernel must have
   launched once a batch and the schedule must equal the same run's on the
   plain per-node route (energy and mode ledgers to rel 1e-5); the Forecast
   run at horizon 0 must give phase 6's schedule and energy bit for bit;
   the first 100 batches of each and of phase 6's configuration are
   profiled (device ops a batch, device busy share);
11. the batched sweep at Curie scale (``repro_torch.core.sweep``):
   ``benchmarks/bench_scale.py``'s grid, ``("EASY PSUS", "FCFS PSAS+IPM")``
   x timeouts ``300 + 300 i``, on phase 5's inputs at E = 1 (EASY PSUS
   1800 alone), 8 and 64, and on phase 6's inputs, grouped, at E = 8
   (timeouts 600-2400) — one event-kernel launch per loop iteration for the
   grid (``event_fuse_ledger``, dense; ``event_fuse_occ``, grouped), at most
   two host syncs an iteration; the E = 1 sweep and the E = 64 row EASY
   PSUS 1800 equal phase 5's run bit for bit, each E = 8 row its E = 64
   row, the row FCFS PSAS+IPM 600 a single run of it, and the grouped row
   EASY PSUS 1800 phase 6's run; per grid the wall and the wall a scenario,
   iterations, µs and host syncs an iteration, the first 100 iterations
   profiled (device ops an iteration, busy share) and peak device memory.
   No sweep row runs the oracle on the card: the CPU tests hold rows
   against it and against the JAX sweep.

Phase 3 also holds ``ssd_scan`` against its plain version at the xLSTM
serve shapes (dv 512 and the normaliser's dv 1) in the mLSTM's mixed
dtypes and in f32, at a ragged S, from a non-zero state and at the
reference's kernel-test shapes (f32: 1e-4 of max |y|; bf16 y: one bf16 ulp
of the element plus 1e-5 of max |y|), checks that a second run is bit for
bit the first and that the built library's launch plan is
``ssd_scan.launch_plan``'s, and times its three passes.

Then it prints the kernels' JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It imports
the port (``src/repro_torch``), torch and numpy — nothing of JAX and nothing
of the JAX reference package.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# the event kernels' work is int32 compares and adds outside the tensor
# cores; the closest published scalar peak is the 67 TFLOP/s of float32
SCALAR_OPS_PER_S = 67e12
# H100 SXM dense bf16 tensor-core peak: flash attention's bound
TENSOR_BF16_FLOPS_PER_S = 989e12
ARCH = "internlm2-1.8b"
# (B, Sq, Sk, H, KH, hd, causal): the serve path's prefill shape first
FLASH_MAIN = (1, 1024, 1024, 16, 8, 128, True)
FLASH_SHAPES = [
    FLASH_MAIN,
    (1, 256, 256, 8, 1, 128, True),    # MQA
    (1, 384, 256, 2, 2, 128, True),    # Sq > Sk
    (1, 128, 320, 4, 2, 64, True),     # KV tail not a tile multiple
    (2, 128, 384, 4, 4, 64, False),    # non-causal, Sk > Sq
    (1, 100, 100, 2, 2, 64, True),     # ragged Sq
    (1, 64, 64, 4, 2, 16, True),       # hd 16
    (2, 256, 256, 4, 2, 64, True),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # atol and rtol, as the tests
SERVE_ARGS = ["--arch", ARCH, "--requests", "16", "--slots", "4",
              "--prompt-len", "1024", "--max-new", "32", "--cache-len", "1280",
              "--device", "cuda", "--per-slot-positions"]
XARCH = "xlstm-350m"
XSERVE_ARGS = ["--arch", XARCH] + SERVE_ARGS[2:]
# requests the serve loop prefills into a freed slot: the first and the last
# refill of phase 8's 16 requests on 4 slots
REFILLED = (4, 15)
# a served token of a refilled request against its own single-sequence
# decode (bf16, batch 4 against batch 1: other matmul tilings and the whole
# cache's masked keys against the prefix): its logit within this share of the
# largest |logit| below the greedy maximum. Phase 8 also holds the tokens the
# shared counter serves to the same check, which must fail it
REFILL_TOL = 2.0 ** -4
# (B, S, H, dk, dv, chunk): the xLSTM serve prefill's two GLA launches (the
# values and the normaliser's dv 1)
SSD_MAIN = (1, 1024, 4, 512, 512, 128)
SSD_NORM = (1, 1024, 4, 512, 1, 128)
# (label, shape, dtypes of q, k, v, non-zero h0): the serve shapes in the
# mLSTM's dtypes (q bf16, k f32, v bf16) and in f32, a ragged S, a
# continued prefill, and the reference's kernel-test shapes (SSD_CASES of
# tests/test_kernels.py) in f32 and bf16
_MIXED, _F32, _BF16 = ("bfloat16", "float32", "bfloat16"), ("float32",) * 3, ("bfloat16",) * 3
SSD_CHECKS = [
    ("serve values", SSD_MAIN, _MIXED, False),
    ("serve normaliser", SSD_NORM, _MIXED, False),
    ("serve values f32", SSD_MAIN, _F32, False),
    ("serve normaliser f32", SSD_NORM, _F32, False),
    ("ragged S 1000", (1, 1000, 4, 512, 512, 128), _MIXED, False),
    ("ragged S 1000 normaliser", (1, 1000, 4, 512, 1, 128), _MIXED, False),
    ("non-zero h0", SSD_MAIN, _MIXED, True),
    ("non-zero h0 f32", (2, 256, 2, 64, 64, 64), _F32, True),
] + [
    (f"SSD_CASES {dn}", shape, dts, False)
    for shape in ((1, 128, 1, 32, 32, 32), (2, 256, 2, 64, 64, 64),
                  (1, 256, 4, 32, 128, 128), (2, 128, 2, 128, 64, 128))
    for dn, dts in (("f32", _F32), ("bf16", _BF16))
]
# f32 sums in another order over up to 512 x 128 terms a chunk: 1e-4 of the
# output's largest magnitude; a bf16 y adds one bf16 ulp of the element
# (2**-7 of its magnitude) for the one rounding of either side
SSD_F32_TOL = 1e-4
# the ssd_scan kernel instantiations: the chunk and output passes at tile
# widths 64 and 128, the state pass and the narrow output pass
SSD_INSTANCES = sorted(["ssd_scan_chunk_kernel<64>", "ssd_scan_chunk_kernel<128>",
                        "ssd_scan_state_kernel", "ssd_scan_out_kernel<64>",
                        "ssd_scan_out_kernel<128>", "ssd_scan_out_narrow_kernel"])
BF16_ULP = 2.0 ** -7
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
# f32 kernel route against plain route, last-position logits of the full
# model: the two differ only in f32 summation order, which 24 layers
# amplify; atol = 1e-3 of the logits' largest magnitude
LOGITS_REL_TOL = 1e-3
INF_TIME = 2**30
# rows of 11 199 and 11 201 nodes start off a 16-byte boundary from row 1 on
EXACT_SHAPES = [(1, 16), (1, 131), (13, 131), (1, 11200), (64, 11200),
                (3, 11199), (2, 11201)]
ZERO_SHAPES = [(0, 16), (4, 0), (0, 0)]
MAIN_SHAPE = (1, 11200)  # what engine.event_horizon hands the kernels
# (E, N, G) for the occupancy kernel; the main path's is (1, 11200, 3)
OCC_SHAPES = [(1, 16, 1), (13, 131, 3), (1, 11200, 3), (64, 11200, 3),
              (1, 11200, 64), (3, 11199, 3), (2, 11201, 3), (2, 11201, 64),
              (1, 11200, 1536), (3, 5003, 1536)]  # 1536: event_fuse.MAX_GROUPS
OCC_ZERO_SHAPES = [(0, 16, 3), (4, 0, 3), (0, 0, 3)]
# shapes also run with dead lanes: states 7 and group ids -1 and G, which
# the occupancy counts must skip
OCC_DEAD_SHAPES = [(13, 131, 3), (1, 11200, 3), (2, 11201, 3)]
# (E, N, G) with state, until and the group ids starting 1, 3 and 2 int32s
# past a 16-byte boundary: each array's quads at another alignment
SHIFTED = (2, 11201, 3)
SHIFTS = (1, 3, 2)
OCC_MAIN = (1, 11200, 3)
# held with one table a row (a sweep over platforms): [E, 5] watts for the
# ledger at (E, N), [E, N] group ids for the occupancy kernel at (E, N, G)
ROW_TABLE_SHAPES = [(13, 131), (8, 11200), (64, 11200), (3, 11199)]
ROW_OCC_SHAPES = [(13, 131, 3), (8, 11200, 3), (64, 11200, 3), (2, 11201, 64)]
LABELS = [
    f"{base} {psm}"
    for base in ("FCFS", "EASY")
    for psm in ("PSUS", "PSAS", "PSAS+IPM")
] + ["EASY AlwaysOn"]
GROUPED_OPTIONS = [
    ({"node_order": "pack"}, label) for label in ("EASY PSUS", "FCFS PSAS")
] + [
    ({"node_order": "cheap", "allocation": "partition"}, label)
    for label in ("EASY PSUS", "FCFS PSAS")
] + [
    ({"node_order": "cheap", "merge_bursts": True}, label)
    for label in ("EASY PSUS", "FCFS PSAS")
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def kernel_inputs(torch, np, e, n, seed=0, per_row=False):
    """States 0..4 with ``until`` straddling ``t``, made from a seed:
    (state, until, t, power) on the card; ``power`` is [5], or with
    ``per_row`` [E, 5] integer watts, one table a row."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    power = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
    if per_row:
        power = rng.integers(1, 400, (e, 5)).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (state, until, t, power)]


def occ_inputs(torch, np, e, n, g, seed=0, dead=False, per_row=False):
    """(state, until, t, group_id, G) on the card: the kernel inputs above
    with sorted group ids (contiguous groups, as platforms lay them out),
    [N], or with ``per_row`` [E, N], one table a row. With ``dead``, every
    fifth state is 7 and the first and last group ids are -1 and G: nodes
    that count in no cell."""
    state, until, t, _ = kernel_inputs(torch, np, e, n, seed)
    rng = np.random.default_rng(seed + 7 * n + g)
    gid = np.sort(rng.integers(0, g, (e, n) if per_row else n), axis=-1).astype(np.int32)
    if dead:
        state[:, ::5] = 7
        gid[0], gid[-1] = -1, g
    return [state, until, t, torch.from_numpy(gid).cuda(), g]


def time_ms(torch, fn, args, reps=5, iters=200, warmup=20):
    """Median over ``reps`` of the mean time per call of ``iters`` calls
    back to back between two CUDA events, after a warm-up. A call much
    shorter than its launch measures the host side of the call."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call)


def device_ms(torch, fn, args, calls=200, warmup=20):
    """(device ms per call, device ops per call, {op name: device ms per
    call}, share recorded): the durations of the device operations that
    ``calls`` calls launch, read from ``torch.profiler``, after a warm-up.
    Gaps between them and the host's time are not counted. The profiler may
    lose a few records of a long capture, so each op name is timed by its
    mean recorded duration times its launches per call (its recorded count
    over ``calls``, rounded); the share of the expected records that were
    seen is returned and must be at least a half."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time_total)
    check(len(by_name) > 0, f"the profiler saw no device operation of {fn.__name__}")
    per_call = {k: max(1, round(len(v) / calls)) for k, v in by_name.items()}
    n_ops = sum(per_call.values())
    seen = sum(len(v) for v in by_name.values()) / (n_ops * calls)
    check(seen >= 0.5, f"the profiler recorded {seen:.2f} of the device "
          f"operations of {fn.__name__}")
    each = {k: statistics.fmean(v) * per_call[k] / 1e3 for k, v in sorted(by_name.items())}
    return sum(each.values()), n_ops, each, seen


def bound_ms(bytes_moved: float, ops: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the int32 operations over the scalar peak."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ops / SCALAR_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def ledger_bound(e: int, n: int):
    """event_fuse_ledger at [E, N]: read state and until (4 + 4 bytes a
    node), t and the 5 watts once, write the [E, 8] sums and [E] next once;
    13 int32 operations a node (5 compares, 5 adds, and 2 compares and a
    min for the masked min)."""
    return bound_ms(8 * e * n + 4 * e + 4 * 5 + 4 * 8 * e + 4 * e, 13 * e * n)


def draw_bound(e: int, n: int):
    """event_fuse at [E, N]: as the ledger, with an [E] draw written in
    place of the [E, 8] sums."""
    return bound_ms(8 * e * n + 4 * e + 4 * 5 + 4 * e + 4 * e, 13 * e * n)


def occ_bound(e: int, n: int, g: int):
    """event_fuse_occ at [E, N] and G groups: read state, until (per row)
    and the group ids (once), t once, write the [E, G, 8] counts and [E]
    next once; 10 int32 operations a node (4 range compares, the cell
    index's multiply-add, one count, and 2 compares and a min for the
    masked min)."""
    return bound_ms(8 * e * n + 4 * n + 4 * e + 4 * 8 * g * e + 4 * e,
                    10 * e * n)


def ptxas_report(log: str, kernels):
    """{kernel: [lines]}: the registers, shared-memory and spill lines that
    ``nvcc -Xptxas=-v`` printed for each kernel's entry function."""
    out, cur = {k: [] for k in kernels}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            cur = next((k for k in kernels if f"{k}_kernel" in line), None)
        elif cur and any(w in line for w in ("registers", "spill", "smem")):
            out[cur].append(line.strip())
    return out


def instance_ptxas(log: str, label):
    """{label: [lines]}: the ptxas registers, shared-memory and spill lines
    of each kernel instantiation whose mangled name ``label(name)`` maps to
    a label (None: not reported)."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            cur = label(line)
            if cur:
                out.setdefault(cur, [])
        elif cur and any(w in line for w in ("registers", "spill", "smem")):
            out[cur].append(line.strip())
    return out


def flash_label(line: str):
    """"simt <dtype> hd<=<n>" (dtype x columns per lane) or "wgmma bf16 hd
    <n>" for a flash kernel's mangled name."""
    m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d)E", line)
    if m:
        return f"simt {'f32' if m.group(1) == 'f' else 'bf16'} hd<={32 * int(m.group(2))}"
    m = re.search(r"flash_attention_wgmma_kernelILi(\d+)E", line)
    return f"wgmma bf16 hd {m.group(1)}" if m else None


def ssd_label(line: str):
    """"ssd_scan_<pass>_kernel[<BN>]" for an ``ssd_scan`` kernel's mangled name."""
    m = re.search(r"\d(ssd_scan_[a-z_]+?_kernel)(?:ILi(\d+)E)?", line)
    return (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")) if m else None


def kernel_base(name: str) -> str:
    """The function name in a profiler's kernel name: the first identifier
    right before a "<" or "(" ("void (anonymous namespace)::f<128>(...)" ->
    "f"), or the whole name."""
    m = re.search(r"([A-Za-z_]\w*)[<(]", name)
    return m.group(1) if m else name


def flash_bound(b, sq, sk, h, kh, hd, causal, itemsize):
    """(ms, "bytes" or "operations") for flash attention: q, k, v read once
    and o written once, against the products of the pairs the mask keeps
    (2 flops a multiply-add, for QK^T and for P.V) at the bf16 tensor-core
    peak."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * hd * pairs * h * b
    bytes_moved = itemsize * (2 * b * sq * h * hd + 2 * b * sk * kh * hd)
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = flops / TENSOR_BF16_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def ssd_bound(b, s, h, dk, dv, chunk, itemsizes, h0):
    """(ms, "bytes" or "operations") for one GLA scan: q, k, v, g (and h0)
    read once, y and h_final written once, against the f32 products the
    recurrence needs in its chunk form — per chunk of L steps the causal
    L(L+1)/2 scores (dk each) and their products with v (dv each), and
    q . h_in and the state update (dk dv each per step), 2 flops a
    multiply-add — at the f32 peak (the kernel computes in f32)."""
    flops = 0
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        pairs = n * (n + 1) // 2
        flops += 2 * (pairs * dk + pairs * dv + 2 * n * dk * dv)
    flops *= b * h
    iq, ik, iv = itemsizes
    bytes_moved = (b * s * h * (dk * (iq + ik) + dv * iv + 4 + dv * iv)
                   + 4 * b * h * dk * dv * (2 if h0 else 1))
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def ssd_inputs(torch, np, shape, dtypes, h0=False, seed=0):
    """q, k, v, g, h0 (or None) on the card, as the mLSTM makes them: q
    scaled by 1/sqrt(dk), k by an input gate in (0, 1), v standard normal,
    g = log_sigmoid of a forget pre-activation near 3 (the init's bias), a
    non-zero h0 standard normal."""
    b, s, h, dk, dv, _ = shape
    rng = np.random.default_rng(seed + s + 7 * dk + 31 * dv + 101 * h)
    q = rng.normal(size=(b, s, h, dk)) / np.sqrt(dk)
    k = rng.normal(size=(b, s, h, dk)) / (1 + np.exp(-rng.normal(size=(b, s, h, 1))))
    v = rng.normal(size=(b, s, h, dv))
    g = -np.log1p(np.exp(-(3 + rng.normal(size=(b, s, h)))))
    st = rng.normal(size=(b, h, dk, dv)) if h0 else None

    def dev(x, dname):
        return torch.from_numpy(x.astype(np.float32)).to("cuda", getattr(torch, dname))

    return [dev(q, dtypes[0]), dev(k, dtypes[1]), dev(v, dtypes[2]), dev(g, "float32"),
            None if st is None else dev(st, "float32")]


def kernel_kind(name: str) -> str:
    """ssd, matmul or other, for a device kernel's name."""
    if kernel_base(name).startswith("ssd_scan"):
        return "ssd"
    return "matmul" if kernel_class(name) == "matmul" else "other"


def profile_split(torch, fn, calls):
    """Profile ``calls`` calls of ``fn`` (after one warm-up): ({kind: device
    ms per call}, top-level host ops per call, device ops per call, share
    of the device records seen). As in :func:`device_ms`, each op name is
    timed by its mean recorded duration times its launches per call (its
    recorded count over ``calls``, rounded), because the profiler may lose
    records of a long capture; the share seen must be at least a half."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    check(len(by_name) > 0, "the profiler saw no device operation")
    per_call = {k: max(1, round(len(v) / calls)) for k, v in by_name.items()}
    n_ops = sum(per_call.values())
    seen = sum(len(v) for v in by_name.values()) / (n_ops * calls)
    check(seen >= 0.5, f"the profiler recorded {seen:.2f} of the device operations")
    by_kind = {"ssd": 0.0, "matmul": 0.0, "other": 0.0}
    for k, v in by_name.items():
        by_kind[kernel_kind(k)] += statistics.fmean(v) * per_call[k]
    ssd_per_call = sum(n for k, n in per_call.items() if kernel_kind(k) == "ssd")
    return by_kind, top_level_ops(torch, prof) / calls, n_ops, ssd_per_call, seen


def flash_inputs(torch, np, shape, dtype, seed=0):
    """q, k, v on the card: standard normal draws from a seed."""
    b, sq, sk, h, kh, hd, _ = shape
    rng = np.random.default_rng(seed + sq + 7 * sk + 31 * hd)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
            for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))]


def host_ms(torch, fn, args, calls=100, warmup=10):
    """Host ms per call: the time to enqueue ``calls`` calls back to back,
    read before the synchronisation that ends them."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def top_level_ops(torch, prof) -> int:
    """The host operations a profiled region dispatched: CPU events with
    no parent (each a PyTorch call from Python)."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU and e.cpu_parent is None)


def kernel_class(name: str) -> str:
    """flash, matmul or other, for a device kernel's name."""
    if kernel_base(name) in ("flash_attention_kernel", "flash_attention_wgmma_kernel"):
        return "flash"
    low = name.lower()
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "matmul", "cublas")):
        return "matmul"
    return "other"


def held_against_oracle(metrics, run_pydes, np, plat, wl, cfg, s):
    """(schedule == the port's oracle's, the largest relative error of total
    energy, wasted energy and each DVFS mode-energy cell, metrics)."""
    m_o, des = run_pydes(plat, wl, cfg)
    m = metrics.metrics_from_state(s, plat)
    same = np.array_equal(metrics.schedule_table(s), des.schedule_table())
    rel = abs(m.total_energy_j - m_o.total_energy_j) / max(m_o.total_energy_j, 1.0)
    rel_w = abs(m.wasted_energy_j - m_o.wasted_energy_j) / max(m_o.wasted_energy_j, 1.0)
    me, me_o = np.asarray(m.energy_by_mode_j), np.asarray(m_o.energy_by_mode_j)
    rel_m = float(np.max(np.abs(me - me_o) / np.maximum(np.abs(me_o), 1.0)))
    return same, max(rel, rel_w, rel_m), m


def same_run(np, metrics, a, b, what):
    """Two runs of one configuration: schedule, batches and switch counts
    equal; energy and the mode ledgers to rel 1e-5. Returns the largest
    relative difference."""
    check(np.array_equal(metrics.schedule_table(a), metrics.schedule_table(b)),
          f"{what}: schedule")
    da, db = metrics.np_state(a), metrics.np_state(b)
    for fld in ("n_batches", "n_switch_on", "n_switch_off", "dvfs_mode"):
        check(np.array_equal(da[fld], db[fld]), f"{what}: {fld}")
    worst = 0.0
    for fld in ("energy", "mode_time", "mode_energy"):
        diff = np.abs(da[fld].astype(np.float64) - db[fld])
        rel = float(np.max(diff / np.maximum(np.abs(db[fld]), 1.0)))
        check(rel <= 1e-5, f"{what}: {fld} rel diff {rel}")
        worst = max(worst, rel)
    return worst


def profile_batches(torch, engine, plat, wl, cfg, n_batches=100, dev="cuda"):
    """(device ops a batch, device ms a batch, wall ms a batch, busy share,
    seconds the window took, profiler included) over the first
    ``n_batches`` batches of a run, with the device activity profiled only:
    the run is cut by ``max_batches`` (its truncation warning is
    silenced)."""
    return profile_window(
        torch, lambda cut: int(engine.simulate(plat, wl, cut, device=dev).n_batches),
        cfg, n_batches)


def profile_window(torch, run, cfg, n_batches=100):
    """:func:`profile_batches` of ``run(config) -> batches run`` (a single
    run's batches, or a sweep's loop iterations): a warm-up of the cut
    window, then the window profiled."""
    import warnings

    t_window = time.perf_counter()
    cut = dataclasses.replace(cfg, max_batches=n_batches)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run(cut)  # warm-up
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            nb = run(cut)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ops_ms = [e.device_time_total / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(nb == n_batches and ops_ms,
          f"profiled window: {nb} batches, {len(ops_ms)} device ops")
    busy_ms = sum(ops_ms)
    return (len(ops_ms) / nb, busy_ms / nb, 1e3 * wall / nb, busy_ms / (1e3 * wall),
            time.perf_counter() - t_window)


def poison(torch):
    """Leave NaN bytes in the allocator's free blocks, so an output element
    a kernel does not write cannot pass for a zero."""
    junk = [torch.full((1 << k,), float("nan"), device="cuda") for k in range(4, 18)]
    del junk


def shifted(torch, x, k):
    """A contiguous copy of ``x`` that starts ``k`` elements into a fresh
    buffer: ``4 k`` bytes past the allocator's 16-byte boundary."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[k:k + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def hold_kernel(torch, name, fn, plain, cases, zero_out):
    """Each case's kernel output == its plain version's, bit for bit, with
    one launch per non-empty call; zero sizes give ``zero_out(args)``.
    Returns the max abs difference seen (0.0 when all are equal)."""
    from repro_torch.kernels import event_fuse

    max_err = 0.0
    for label, args, empty in cases:
        poison(torch)
        before = event_fuse.LAUNCHES[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = zero_out(args) if empty else plain(*args)
        check(event_fuse.LAUNCHES[name] == before + (0 if empty else 1),
              f"{name} launch count at {label}")
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} output shape/dtype at {label}")
            check(torch.equal(a, b), f"{name} == plain at {label}")
            if a.numel():
                max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    return max_err


def time_kernel(torch, name, fn, plain, args, bound, shape, floor_ms, fill):
    """(kernel device ms, plain device ms, kernel wrapper host ms, fill host
    ms) at ``args``, printed with the plain version's device ops and host
    time, the bound, the cluster size of a cluster kernel and the launch
    floor ``floor_ms``. The wrapper's host time is taken in turns with that
    of ``fill`` (a function and its arguments: the 1-element fill), fill,
    wrapper, wrapper, fill, so each is read against the host's speed of the
    same moment; each figure is the mean of its two turns."""
    from repro_torch.kernels import event_fuse

    k_ms, k_ops, k_names, k_seen = device_ms(torch, fn, args)
    p_ms, p_ops, _, p_seen = device_ms(torch, plain, args)
    check(k_ops == 1 and all(f"{name}_kernel" in x for x in k_names),
          f"{name} ran {k_ops} device ops a call: {k_names}")
    turns = [time_ms(torch, *pair) for pair in (fill, (fn, args), (fn, args), fill)]
    k_host = (turns[1] + turns[2]) / 2
    fill_host = (turns[0] + turns[3]) / 2
    p_host = time_ms(torch, plain, args)
    b_ms, b_by = bound
    cluster = (f"cluster of {event_fuse.CLUSTER[name]} CTAs a row"
               if name in event_fuse.CLUSTER else "one block a row")
    print(f"phase 3 kernels: {name} {shape} ({cluster}): "
          f"device time kernel {1e3 * k_ms:.3f} us (launch floor "
          f"{1e3 * floor_ms:.3f} us), plain {1e3 * p_ms:.3f} us "
          f"({p_ops} device ops; profiler records seen: kernel "
          f"{k_seen:.3f}, plain {p_seen:.3f}); bound {1e3 * b_ms:.4f} us ({b_by}); "
          f"host time per call back to back, in turns fill, wrapper, wrapper, "
          f"fill: kernel wrapper {1e3 * k_host:.2f} us ({1e3 * turns[1]:.2f}, "
          f"{1e3 * turns[2]:.2f}), 1-element fill {1e3 * fill_host:.2f} us "
          f"({1e3 * turns[0]:.2f}, {1e3 * turns[3]:.2f}), wrapper / fill "
          f"{k_host / fill_host:.2f}; plain {1e3 * p_host:.2f} us; no single "
          "PyTorch call computes this fused pair, so there is no library "
          "time", flush=True)
    return k_ms, p_ms, k_host, fill_host


def phase10(torch, np, swf, g_state, g_metrics, g_cfg, dev="cuda", nodes=11200,
            max_jobs=1000):
    """Phase 10: the grouped Forecast and DVFS runs at Curie scale on
    ``dev``, each against its plain per-node route, the Forecast run at
    horizon 0 against phase 6's run (``g_state``, ``g_metrics``, ``g_cfg``),
    and the profiled windows. Returns the event kernels' launches of the
    Forecast and the DVFS run."""
    from repro_torch.core import engine, metrics
    from repro_torch.core.policy import from_label
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.workloads.generator import PRESETS, generate_workload
    from repro_torch.workloads.platform import curie_platform, dvfs_platform_example
    from repro_torch.workloads.traces import replay_workload
    t10 = time.perf_counter()
    curie = curie_platform(nodes)
    fc_wl = replay_workload(swf, nb_nodes=nodes, oversize="clamp", max_jobs=max_jobs)
    dvfs_plat = dvfs_platform_example(nodes)
    # phase 5's workload (the cea_curie preset cut to max_jobs jobs)
    dvfs_wl = generate_workload(dataclasses.replace(
        PRESETS["cea_curie"], n_jobs=max_jobs, nb_res=nodes,
        max_res=min(PRESETS["cea_curie"].max_res, nodes)))
    base, fc_pol = from_label("EASY PSUS+Forecast")
    fc_cfg = EngineConfig(base=base, policy=fc_pol, timeout=1800, forecast_horizon=1800,
                          grouped_tables=True)
    base, dv_pol = from_label("EASY PSUS+DVFS")
    dv_cfg = EngineConfig(base=base, policy=dv_pol, timeout=900, node_order="cheap",
                          terminate_overrun=True, grouped_tables=True)
    runs10 = {}
    for name, plat, wl, cfg in (("forecast", curie, fc_wl, fc_cfg),
                                ("dvfs", dvfs_plat, dvfs_wl, dv_cfg)):
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0
        t0 = time.perf_counter()
        s = engine.simulate(plat, wl, cfg, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(event_fuse.LAUNCHES)
        syncs = engine.HOST_SYNCS
        nb = int(s.n_batches)
        check(nb > 0 and not bool(s.truncated) and bool(engine.all_done(s)),
              f"phase 10 {name}: {nb} batches, truncated or jobs left")
        check(launches["event_fuse_occ"] == nb,
              f"phase 10 {name}: occ kernel launches {launches} != n_batches {nb}")
        check(launches["event_fuse_ledger"] == 0 and launches["event_fuse"] == 0
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 10 {name}: other kernels launched")
        check(syncs <= 2 * nb, f"phase 10 {name}: {syncs} host syncs for {nb} batches")
        t0 = time.perf_counter()
        plain = engine.simulate(plat, wl, dataclasses.replace(cfg, fused_kernel=False),
                                device=dev)
        plain_wall = time.perf_counter() - t0
        rel = same_run(np, metrics, s, plain, f"phase 10 {name} kernel vs plain route")
        runs10[name] = dict(state=s, wall=wall, plain_wall=plain_wall, n_batches=nb,
                            syncs=syncs, occ=launches["event_fuse_occ"], rel=rel,
                            m=metrics.metrics_from_state(s, plat), by_kernel=launches)
    fc0 = engine.simulate(curie, fc_wl, dataclasses.replace(fc_cfg, forecast_horizon=0),
                          device=dev)
    check(np.array_equal(metrics.schedule_table(fc0), metrics.schedule_table(g_state)),
          "phase 10: Forecast at horizon 0 == phase 6's EASY PSUS schedule")
    d0, d6 = metrics.np_state(fc0), metrics.np_state(g_state)
    for fld in ("energy", "n_batches", "n_switch_on", "n_switch_off"):
        check(np.array_equal(d0[fld], d6[fld]), f"phase 10: horizon 0 {fld} == phase 6's")
    prof10 = {name: profile_batches(torch, engine, plat, wl, cfg, dev=dev)
              for name, plat, wl, cfg in (
                  ("phase 6 EASY PSUS", curie, fc_wl, g_cfg),
                  ("forecast", curie, fc_wl, fc_cfg),
                  ("dvfs", dvfs_plat, dvfs_wl, dv_cfg))}
    fc, dv = runs10["forecast"], runs10["dvfs"]
    fc_by_kernel, dv_by_kernel = fc["by_kernel"], dv["by_kernel"]
    fm, dm = fc["m"], dv["m"]
    for name, r in runs10.items():
        print(f"phase 10 {name}: n_batches {r['n_batches']}, occ kernel launches "
              f"{r['occ']}, host syncs {r['syncs']} ({r['syncs'] / r['n_batches']:.3f}"
              f"/batch); wall {r['wall']:.2f} s = "
              f"{1e6 * r['wall'] / r['n_batches']:.1f} us/batch (plain per-node route "
              f"{r['plain_wall']:.2f} s, schedule equal, energy and mode ledgers max rel "
              f"diff {r['rel']:.2e})", flush=True)
    print(f"phase 10 forecast: EASY PSUS+Forecast horizon 1800 on curie_platform({nodes}), "
          f"{len(fc_wl)} replayed jobs: switch-ons {int(fc['state'].n_switch_on)} (phase 6 "
          f"EASY PSUS {int(g_state.n_switch_on)}), total {fm.total_energy_j / 3.6e6:.1f} "
          f"kWh ({g_metrics.total_energy_j / 3.6e6:.1f}), mean wait {fm.mean_wait_s:.1f} s "
          f"({g_metrics.mean_wait_s:.1f}), makespan {fm.makespan_s} s "
          f"({g_metrics.makespan_s}); horizon 0: schedule, energy, batches and switch "
          f"counts == phase 6's bit for bit", flush=True)
    names = dvfs_plat.group_names()
    print(f"phase 10 dvfs: EASY PSUS+DVFS timeout 900 on dvfs_platform_example({nodes}), "
          f"cea_curie {len(dvfs_wl)} jobs: mode residency s (slow, base, turbo) "
          + "; ".join(f"{g} {[round(x) for x in row]}"
                      for g, row in zip(names, dm.mode_residency_s))
          + f"; total {dm.total_energy_j / 3.6e6:.1f} kWh, mean wait {dm.mean_wait_s:.1f} "
          f"s, makespan {dm.makespan_s} s, terminated {dm.n_terminated}", flush=True)
    for name, (ops, dev_ms, wall_ms, busy, took) in prof10.items():
        print(f"phase 10 profile, first 100 batches, {name}: {ops:.1f} device ops a "
              f"batch, device {1e3 * dev_ms:.1f} us a batch, wall {1e3 * wall_ms:.1f} us "
              f"a batch (profiled), busy {100 * busy:.1f} % (window and warm-up "
              f"{took:.1f} s)", flush=True)
    print(f"phase 10 wall {time.perf_counter() - t10:.1f} s", flush=True)
    return fc_by_kernel, dv_by_kernel


SWEEP_SCHEDULERS = ("EASY PSUS", "FCFS PSAS+IPM")  # benchmarks/bench_scale.py's grid


def sweep_grid(k, timeouts=None):
    """``bench_scale.py``'s scheduler x timeout grid of ``k`` rows (timeouts
    300 + 300 i), or the two schedulers x ``timeouts``; scheduler-major."""
    timeouts = timeouts or [300 + 300 * i for i in range(k // 2)]
    return [{"scheduler": s, "timeout": t} for s in SWEEP_SCHEDULERS for t in timeouts]


def sweep_sync_check(torch, dev="cuda"):
    """(host reads the sweep counted, synchronizing calls PyTorch reported,
    iterations) of a 16-node grid of 8 mixed rows: ``sweep.run_sim`` alone
    under ``torch.cuda.set_sync_debug_mode("warn")``, so the loop is shown
    to read the device only where it counts a read."""
    import warnings

    from repro_torch.core import engine, sweep
    from repro_torch.core.types import EngineConfig
    from repro_torch.workloads.generator import GeneratorConfig, generate_workload
    from repro_torch.workloads.platform import PlatformSpec
    plat = PlatformSpec(nb_nodes=16)
    wl = generate_workload(GeneratorConfig(n_jobs=60, nb_res=16, seed=3))
    cfg = EngineConfig(timeout=300)
    base = engine.make_const(plat, cfg, device=dev)
    rows = [sweep._scenario_const(sc, base, plat, cfg, torch.device(dev))[0]
            for sc in sweep_grid(8, [60, 300, 900, 1800])]
    grid = sweep.make_grid(rows, dev)
    s0 = sweep.replicate_state(engine.init_state(plat, wl, cfg, device=dev), len(rows))
    torch.cuda.synchronize()
    engine.HOST_SYNCS = 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            s = sweep.run_sim(s0, grid, cfg, engine.default_batch_cap(len(wl)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reported = sum("synchroniz" in str(r.message) for r in rec)
    return engine.HOST_SYNCS, reported, int(s.n_batches.max())


def phase11(torch, np, swf, d_state, g_state, dev="cuda", nodes=11200, max_jobs=1000):
    """Phase 11: the batched sweep at Curie scale. Dense grids at E = 1, 8
    and 64 on phase 5's inputs and a grouped grid at E = 8 on phase 6's,
    each row held bit for bit against a single run (``d_state``: phase 5's
    run; ``g_state``: phase 6's) or against the same scenario's row of
    another grid. Returns the event kernels' launches of the timed dense
    grids (summed) and of the grouped grid."""
    from repro_torch.core import engine, sweep
    from repro_torch.core.policy import from_label
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.workloads.generator import PRESETS, generate_workload
    from repro_torch.workloads.platform import PlatformSpec, curie_platform
    from repro_torch.workloads.traces import replay_workload
    t11 = time.perf_counter()
    dense_plat = PlatformSpec(nb_nodes=nodes)
    # phase 5's workload (the cea_curie preset cut to max_jobs jobs)
    dense_wl = generate_workload(dataclasses.replace(
        PRESETS["cea_curie"], n_jobs=max_jobs, nb_res=nodes,
        max_res=min(PRESETS["cea_curie"].max_res, nodes)))
    base, pol = from_label("EASY PSUS")
    dense_cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    g_plat = curie_platform(nodes)
    g_wl = replay_workload(swf, nb_nodes=nodes, oversize="clamp", max_jobs=max_jobs)
    g_cfg = dataclasses.replace(dense_cfg, grouped_tables=True)
    grids = [
        ("dense E=1", dense_plat, dense_wl, dense_cfg,
         [{"scheduler": "EASY PSUS", "timeout": 1800}], "event_fuse_ledger"),
        ("dense E=8", dense_plat, dense_wl, dense_cfg, sweep_grid(8), "event_fuse_ledger"),
        ("dense E=64", dense_plat, dense_wl, dense_cfg, sweep_grid(64), "event_fuse_ledger"),
        ("grouped E=8", g_plat, g_wl, g_cfg, sweep_grid(8, [600, 1200, 1800, 2400]),
         "event_fuse_occ"),
    ]
    runs = {}
    for name, plat, wl, cfg, scen, kname in grids:
        def run(c, plat=plat, wl=wl, scen=scen):
            return int(sweep.sweep(plat, wl, scen, c, device=dev).states.n_batches.max())

        # the first call: the profiled window's warm-up, then its window
        prof = profile_window(torch, run, cfg)
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0
        live_mib = torch.cuda.memory_allocated() / 2**20  # earlier phases' tensors
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = sweep.sweep(plat, wl, scen, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(event_fuse.LAUNCHES)
        syncs = engine.HOST_SYNCS
        nb = b.states.n_batches.cpu().numpy()
        iters = int(nb.max())
        peak_mib = torch.cuda.max_memory_allocated() / 2**20 - live_mib
        check(not b.states.truncated.any() and bool(sweep.all_done(b.states).all()),
              f"phase 11 {name}: a row truncated or left jobs")
        check(launches[kname] == iters,
              f"phase 11 {name}: {kname} launches {launches} != iterations {iters}")
        check(all(v == 0 for k, v in launches.items() if k != kname)
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 11 {name}: other kernels launched: {launches}")
        check(syncs <= 2 * iters, f"phase 11 {name}: {syncs} host syncs for {iters} iterations")
        runs[name] = dict(batch=b, scen=scen, wall=wall, iters=iters, nb=nb, syncs=syncs,
                          launches=launches[kname], prof=prof, peak=peak_mib)
        print(f"phase 11 {name}: {len(scen)} scenarios on {plat.nb_nodes} nodes, "
              f"{len(wl)} jobs: wall {wall:.2f} s (a call after the profiled window "
              f"and its warm-up), {wall / len(scen):.3f} s a scenario; iterations "
              f"{iters} (rows' n_batches {int(nb.min())}..{iters}), "
              f"{1e6 * wall / iters:.1f} us an iteration; {kname} launches "
              f"{launches[kname]}; host syncs {syncs} ({syncs / iters:.3f} an "
              f"iteration); first 100 iterations profiled: {prof[0]:.1f} device ops "
              f"an iteration, device {1e3 * prof[1]:.1f} us an iteration, wall "
              f"{1e3 * prof[2]:.1f} us (profiled), busy {100 * prof[3]:.1f} %; peak "
              f"device memory {peak_mib:.1f} MiB above the {live_mib:.1f} MiB live "
              "before it", flush=True)

    def row(name, scheduler, timeout):
        r = runs[name]
        i = r["scen"].index({"scheduler": scheduler, "timeout": timeout})
        return r["batch"].state_at(i)

    def same_bits(a, b, what):
        da, db = metrics_np(a), metrics_np(b)
        bad = [k for k in da if not (da[k].dtype == db[k].dtype
                                     and np.array_equal(da[k], db[k]))]
        check(not bad, f"phase 11: {what}: fields {bad} differ")

    from repro_torch.core.metrics import np_state as metrics_np
    syncs, reported, small_iters = sweep_sync_check(torch, dev)
    check(reported == syncs, f"phase 11: PyTorch reports {reported} synchronizing calls "
          f"in a small grid's loop, the sweep counts {syncs} host reads")
    same_bits(row("dense E=1", "EASY PSUS", 1800), d_state, "E=1 sweep == phase 5's run")
    same_bits(row("dense E=64", "EASY PSUS", 1800), d_state,
              "E=64 row EASY PSUS 1800 == phase 5's run")
    for sc in runs["dense E=8"]["scen"]:
        same_bits(row("dense E=8", **sc), row("dense E=64", **sc),
                  f"E=8 row {sc} == its E=64 row")
    base, pol = from_label("FCFS PSAS+IPM")
    t0 = time.perf_counter()
    single = engine.simulate(dense_plat, dense_wl,
                             dataclasses.replace(dense_cfg, base=base, policy=pol,
                                                 timeout=600), device=dev)
    single_wall = time.perf_counter() - t0
    same_bits(row("dense E=8", "FCFS PSAS+IPM", 600), single,
              "E=8 row FCFS PSAS+IPM 600 == its single run")
    same_bits(row("grouped E=8", "EASY PSUS", 1800), g_state,
              "grouped E=8 row EASY PSUS 1800 == phase 6's run")
    m = {name: r["batch"].metrics for name, r in runs.items()}
    print("phase 11 rows: E=1 and the E=64 row EASY PSUS 1800 == phase 5's run bit for "
          "bit; each E=8 row == its E=64 row; the E=8 row FCFS PSAS+IPM 600 == its "
          f"single run on the card ({single_wall:.2f} s); the grouped row EASY PSUS "
          f"1800 == phase 6's run; a 16-node grid of 8 rows under "
          f"torch.cuda.set_sync_debug_mode: {reported} synchronizing calls reported "
          f"== the sweep's {syncs} host reads in {small_iters} iterations; "
          "dense E=64 total energy kWh by timeout, EASY PSUS "
          + ", ".join(f"{sc['timeout']}: {mm.total_energy_j / 3.6e6:.1f}"
                      for sc, mm in zip(runs["dense E=64"]["scen"], m["dense E=64"])
                      if sc["scheduler"] == "EASY PSUS" and sc["timeout"] % 1800 == 0)
          + f"; phase wall {time.perf_counter() - t11:.1f} s", flush=True)
    dense = sum(runs[n]["launches"] for n in ("dense E=1", "dense E=8", "dense E=64"))
    return dense, runs["grouped E=8"]["launches"]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — nothing was run")
    import numpy as np

    from repro_torch.core import engine, metrics
    from repro_torch.core.policy import from_label, scheduler_labels
    from repro_torch.core.ref.pydes import run_pydes
    from repro_torch.core.types import EngineConfig
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models import ssm
    from repro_torch.workloads.generator import (
        PRESETS, GeneratorConfig, generate_workload,
    )
    from repro_torch.workloads.platform import (
        PlatformSpec, curie_platform, dvfs_platform_example, mixed_platform_example,
    )
    from repro_torch.workloads.traces import replay_workload, synthesize_curie_swf

    t_script = time.perf_counter()
    # ---- 1. device ----
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name}, count={torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    # ---- 2. build ----
    def timed_load(src):
        t = time.perf_counter()
        _build.load(src)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    sources = ("event_fuse", "flash_attention", "ssd_scan")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = {src: pool.submit(timed_load, src) for src in sources}
        build_each = {src: f.result() for src, f in builds.items()}
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: event_fuse.cu with {', '.join(event_fuse.KERNELS)} "
          f"({build_each['event_fuse']:.1f} s), flash_attention.cu "
          f"({build_each['flash_attention']:.1f} s) and ssd_scan.cu "
          f"({build_each['ssd_scan']:.1f} s), one nvcc each, together "
          f"(wall {build_s:.1f} s)", flush=True)
    report = ptxas_report(_build.build_log("event_fuse"), event_fuse.KERNELS)
    for kname in event_fuse.KERNELS:
        check(report[kname], f"ptxas reported nothing for {kname}")
        for line in report[kname]:
            print(f"  ptxas {kname}: {line}")
    flash_report = instance_ptxas(_build.build_log("flash_attention"), flash_label)
    check(len(flash_report) == 18 and all(flash_report.values()),
          f"ptxas reported {sorted(flash_report)} for flash_attention (16 SIMT and 2 "
          "wgmma instantiations expected)")
    for inst, lines in sorted(flash_report.items()):
        print(f"  ptxas flash_attention {inst}: {'; '.join(lines)}")
    ssd_report = instance_ptxas(_build.build_log("ssd_scan"), ssd_label)
    check(sorted(ssd_report) == SSD_INSTANCES and all(ssd_report.values()),
          f"ptxas reported {sorted(ssd_report)} for ssd_scan, not {SSD_INSTANCES}")
    for inst, lines in sorted(ssd_report.items()):
        print(f"  ptxas {inst}: {'; '.join(lines)}")

    # ---- 3. kernels against their plain versions ----
    def empty_pair(cols):
        def zero_out(args):
            e = args[0].shape[0]
            return (torch.zeros((e, *cols(args)), device="cuda"),
                    torch.full((e,), INF_TIME, dtype=torch.int32, device="cuda"))
        return zero_out

    check(max(g for _, _, g in OCC_SHAPES) == event_fuse.MAX_GROUPS,
          "OCC_SHAPES reach event_fuse.MAX_GROUPS")
    e_sh, n_sh, g_sh = SHIFTED
    ledger_shifted = kernel_inputs(torch, np, e_sh, n_sh)
    ledger_shifted[:2] = [shifted(torch, x, k)
                          for x, k in zip(ledger_shifted[:2], SHIFTS[:2])]
    occ_shifted = occ_inputs(torch, np, e_sh, n_sh, g_sh)
    occ_shifted[:2] = ledger_shifted[:2]
    occ_shifted[3] = shifted(torch, occ_shifted[3], SHIFTS[2])
    err = {}
    err["event_fuse_ledger"] = hold_kernel(
        torch, "event_fuse_ledger", event_fuse.event_fuse_ledger,
        event_fuse.event_fuse_ledger_plain,
        [((e, n), kernel_inputs(torch, np, e, n), not (e and n))
         for e, n in EXACT_SHAPES + ZERO_SHAPES]
        + [((e, n, "per-row watts"), kernel_inputs(torch, np, e, n, per_row=True), False)
           for e, n in ROW_TABLE_SHAPES]
        + [((e_sh, n_sh, "shifted", SHIFTS[:2]), ledger_shifted, False)],
        empty_pair(lambda args: (8,)),
    )
    err["event_fuse_occ"] = hold_kernel(
        torch, "event_fuse_occ", event_fuse.event_fuse_occ,
        event_fuse.event_fuse_occ_plain,
        [((e, n, g), occ_inputs(torch, np, e, n, g), not (e and n))
         for e, n, g in OCC_SHAPES + OCC_ZERO_SHAPES]
        + [((e, n, g, "dead lanes"), occ_inputs(torch, np, e, n, g, dead=True),
            False) for e, n, g in OCC_DEAD_SHAPES]
        + [((e, n, g, "per-row group ids"),
            occ_inputs(torch, np, e, n, g, per_row=True), False)
           for e, n, g in ROW_OCC_SHAPES]
        + [((*SHIFTED, "shifted", SHIFTS), occ_shifted, False)],
        empty_pair(lambda args: (args[4], 8)),
    )
    err["event_fuse"] = hold_kernel(
        torch, "event_fuse", event_fuse.event_fuse, event_fuse.event_fuse_plain,
        [((e, n), kernel_inputs(torch, np, e, n), not (e and n))
         for e, n in EXACT_SHAPES + ZERO_SHAPES],
        empty_pair(lambda args: ()),
    )

    def fill_one(x):  # the smallest kernel PyTorch launches
        return x.fill_(0.0)

    one = [torch.empty(1, device="cuda")]
    floor_ms = device_ms(torch, fill_one, one)[0]
    fill = (fill_one, one)  # host times are read against the fill's, in turns
    print(f"phase 3 kernels: launch floor, a 1-element fill: device time "
          f"{1e3 * floor_ms:.3f} us", flush=True)
    timing, clusters = {}, {}
    for e, n in (MAIN_SHAPE, (8, 11200), (64, 11200)):
        timing["event_fuse_ledger", e] = time_kernel(
            torch, "event_fuse_ledger", event_fuse.event_fuse_ledger,
            event_fuse.event_fuse_ledger_plain, kernel_inputs(torch, np, e, n),
            ledger_bound(e, n), f"E={e} N={n}", floor_ms, fill)
        clusters["event_fuse_ledger", e] = event_fuse.CLUSTER["event_fuse_ledger"]
    for e, n, g in (OCC_MAIN, (8, 11200, 3), (64, 11200, 3)):
        timing["event_fuse_occ", e] = time_kernel(
            torch, "event_fuse_occ", event_fuse.event_fuse_occ,
            event_fuse.event_fuse_occ_plain, occ_inputs(torch, np, e, n, g),
            occ_bound(e, n, g), f"E={e} N={n} G={g}", floor_ms, fill)
        clusters["event_fuse_occ", e] = event_fuse.CLUSTER["event_fuse_occ"]
    timing["event_fuse", 1] = time_kernel(
        torch, "event_fuse", event_fuse.event_fuse, event_fuse.event_fuse_plain,
        kernel_inputs(torch, np, *MAIN_SHAPE), draw_bound(*MAIN_SHAPE),
        "E={} N={}".format(*MAIN_SHAPE), floor_ms, fill)
    for kname in ("event_fuse_ledger", "event_fuse_occ"):
        max_c, sms = event_fuse.cluster_setup(kname, 0)
        print(f"phase 3 kernels: {kname} runs clusters of "
              f"{clusters[kname, 1]} CTAs at E=1, {clusters[kname, 8]} at E=8 and "
              f"{clusters[kname, 64]} at E=64 "
              f"(the card holds clusters of up to {max_c} on {sms} SMs); ptxas: "
              f"{'; '.join(report[kname])}", flush=True)
    # flash attention: tolerance, not bits (f32 sums in another order)
    flash_err, flash_cases = 0.0, []
    for dname, tol in FLASH_TOL.items():
        for shape in FLASH_SHAPES:
            q, k, v = flash_inputs(torch, np, shape, getattr(torch, dname))
            route = fa.variant(q.dtype, shape[5])
            before = dict(fa.LAUNCHES)
            got = fa.flash_attention(q, k, v, causal=shape[-1])
            torch.cuda.synchronize()
            check(fa.LAUNCHES == dict(before, **{
                "flash_attention": before["flash_attention"] + 1,
                f"flash_attention_{route}": before[f"flash_attention_{route}"] + 1}),
                f"flash_attention launch counts at {shape} {dname}: one {route} launch")
            want = fa.flash_attention_plain(q, k, v, causal=shape[-1])
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"flash_attention output shape/dtype at {shape} {dname}")
            e = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), atol=tol, rtol=tol),
                f"flash_attention == plain at {shape} {dname}: max abs err {e}")
            flash_err = max(flash_err, e)
            flash_cases.append(
                f"{dname} {shape[:6]}{'' if shape[-1] else ' full'} {route}: {e:.3g}")
    zq = torch.zeros((1, 0, 2, 16), device="cuda", dtype=torch.bfloat16)
    zk = torch.zeros((1, 8, 2, 16), device="cuda", dtype=torch.bfloat16)
    before = fa.LAUNCHES["flash_attention"]
    zo = fa.flash_attention(zq, zk, zk)
    check(zo.shape == zq.shape and fa.LAUNCHES["flash_attention"] == before,
          "flash_attention zero size: zeros, no launch")
    print(f"phase 3 kernels: flash_attention == plain (atol and rtol "
          f"{FLASH_TOL}) at (B, Sq, Sk, H, KH, hd) max abs err: "
          f"{'; '.join(flash_cases)}", flush=True)

    def flash_kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def flash_simt(q, k, v):  # the SIMT kernel, whatever the table routes
        return fa.launch_variant("simt", q, k, v, causal=True)

    def flash_plain(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True)

    def sdpa(q, k, v):  # timed only: the port never calls it
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    def one_kernel(fn, args, kname):
        """Device ms per call of ``fn``, which must launch only ``kname``."""
        ms, ops, names, seen = device_ms(torch, fn, args, calls=100)
        check(ops == 1 and [kernel_base(n) for n in names] == [kname],
              f"{fn.__name__} ran {ops} device ops a call: {list(names)}")
        return ms, seen

    # bf16 at the prefill shape, in turns: SIMT, wgmma, wgmma, SIMT
    args = flash_inputs(torch, np, FLASH_MAIN, torch.bfloat16)
    turns = [(route, one_kernel(fn, args, kname)) for route, fn, kname in (
        ("simt", flash_simt, "flash_attention_kernel"),
        ("wgmma", flash_kernel, "flash_attention_wgmma_kernel"),
        ("wgmma", flash_kernel, "flash_attention_wgmma_kernel"),
        ("simt", flash_simt, "flash_attention_kernel"))]
    w_ms = statistics.fmean(t[0] for r, t in turns if r == "wgmma")
    s_ms = statistics.fmean(t[0] for r, t in turns if r == "simt")
    simt_err = float((flash_simt(*args).float() - flash_plain(*args).float()).abs().max())
    p_ms, p_ops, _, p_seen = device_ms(torch, flash_plain, args, calls=50)
    l_ms, l_ops, l_names, l_seen = device_ms(torch, sdpa, args, calls=100)
    l_err = float((sdpa(*args).float() - flash_plain(*args).float()).abs().max())
    k_host = host_ms(torch, flash_kernel, args)
    b_ms, b_by = flash_bound(*FLASH_MAIN, itemsize=2)
    flash_time = {"bfloat16": (w_ms, p_ms, l_ms, b_ms, b_by, s_ms)}
    print(f"phase 3 kernels: flash_attention bfloat16 (B, Sq, Sk, H, KH, hd) "
          f"{FLASH_MAIN[:6]} causal, in turns: device time "
          + ", ".join(f"{r} {1e3 * t[0]:.3f} us" for r, t in turns)
          + f" (wgmma {1e3 * w_ms:.3f} us, SIMT {1e3 * s_ms:.3f} us: {s_ms / w_ms:.1f}x; "
          f"SIMT on these bf16 inputs == plain to {simt_err:.3g}); plain "
          f"{1e3 * p_ms:.3f} us ({p_ops} device ops); scaled_dot_product_attention "
          f"{1e3 * l_ms:.3f} us ({l_ops} device ops: "
          f"{', '.join(n[:60] for n in l_names)}; max abs diff from plain {l_err:.3g}); "
          f"wgmma / SDPA {w_ms / l_ms:.2f}; bound {1e3 * b_ms:.3f} us ({b_by}), "
          f"wgmma at {b_ms / w_ms:.3f} of it; wgmma wrapper host time "
          f"{1e3 * k_host:.2f} us per call; profiler records seen: "
          + ", ".join(f"{r} {t[1]:.3f}" for r, t in turns)
          + f", plain {p_seen:.3f}, sdpa {l_seen:.3f}", flush=True)
    # f32 at the prefill shape: the SIMT kernel
    args = flash_inputs(torch, np, FLASH_MAIN, torch.float32)
    k_ms, k_seen = one_kernel(flash_kernel, args, "flash_attention_kernel")
    p_ms, p_ops, _, p_seen = device_ms(torch, flash_plain, args, calls=50)
    l_ms, l_ops, l_names, l_seen = device_ms(torch, sdpa, args, calls=100)
    b_ms, b_by = flash_bound(*FLASH_MAIN, itemsize=4)
    flash_time["float32"] = (k_ms, p_ms, l_ms, b_ms, b_by, k_ms)
    print(f"phase 3 kernels: flash_attention float32 (B, Sq, Sk, H, KH, hd) "
          f"{FLASH_MAIN[:6]} causal: device time SIMT kernel {1e3 * k_ms:.3f} us, plain "
          f"{1e3 * p_ms:.3f} us ({p_ops} device ops), scaled_dot_product_attention "
          f"{1e3 * l_ms:.3f} us ({l_ops} device ops); bound {1e3 * b_ms:.3f} us "
          f"({b_by}); profiler records seen: kernel {k_seen:.3f}, plain {p_seen:.3f}, "
          f"sdpa {l_seen:.3f}", flush=True)

    # ssd_scan: tolerance, not bits (f32 sums in another order)
    ssd_err, ssd_cases = 0.0, []
    for label, shape, dts, with_h0 in SSD_CHECKS:
        q, k, v, g, h0 = ssd_inputs(torch, np, shape, dts, with_h0)
        chunk = shape[-1]
        before = ssd.LAUNCHES["ssd_scan"]
        y, h_t = ssd.ssd_scan(q, k, v, g, h0, chunk)
        torch.cuda.synchronize()
        check(ssd.LAUNCHES["ssd_scan"] == before + 1, f"ssd_scan launch count at {label}")
        y_p, h_p = ssd.ssd_scan_plain(q, k, v, g, h0, chunk)
        check(y.shape == y_p.shape and y.dtype == y_p.dtype == v.dtype
              and h_t.shape == h_p.shape and h_t.dtype == torch.float32,
              f"ssd_scan output shapes/dtypes at {label}")
        yf, ypf = y.float(), y_p.float()
        scale, h_scale = float(ypf.abs().max()), float(h_p.abs().max())
        allowed = SSD_F32_TOL * scale
        if v.dtype == torch.bfloat16:
            allowed = BF16_ULP * torch.maximum(yf.abs(), ypf.abs()) + 1e-5 * scale
        e, h_e = float((yf - ypf).abs().max()), float((h_t - h_p).abs().max())
        check(bool(torch.isfinite(yf).all()) and bool(((yf - ypf).abs() <= allowed).all())
              and bool(torch.isfinite(h_t).all()) and h_e <= SSD_F32_TOL * h_scale,
              f"ssd_scan == plain at {label} {shape}: y max abs err {e} of {scale}, "
              f"h_final {h_e} of {h_scale}")
        y2, h2 = ssd.ssd_scan(q, k, v, g, h0, chunk)
        check(torch.equal(y2, y) and torch.equal(h2, h_t),
              f"ssd_scan at {label}: a second run is not bit for bit the first")
        plan = ssd.launch_plan(*shape)
        check(ssd.kernel_plan(*shape) == {key: plan[key] for key in
                                          ("grids", "tile_n", "score_parts")},
              f"ssd_scan at {label}: the library's launch plan is not launch_plan's")
        ssd_err = max(ssd_err, e)
        ssd_cases.append(f"{label} {shape[:5]} chunk {chunk}: y {e:.3g} of {scale:.3g}, "
                         f"h {h_e:.3g} of {h_scale:.3g}")
    zq = torch.zeros((1, 0, 2, 16), device="cuda")
    before = ssd.LAUNCHES["ssd_scan"]
    zy, zh = ssd.ssd_scan(zq, zq, zq, torch.zeros((1, 0, 2), device="cuda"))
    check(zy.shape == zq.shape and zh.shape == (1, 2, 16, 16) and not zh.any()
          and ssd.LAUNCHES["ssd_scan"] == before, "ssd_scan zero size: zeros, no launch")
    print(f"phase 3 kernels: ssd_scan == plain (f32 y and h_final to {SSD_F32_TOL} of "
          f"their largest magnitude; bf16 y to one bf16 ulp plus 1e-5 of it), a second "
          f"run bit for bit the first, the library's launch plan launch_plan's, at "
          f"(B, S, H, dk, dv): {'; '.join(ssd_cases)}", flush=True)

    def ssd_kernel(q, k, v, g, h0):
        return ssd.ssd_scan(q, k, v, g, h0, SSD_MAIN[-1])

    def ssd_plain(q, k, v, g, h0):
        return ssd.ssd_scan_plain(q, k, v, g, h0, SSD_MAIN[-1])

    ssd_time = {}
    for shape in (SSD_MAIN, SSD_NORM):
        args = ssd_inputs(torch, np, shape, _MIXED)
        b, _, h, dk, dv, _ = shape
        args[4] = torch.zeros((b, h, dk, dv), device="cuda")  # the prefill's zero state
        k_ms, k_ops, k_names, k_seen = device_ms(torch, ssd_kernel, args, calls=50)
        check(k_ops == ssd.KERNELS_PER_CALL
              and all(kernel_base(x).startswith("ssd_scan") for x in k_names),
              f"ssd_scan ran {k_ops} device ops a call ({ssd.KERNELS_PER_CALL} "
              f"expected): {list(k_names)}")
        p_ms, p_ops, _, p_seen = device_ms(torch, ssd_plain, args, calls=10)
        k_host = host_ms(torch, ssd_kernel, args)
        b_ms, b_by = ssd_bound(*shape, itemsizes=(2, 4, 2), h0=True)
        ssd_time[dv] = (k_ms, p_ms, b_ms, b_by, k_host)
        print(f"phase 3 kernels: ssd_scan (B, S, H, dk, dv, chunk) {shape} q bf16, k "
              f"f32, v bf16, zero h0: device time kernels {1e3 * k_ms:.3f} us ("
              + ", ".join(f"{kernel_base(x)} {1e3 * t:.3f}" for x, t in k_names.items())
              + f"), plain {1e3 * p_ms:.3f} us ({p_ops} device ops; kernels / plain "
              f"{k_ms / p_ms:.3f}); bound {1e3 * b_ms:.3f} us ({b_by}), kernels at "
              f"{b_ms / k_ms:.3f} of it; kernel wrapper host time {1e3 * k_host:.2f} us "
              f"per call; profiler records seen: kernels {k_seen:.3f}, plain "
              f"{p_seen:.3f}; no single PyTorch call computes a GLA scan, so there is "
              "no library time", flush=True)

    print(f"phase 3 kernels: each event kernel == its plain version bit for bit: "
          f"event_fuse_ledger and event_fuse at {EXACT_SHAPES}, "
          f"event_fuse_occ at (E, N, G) {OCC_SHAPES}, with dead lanes at "
          f"{OCC_DEAD_SHAPES}, one table a row ([E, 5] watts at {ROW_TABLE_SHAPES}, "
          f"[E, N] group ids at (E, N, G) {ROW_OCC_SHAPES}), "
          f"the ledger and occupancy kernels with state, "
          f"until and group ids {SHIFTS} int32s off a 16-byte boundary at "
          f"{SHIFTED}, and zero sizes, free memory poisoned with NaN; "
          f"max_abs_err {err}", flush=True)

    # ---- 4. the paper's schedulers on the card ----
    t0 = time.perf_counter()
    n_label_runs = 0
    for plat, order in ((PlatformSpec(nb_nodes=16), "id"),
                        (mixed_platform_example(16), "cheap")):
        wl = generate_workload(
            GeneratorConfig(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2)
        )
        for label in LABELS:
            base, pol = from_label(label)
            cfg = EngineConfig(base=base, policy=pol, timeout=300,
                               terminate_overrun=True, node_order=order)
            s = engine.simulate(plat, wl, cfg, device="cuda")
            same, rel, _ = held_against_oracle(
                metrics, run_pydes, np, plat, wl, cfg, s)
            check(same, f"{label} on {order}-ordered platform: schedule")
            check(rel <= 1e-5, f"{label}: energy rel err {rel}")
            n_label_runs += 1
    print(f"phase 4 labels: {n_label_runs} runs on cuda == oracle "
          f"(schedule exact, energy rel <= 1e-5) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    plat = dvfs_platform_example(16)
    wl = generate_workload(
        GeneratorConfig(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2)
    )
    rule_labels = scheduler_labels(include_dvfs=True, include_forecast=True) + (
        "EASY DVFS+Forecast",)
    worst, residency = 0.0, 0.0
    for label in rule_labels:
        base, pol = from_label(label)
        cfg = EngineConfig(base=base, policy=pol, timeout=300, terminate_overrun=True,
                           node_order="cheap", forecast_horizon=900)
        s = engine.simulate(plat, wl, cfg, device="cuda")
        same, rel, m = held_against_oracle(metrics, run_pydes, np, plat, wl, cfg, s)
        check(same, f"{label} on the DVFS platform: schedule")
        check(rel <= 1e-5, f"{label} on the DVFS platform: energy rel err {rel}")
        worst = max(worst, rel)
        residency += sum(row[0] + row[2] for row in m.mode_residency_s)
    check(residency > 0, "DVFS labels never left the base mode")
    print(f"phase 4 rules 8-10: {len(rule_labels)} DVFS and Forecast labels on "
          f"dvfs_platform_example(16), dense, on cuda == oracle (schedule exact, "
          f"energy and mode energy rel err <= {worst:.2e}; {residency:.0f} group-s "
          f"in the slow and turbo modes) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    swf = synthesize_curie_swf(os.path.join(tmp, "curie.swf"))  # seed 1300
    t0 = time.perf_counter()
    plat = curie_platform(280)
    wl = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=120)
    grouped_runs = [({"node_order": "cheap"}, label) for label in LABELS]
    worst = 0.0
    for opts, label in grouped_runs + GROUPED_OPTIONS:
        base, pol = from_label(label)
        cfg = EngineConfig(base=base, policy=pol, timeout=1800,
                           grouped_tables=True, **opts)
        event_fuse.reset_launches()
        s = engine.simulate(plat, wl, cfg, device="cuda")
        check(event_fuse.LAUNCHES["event_fuse_occ"] == int(s.n_batches),
              f"grouped {label} {opts}: occupancy kernel launches")
        same, rel, _ = held_against_oracle(
            metrics, run_pydes, np, plat, wl, cfg, s)
        check(same, f"grouped {label} {opts}: schedule")
        check(rel <= 1e-5, f"grouped {label} {opts}: energy rel err {rel}")
        worst = max(worst, rel)
    print(f"phase 4 grouped: {len(grouped_runs)} labels and "
          f"{len(GROUPED_OPTIONS)} pack/partition/merge_bursts runs on "
          f"curie_platform(280), {len(wl)} replayed jobs, on cuda == oracle "
          f"(schedule exact, energy rel err <= {worst:.2e}), occupancy kernel "
          f"launches == n_batches, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    worst = 0.0
    stacks = [(plat, "+Forecast", {"forecast_horizon": 1800})] + [
        (dvfs_platform_example(280), "+DVFS", {})]
    for splat, suffix, opts in stacks:
        for label in LABELS:
            base, pol = from_label(label + suffix)
            cfg = EngineConfig(base=base, policy=pol, timeout=1800, node_order="cheap",
                               grouped_tables=True, **opts)
            event_fuse.reset_launches()
            s = engine.simulate(splat, wl, cfg, device="cuda")
            check(event_fuse.LAUNCHES["event_fuse_occ"] == int(s.n_batches),
                  f"grouped {label}{suffix}: occupancy kernel launches")
            same, rel, _ = held_against_oracle(metrics, run_pydes, np, splat, wl, cfg, s)
            check(same, f"grouped {label}{suffix}: schedule")
            check(rel <= 1e-5, f"grouped {label}{suffix}: energy rel err {rel}")
            worst = max(worst, rel)
    print(f"phase 4 grouped rules 9-10: the {len(LABELS)} labels +Forecast (horizon "
          f"1800) on curie_platform(280) and +DVFS on dvfs_platform_example(280), "
          f"{len(wl)} replayed jobs, on cuda == oracle (schedule exact, energy and "
          f"mode energy rel err <= {worst:.2e}), occupancy kernel launches == "
          f"n_batches, in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. the main path at CEA-Curie scale, dense ----
    gcfg = dataclasses.replace(PRESETS["cea_curie"], n_jobs=1000)
    wl = generate_workload(gcfg)
    plat = PlatformSpec(nb_nodes=11200)
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    engine.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = engine.simulate(plat, wl, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    launches = dense_by_kernel = dict(event_fuse.LAUNCHES)
    syncs = engine.HOST_SYNCS
    n_batches = int(s.n_batches)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(n_batches > 0, "main path ran no batch")
    check(launches["event_fuse_ledger"] == n_batches,
          f"ledger kernel launches {launches} != n_batches {n_batches}")
    check(launches["event_fuse_occ"] == 0, "dense path launched the occ kernel")
    check(launches["event_fuse"] == 0, "dense path launched event_fuse")
    check(fa.LAUNCHES["flash_attention"] == 0, "dense path launched flash_attention")
    check(ssd.LAUNCHES["ssd_scan"] == 0, "dense path launched ssd_scan")
    draw_launches = launches["event_fuse"]
    check(not bool(s.truncated), "main path hit its batch cap")
    t0 = time.perf_counter()
    same, rel, m = held_against_oracle(
        metrics, run_pydes, np, plat, wl, cfg, s)
    oracle_s = time.perf_counter() - t0
    check(same, "main path schedule == oracle")
    check(rel <= 1e-5, f"main path energy rel err {rel}")
    t0 = time.perf_counter()
    s2 = engine.simulate(plat, wl, cfg, device="cuda")
    wall_s = time.perf_counter() - t0
    check(metrics.np_state(s2)["job_start"].tolist()
          == metrics.np_state(s)["job_start"].tolist(), "rerun schedule")
    dense_launches = launches["event_fuse_ledger"]
    print(f"phase 5 main path: {plat.nb_nodes} nodes, cea_curie {len(wl)} jobs, EASY "
          f"PSUS timeout 1800 on cuda: n_batches {n_batches}, kernel "
          f"launches {dense_launches}, host syncs {syncs} "
          f"({syncs / n_batches:.3f}/batch), schedule == oracle, energy rel "
          f"err {rel:.2e}, makespan {m.makespan_s} s, total "
          f"{m.total_energy_j / 3.6e6:.1f} kWh; wall first run {first_s:.2f} "
          f"s, second run {wall_s:.2f} s = "
          f"{1e6 * wall_s / n_batches:.1f} us/batch; oracle {oracle_s:.2f} "
          f"s; peak device memory {peak_mib:.1f} MiB", flush=True)
    d_state = s  # phase 11's dense reference run

    # ---- 6. the main path at CEA-Curie scale, grouped ----
    plat = curie_platform(11200)
    wl = replay_workload(swf, nb_nodes=11200, oversize="clamp", max_jobs=1000)
    cfg = EngineConfig(base=base, policy=pol, timeout=1800, grouped_tables=True)
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    engine.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = engine.simulate(plat, wl, cfg, device="cuda")
    g_first_s = time.perf_counter() - t0
    launches = grouped_by_kernel = dict(event_fuse.LAUNCHES)
    g_syncs = engine.HOST_SYNCS
    g_batches = int(s.n_batches)
    g_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(g_batches > 0, "grouped main path ran no batch")
    check(launches["event_fuse_occ"] == g_batches,
          f"occ kernel launches {launches} != n_batches {g_batches}")
    check(launches["event_fuse_ledger"] == 0,
          "grouped path launched the ledger kernel")
    check(launches["event_fuse"] == 0, "grouped path launched event_fuse")
    check(fa.LAUNCHES["flash_attention"] == 0, "grouped path launched flash_attention")
    check(ssd.LAUNCHES["ssd_scan"] == 0, "grouped path launched ssd_scan")
    draw_launches += launches["event_fuse"]
    check(not bool(s.truncated), "grouped main path hit its batch cap")
    occ_launches = launches["event_fuse_occ"]
    t0 = time.perf_counter()
    s_dense = engine.simulate(
        plat, wl, dataclasses.replace(cfg, grouped_tables=False), device="cuda")
    dense_s = time.perf_counter() - t0
    check(np.array_equal(metrics.schedule_table(s),
                         metrics.schedule_table(s_dense)),
          "grouped schedule == dense port run's")
    d_g, d_d = metrics.np_state(s), metrics.np_state(s_dense)
    for fld in ("t", "n_batches", "node_state", "job_finish", "n_switch_on",
                "n_switch_off"):
        check(np.array_equal(d_g[fld], d_d[fld]), f"grouped {fld} == dense")
    e_rel = float(np.max(np.abs(d_g["energy"] - d_d["energy"])
                         / np.maximum(np.abs(d_d["energy"]), 1e-30)))
    check(np.allclose(d_g["energy"], d_d["energy"], rtol=1e-6, atol=0.0),
          f"grouped energy == dense to rtol 1e-6 (max rel {e_rel:.2e})")
    t0 = time.perf_counter()
    same, rel, m = held_against_oracle(
        metrics, run_pydes, np, plat, wl, cfg, s)
    g_oracle_s = time.perf_counter() - t0
    check(same, "grouped main path schedule == oracle")
    check(rel <= 1e-5, f"grouped main path energy rel err {rel}")
    t0 = time.perf_counter()
    s2 = engine.simulate(plat, wl, cfg, device="cuda")
    g_wall_s = time.perf_counter() - t0
    check(np.array_equal(metrics.schedule_table(s2), metrics.schedule_table(s)),
          "grouped rerun schedule")
    g_state, g_metrics, g_cfg = s, m, cfg  # phase 10's reactive base
    print(f"phase 6 grouped main path: curie_platform({plat.nb_nodes}) "
          f"(G={plat.n_groups()}), {len(wl)} jobs replayed from the synthesized "
          f"Curie SWF, EASY PSUS timeout 1800, grouped tables, on cuda: "
          f"n_batches {g_batches}, occ kernel launches {occ_launches}, host "
          f"syncs {g_syncs} ({g_syncs / g_batches:.3f}/batch), schedule == "
          f"oracle (energy rel err {rel:.2e}) == dense port run (energy max "
          f"rel diff {e_rel:.2e}), makespan {m.makespan_s} s, total "
          f"{m.total_energy_j / 3.6e6:.1f} kWh; wall first run {g_first_s:.2f} "
          f"s, second run {g_wall_s:.2f} s = {1e6 * g_wall_s / g_batches:.1f} "
          f"us/batch; dense port run of the same inputs {dense_s:.2f} s = "
          f"{1e6 * dense_s / int(s_dense.n_batches):.1f} us/batch; oracle "
          f"{g_oracle_s:.2f} s; peak device memory {g_peak_mib:.1f} MiB",
          flush=True)

    # ---- 7. the command line on the card ----
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.sim",
               "--workload", "preset:fig3_small", "--platform", "16",
               "--scheduler", "EASY PSUS", "--timeout", "900", "--out", out]
        env = dict(os.environ, PYTHONPATH=SRC)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        check(res.returncode == 0, f"driver failed:\n{res.stderr[-4000:]}")
        wrote = sorted(os.listdir(out))
        try:
            import matplotlib  # noqa: F401  (the driver draws the PNG with it)
            want = ["gantt.csv", "gantt.png", "jobs.csv", "metrics.json"]
        except ImportError:
            want = ["gantt.csv", "jobs.csv", "metrics.json"]
        check(wrote == want, f"driver outputs {wrote}, expected {want}")
        with open(os.path.join(out, "metrics.json")) as f:
            row = json.load(f)
        check(row["n_jobs"] == 200 and row["makespan_s"] > 0,
              "driver metrics")
    print(f"phase 7 command line: python -m repro_torch.launch.sim wrote "
          f"{wrote} in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 8. LM serve on the card ----
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    t8 = time.perf_counter()
    lm = get_arch(ARCH)
    stats = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    result = serve.main(SERVE_ARGS, stats=stats)
    flash_launches = fa.LAUNCHES["flash_attention"]
    flash_routes = dict(fa.LAUNCHES)
    serve_events = dict(event_fuse.LAUNCHES)
    check(ssd.LAUNCHES["ssd_scan"] == 0, "internlm2 serve launched ssd_scan")
    serve_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_req, max_new = 16, 32
    check(flash_launches == n_req * lm.n_layers,
          f"serve: flash_attention launches {flash_launches} != "
          f"{n_req} requests x {lm.n_layers} layers")
    check(flash_routes["flash_attention_wgmma"] == flash_launches
          and flash_routes["flash_attention_simt"] == 0,
          f"serve: prefill flash launches by variant {flash_routes}, all wgmma expected")
    check(not any(serve_events.values()), f"serve launched {serve_events}")
    check((result["requests"], result["decode_steps"], result["total_tokens"])
          == (n_req, 4 * (max_new - 1), n_req * max_new),
          f"serve counts {result}")
    toks = [t for ts in stats["tokens"].values() for t in ts]
    check(len(toks) == n_req * max_new and all(0 <= t < lm.padded_vocab for t in toks),
          "serve tokens")
    pre_ms = [1e3 * x for x in stats["prefill_s"]]
    dec_ms = [1e3 * x for x in stats["decode_s"]]
    print(f"phase 8 serve: {ARCH} full width bf16 on cuda, 16 requests x 1024 "
          f"tokens, 4 slots, 32 new tokens, cache 1280, per-slot positions: "
          f"{result}; flash_attention "
          f"launches {flash_launches} (= 16 x {lm.n_layers} layers), all on the wgmma "
          f"kernel ({flash_routes}); prefill "
          f"first {pre_ms[0]:.2f} ms, median of the rest "
          f"{statistics.median(pre_ms[1:]):.2f} ms per request; decode median "
          f"{statistics.median(dec_ms):.3f} ms, mean {statistics.fmean(dec_ms):.3f} "
          f"ms per step ({len(dec_ms)} steps); peak device memory "
          f"{serve_peak_gib:.2f} GiB", flush=True)

    # the same loop on the reference's shared counter: the refill check's
    # control, and the flag's cost, in the same call
    shared_stats = {}
    shared = serve.main([x for x in SERVE_ARGS if x != "--per-slot-positions"],
                        stats=shared_stats)
    check((shared["requests"], shared["decode_steps"], shared["total_tokens"])
          == (result["requests"], result["decode_steps"], result["total_tokens"]),
          f"shared-counter serve counts {shared}")
    shared_dec_ms = [1e3 * x for x in shared_stats["decode_s"]]
    print(f"phase 8 serve: the same loop on the shared counter (no "
          f"--per-slot-positions): {shared}; decode median "
          f"{statistics.median(shared_dec_ms):.3f} ms per step", flush=True)

    # refilled requests against their own prefill + decode, one sequence at a
    # time, on serve's weights and prompts (teacher-forced with the served
    # tokens, so one token within tolerance does not derail the rest)
    model = build_model(lm, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    prompt_rng = np.random.default_rng(0)
    queue = [prompt_rng.integers(0, lm.vocab_size, size=1024) for _ in range(n_req)]

    def refill_gaps(tokens):
        """(each token's gap below its own decode's greedy maximum over the
        largest |logit|, the count of tokens that are that maximum) of the
        refilled requests' ``tokens``."""
        gaps, exact = [], 0
        with torch.inference_mode():
            for rid in REFILLED:
                served = tokens[rid]
                logits, one = model.prefill(torch.from_numpy(queue[rid][None]).cuda(),
                                            cache_len=1280)
                for i, tok in enumerate(served):
                    ref = logits[0, -1].float()
                    gaps.append(float(ref.max() - ref[tok]) / float(ref.abs().max()))
                    exact += int(ref.argmax()) == tok
                    if i + 1 < len(served):
                        logits, one = model.decode_step(
                            torch.tensor([[tok]], device="cuda"), one, 1024 + i)
        return gaps, exact

    sound, sound_exact = refill_gaps(stats["tokens"])
    fault, fault_exact = refill_gaps(shared_stats["tokens"])
    print(f"phase 8 serve: refilled requests {REFILLED} against their own "
          f"single-sequence prefill + decode, teacher-forced, gaps below the "
          f"greedy maximum over the largest |logit|: per-slot positions "
          f"{sound_exact} of {len(sound)} tokens the maximum, largest gap "
          f"{max(sound):.4g}; shared counter (the control) {fault_exact} of "
          f"{len(fault)}, largest gap {max(fault):.4g}; tolerance {REFILL_TOL}",
          flush=True)
    check(max(sound) <= REFILL_TOL,
          f"serve: a refilled request's token is {max(sound):.4g} of the largest "
          f"|logit| below its own decode's maximum (tolerance {REFILL_TOL})")
    check(max(fault) > REFILL_TOL,
          f"serve: the shared counter's refilled tokens are at most {max(fault):.4g} "
          f"of the largest |logit| below their own decode's maximum, within the "
          f"tolerance {REFILL_TOL}: the check would not catch the wrong position")

    # one prefill of the serve path, profiled: flash kernel against matmuls
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, lm.vocab_size, (1, 1024))).cuda()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(2):
            model.prefill(prompt, cache_len=1280)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model.prefill(prompt, cache_len=1280)
            torch.cuda.synchronize()
            prefill_wall = time.perf_counter() - t0
    by_class, by_name = {"flash": 0.0, "matmul": 0.0, "other": 0.0}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_class[kernel_class(e.name)] += e.device_time_total / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    dev_total = sum(by_class.values())
    check(by_class["flash"] > 0 and by_class["matmul"] > 0,
          f"profiled prefill: device ms by class {by_class}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"phase 8 serve: one bf16 prefill (1 x 1024 tokens) profiled: wall "
          f"{1e3 * prefill_wall:.2f} ms, {top_level_ops(torch, prof)} top-level "
          f"host ops, device {dev_total:.3f} ms (busy "
          f"{100 * dev_total / (1e3 * prefill_wall):.1f} %); flash kernel "
          f"{by_class['flash']:.3f} ms ({100 * by_class['flash'] / dev_total:.1f} %), "
          f"matmuls {by_class['matmul']:.3f} ms "
          f"({100 * by_class['matmul'] / dev_total:.1f} %), other "
          f"{by_class['other']:.3f} ms; top kernels: "
          + "; ".join(f"{n[:50]} {ms:.3f} ms" for n, ms in top), flush=True)
    # one decode step of the 4-slot batch at position 1100, as serve runs it
    # with the flag ([4] positions) and without it (an int), each profiled,
    # then timed in turns: int, [4], [4], int, each the mean of 10 steps
    cache = model.init_cache(4, 1280)
    step_tok = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    step_pos = {"int": 1100, "[4]": torch.full((4,), 1100, dtype=torch.int64,
                                               device="cuda")}

    def decode_steps(pos, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(step_tok, cache, pos)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    step_prof = {}
    with torch.inference_mode():
        for key, pos in step_pos.items():
            decode_steps(pos, 2)
            with torch.profiler.profile(activities=acts) as dprof:
                wall = decode_steps(pos, 1)
            dev = [e.device_time_total / 1e3 for e in dprof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            step_prof[key] = (wall, top_level_ops(torch, dprof), len(dev), sum(dev))
        turns = [(key, decode_steps(step_pos[key], 10))
                 for key in ("int", "[4]", "[4]", "int")]
    del cache
    for key, (wall, ops, n_dev, dev_ms) in step_prof.items():
        print(f"phase 8 serve: one bf16 decode step (4 slots, position 1100 as "
              f"{key}) profiled: wall {wall:.2f} ms, {ops} top-level host ops, "
              f"{n_dev} device ops, device {dev_ms:.3f} ms (busy "
              f"{100 * dev_ms / wall:.1f} %)", flush=True)
    print("phase 8 serve: bf16 decode step in turns, ms a step (mean of 10): "
          + ", ".join(f"{key} {ms:.3f}" for key, ms in turns), flush=True)
    del model
    torch.cuda.empty_cache()

    # the kernel route against the plain route, full width, f32
    model = build_model(lm.replace(dtype_name="float32"), "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, lm.vocab_size, (2, 1024))).cuda()
    with torch.inference_mode():
        fa.reset_launches()
        model.attn_impl = "auto"
        logits_k, _ = model.prefill(prompts)
        torch.cuda.synchronize()
        check(fa.LAUNCHES["flash_attention"] == fa.LAUNCHES["flash_attention_simt"]
              == lm.n_layers, f"f32 prefill: flash launches {fa.LAUNCHES}, "
              f"{lm.n_layers} on the SIMT kernel expected")
        model.attn_impl = "naive"
        logits_p, _ = model.prefill(prompts)
        check(fa.LAUNCHES["flash_attention"] == lm.n_layers,
              "the plain route launched the kernel")
    logits_k, logits_p = logits_k[:, -1], logits_p[:, -1]
    scale = float(logits_p.abs().max())
    diff = float((logits_k - logits_p).abs().max())
    check(bool(torch.isfinite(logits_k).all()) and logits_k.shape == (2, lm.padded_vocab),
          "f32 kernel-route logits finite, [2, V]")
    check(diff <= LOGITS_REL_TOL * max(scale, 1.0),
          f"f32 logits: kernel route vs plain route max abs diff {diff} > "
          f"{LOGITS_REL_TOL} x {scale}")
    tok_k = logits_k.argmax(-1).tolist()
    tok_p = logits_p.argmax(-1).tolist()
    top2 = logits_p.topk(2, dim=-1).values
    for i in range(2):  # a greedy token may differ only inside the error
        margin = float(top2[i, 0] - top2[i, 1])
        check(tok_k[i] == tok_p[i] or margin <= 2 * diff,
              f"f32 greedy token {i}: kernel {tok_k[i]} vs plain {tok_p[i]}")
    del model
    torch.cuda.empty_cache()
    print(f"phase 8 serve: f32 full width, 2 x 1024-token prompts, prefill by "
          f"the kernel route ({lm.n_layers} SIMT launches) vs the plain route: "
          f"last-position logits max abs diff {diff:.3g} (largest |logit| "
          f"{scale:.3g}, tolerance {LOGITS_REL_TOL} of it); greedy first "
          f"tokens kernel {tok_k}, plain {tok_p}; phase wall "
          f"{time.perf_counter() - t8:.1f} s", flush=True)

    # ---- 9. xLSTM serve on the card ----
    t9 = time.perf_counter()
    xl = get_arch(XARCH)
    n_pairs = xl.block_program()[0][1]  # one stage of xlstm_pair blocks
    stats = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    xresult = serve.main(XSERVE_ARGS, stats=stats)
    ssd_launches = ssd.LAUNCHES["ssd_scan"]
    others = dict(event_fuse.LAUNCHES, flash_attention=fa.LAUNCHES["flash_attention"])
    x_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(ssd_launches == n_req * n_pairs * 2,
          f"xlstm serve: ssd_scan launches {ssd_launches} != {n_req} requests x "
          f"{n_pairs} pairs x 2")
    check(not any(others.values()), f"xlstm serve launched {others}")
    check((xresult["requests"], xresult["decode_steps"], xresult["total_tokens"])
          == (n_req, 4 * (max_new - 1), n_req * max_new), f"xlstm serve counts {xresult}")
    toks = [t for ts in stats["tokens"].values() for t in ts]
    check(len(toks) == n_req * max_new and all(0 <= t < xl.padded_vocab for t in toks),
          "xlstm serve tokens")
    x_pre = [1e3 * x for x in stats["prefill_s"]]
    x_dec = [1e3 * x for x in stats["decode_s"]]
    print(f"phase 9 serve: {XARCH} full width bf16 on cuda, 16 requests x 1024 "
          f"tokens, 4 slots, 32 new tokens: {xresult}; ssd_scan calls "
          f"{ssd_launches} (= 16 x {n_pairs} pairs x 2, {ssd.KERNELS_PER_CALL} launches "
          f"each), no other kernel; prefill "
          f"first {x_pre[0]:.2f} ms, median of the rest "
          f"{statistics.median(x_pre[1:]):.2f} ms per request; decode median "
          f"{statistics.median(x_dec):.3f} ms, mean {statistics.fmean(x_dec):.3f} ms "
          f"per step ({len(x_dec)} steps); peak device memory {x_peak_gib:.2f} GiB",
          flush=True)

    # one xlstm_pair block at S 1024 (a whole prefill is 12 such blocks):
    # its wall, and its mLSTM's and its sLSTM's, unprofiled; then the mLSTM
    # and the sLSTM each profiled over repeated calls, because a profile of
    # one short call has come back without the mLSTM's device records
    model = build_model(xl, "cuda").init(torch.Generator(device="cuda").manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, xl.vocab_size, (1, 1024))).cuda()
    block = model.blocks[0]
    with torch.inference_mode():
        x_emb = model._embed(prompt)
        layer = tuple(f[0] for f in model.init_cache(1, 1280))
    parts = {
        "block": lambda: block(x_emb, layer),
        "mlstm": lambda: block.mlstm(x_emb, layer[:2], block.chunk, block.eps),
        "slstm": lambda: block.slstm(x_emb, ssm.SLstmState(*layer[2:]), block.eps),
    }
    walls, split = {}, {}
    with torch.inference_mode():
        for part, fn in parts.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[part] = time.perf_counter() - t0
        split["slstm"] = profile_split(torch, parts["slstm"], calls=3)
        split["mlstm"] = profile_split(torch, parts["mlstm"], calls=100)
    mlk, slk = split["mlstm"][0], split["slstm"][0]
    check(split["mlstm"][3] == 2 * ssd.KERNELS_PER_CALL and mlk["matmul"] > 0,
          f"profiled mLSTM: {split['mlstm'][3]} ssd_scan launches a call "
          f"({2 * ssd.KERNELS_PER_CALL} expected), device ms by kind {mlk}")
    check(split["slstm"][3] == 0 and split["slstm"][2] >= prompt.shape[1],
          f"profiled sLSTM: {split['slstm'][2]} device ops a call, device ms {slk}")
    x_pre_med = statistics.median(x_pre[1:])
    slstm_share = n_pairs * 1e3 * walls["slstm"] / x_pre_med
    print(f"phase 9 serve: one bf16 xlstm_pair block (1 x 1024 tokens): wall "
          f"{1e3 * walls['block']:.2f} ms unprofiled; its mLSTM alone: wall "
          f"{1e3 * walls['mlstm']:.2f} ms, {split['mlstm'][1]:.0f} top-level host ops, "
          f"{split['mlstm'][2]} device ops, device {sum(mlk.values()):.3f} ms: ssd_scan "
          f"{mlk['ssd']:.3f} ms (2 calls, {2 * ssd.KERNELS_PER_CALL} launches), matmuls "
          f"{mlk['matmul']:.3f} ms, other "
          f"{mlk['other']:.3f} ms (a call of 100 profiled, records seen "
          f"{split['mlstm'][4]:.3f}); its sLSTM alone: wall "
          f"{1e3 * walls['slstm']:.2f} ms, {split['slstm'][1]:.0f} top-level host ops, "
          f"{split['slstm'][2]} device ops, device {sum(slk.values()):.3f} ms (matmuls "
          f"{slk['matmul']:.3f} ms, cell ops {slk['other']:.3f} ms; a call of 3 "
          f"profiled, records seen {split['slstm'][4]:.3f}); {n_pairs} sLSTMs are "
          f"{100 * slstm_share:.1f} % of the median prefill", flush=True)
    cache = model.init_cache(4, 1280)
    step_tok = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            model.decode_step(step_tok, cache, 1100)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as dprof:
            t0 = time.perf_counter()
            model.decode_step(step_tok, cache, 1100)
            torch.cuda.synchronize()
            decode_wall = time.perf_counter() - t0
    dec_dev = [e.device_time_total / 1e3 for e in dprof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"phase 9 serve: one bf16 decode step (4 slots) profiled: wall "
          f"{1e3 * decode_wall:.2f} ms, {top_level_ops(torch, dprof)} top-level host "
          f"ops, {len(dec_dev)} device ops, device {sum(dec_dev):.3f} ms (busy "
          f"{100 * sum(dec_dev) / (1e3 * decode_wall):.1f} %)", flush=True)
    del model, cache
    torch.cuda.empty_cache()

    # the kernel route against the plain route, full width, f32
    model = build_model(xl.replace(dtype_name="float32"), "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, xl.vocab_size, (2, 1024))).cuda()
    with torch.inference_mode():
        ssd.reset_launches()
        model.gla_impl = "auto"
        logits_k, _ = model.prefill(prompts)
        torch.cuda.synchronize()
        check(ssd.LAUNCHES["ssd_scan"] == 2 * n_pairs,
              f"f32 xlstm prefill: ssd_scan launches {ssd.LAUNCHES} != {2 * n_pairs}")
        model.gla_impl = "plain"
        logits_p, _ = model.prefill(prompts)
        check(ssd.LAUNCHES["ssd_scan"] == 2 * n_pairs, "the plain route launched the kernel")
    logits_k, logits_p = logits_k[:, -1], logits_p[:, -1]
    x_scale = float(logits_p.abs().max())
    x_diff = float((logits_k - logits_p).abs().max())
    check(bool(torch.isfinite(logits_k).all()) and logits_k.shape == (2, xl.padded_vocab),
          "f32 xlstm kernel-route logits finite, [2, V]")
    check(x_diff <= LOGITS_REL_TOL * max(x_scale, 1.0),
          f"f32 xlstm logits: kernel route vs plain route max abs diff {x_diff} > "
          f"{LOGITS_REL_TOL} x {x_scale}")
    xtok_k = logits_k.argmax(-1).tolist()
    xtok_p = logits_p.argmax(-1).tolist()
    top2 = logits_p.topk(2, dim=-1).values
    for i in range(2):  # a greedy token may differ only inside the error
        margin = float(top2[i, 0] - top2[i, 1])
        check(xtok_k[i] == xtok_p[i] or margin <= 2 * x_diff,
              f"f32 xlstm greedy token {i}: kernel {xtok_k[i]} vs plain {xtok_p[i]}")
    del model
    torch.cuda.empty_cache()
    print(f"phase 9 serve: f32 full width, 2 x 1024-token prompts, prefill by the "
          f"kernel route ({2 * n_pairs} launches) vs the plain route: last-position "
          f"logits max abs diff {x_diff:.3g} (largest |logit| {x_scale:.3g}, "
          f"tolerance {LOGITS_REL_TOL} of it); greedy first tokens kernel {xtok_k}, "
          f"plain {xtok_p}; phase wall {time.perf_counter() - t9:.1f} s", flush=True)

    # ---- 10. power rules 9-10 at Curie scale, grouped ----
    torch.cuda.empty_cache()
    fc_by_kernel, dv_by_kernel = phase10(torch, np, swf, g_state, g_metrics, g_cfg)

    # ---- 11. the batched sweep at Curie scale ----
    torch.cuda.empty_cache()
    sweep_dense, sweep_grouped = phase11(torch, np, swf, d_state, g_state)

    def entry(kname, replaces, launches, key, bound, note=None):
        k_ms, p_ms, host_ms_call, fill_host_ms = timing[key]
        b_ms, b_by = bound
        row = {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_fuse.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err[kname], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "host_ms": host_ms_call, "launch_floor_ms": floor_ms,
            "fill_host_ms": fill_host_ms,
        }
        if key in clusters:
            row.update(cluster=clusters[key], cluster_e8=clusters[kname, 8],
                       ms_e8=timing[kname, 8][0], cluster_e64=clusters[kname, 64],
                       ms_e64=timing[kname, 64][0])
        row["launches_by_path"] = {
            "phase 5 dense": dense_by_kernel[kname],
            "phase 6 grouped": grouped_by_kernel[kname],
            "phase 10 forecast": fc_by_kernel[kname],
            "phase 10 dvfs": dv_by_kernel[kname],
            "sweep_dense": sweep_dense if kname == "event_fuse_ledger" else 0,
            "sweep_grouped": sweep_grouped if kname == "event_fuse_occ" else 0,
        }
        if note:
            row["note"] = note
        return row

    print(json.dumps({"kernels": [
        entry("event_fuse_ledger", "src/repro/kernels/event_fuse.py:74",
              dense_launches, ("event_fuse_ledger", 1), ledger_bound(*MAIN_SHAPE)),
        entry("event_fuse_occ", "src/repro/kernels/event_fuse.py:113",
              occ_launches, ("event_fuse_occ", 1), occ_bound(*OCC_MAIN)),
        entry("event_fuse", "src/repro/kernels/event_fuse.py:47", draw_launches,
              ("event_fuse", 1), draw_bound(*MAIN_SHAPE),
              note="no engine path calls it; timed at [1, 11200]"),
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:45",
            "launches": flash_launches, "max_abs_err": flash_err,
            "ms": flash_time["bfloat16"][0], "plain_ms": flash_time["bfloat16"][1],
            "bound_ms": flash_time["bfloat16"][3],
            "bound_by": flash_time["bfloat16"][4],
            "library_ms": flash_time["bfloat16"][2],
            "simt_ms": flash_time["bfloat16"][5], "ms_f32": flash_time["float32"][0],
            "note": "timed at the serve prefill shape (B 1, S 1024, H 16, KH 8, "
                    "hd 128) in bf16, causal: ms is the wgmma kernel (every main-path "
                    "launch), simt_ms the SIMT kernel on the same inputs, ms_f32 the "
                    "SIMT kernel in f32; library: "
                    "scaled_dot_product_attention(is_causal, enable_gqa)",
        },
        {
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:44",
            "launches": ssd_launches, "max_abs_err": ssd_err,
            "ms": ssd_time[512][0], "plain_ms": ssd_time[512][1],
            "bound_ms": ssd_time[512][2], "bound_by": ssd_time[512][3],
            "library_ms": None,
            "ms_dv1": ssd_time[1][0], "plain_ms_dv1": ssd_time[1][1],
            "bound_ms_dv1": ssd_time[1][2], "bound_by_dv1": ssd_time[1][3],
            "note": "timed at the xLSTM serve prefill shape (B 1, S 1024, H 4, dk "
                    "512, chunk 128; q bf16, k f32, v bf16, zero h0) at dv 512 "
                    "(ms, plain_ms, bound_ms) and at the normaliser's dv 1 (*_dv1); "
                    "half the main path's calls are each; launches counts wrapper "
                    "calls, each three kernel launches (chunk, state and output "
                    "passes), and ms their sum; no PyTorch call computes a GLA scan",
        },
    ]}))
    print(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
