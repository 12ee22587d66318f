#!/usr/bin/env python3
"""Drive the PyTorch port of SPARS on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):

1. device: the card and its power limit (``nvidia-smi``); no CUDA, no run;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together), with the build seconds and
   the ptxas register, shared-memory and spill lines of every kernel
   variant (each event kernel, the 16 SIMT and 3 wgmma flash kernels, the
   6 ``ssd_scan`` pass kernels);
3. kernels: each event kernel against its plain PyTorch version on the
   card, bit for bit, at the engine's shapes and more (rows that start off a
   16-byte boundary, arrays at different alignments, G = 64 and
   ``MAX_GROUPS``, dead lanes, one table a row: ``[E, 5]`` watts and ``[E,
   N]`` group ids), with the allocator's free memory poisoned so an
   unwritten output cannot pass, and the cluster size of every held case;
   the ledger and occupancy kernels timed at E = 1, 8 and 64, the scalar
   draw at E = 1 and in turns with the ledger kernel (ledger, draw, draw,
   ledger), their cluster size at each timed shape, their ptxas lines, and
   the device time of a 1-element fill (the card's practical launch floor)
   beside theirs, and each wrapper's host time in turns with the fill's
   (fill, wrapper, wrapper, fill);
   ``flash_attention``
   against its plain version at the serve path's prefill shape in bf16 and
   f32 and at MQA, Sq > Sk, a ragged KV tail, non-causal Sk > Sq, a ragged
   Sq and head dims 64 and 16, and at hd 80 at a ragged Sq with GQA, a KV
   tail that is not a multiple of 64, non-causal Sk > Sq and GQA 4:1 (f32
   atol and rtol 2e-5, bf16 3e-2), each call on the variant that
   ``flash_attention.variant`` names (bf16 hd 64, 80 and 128 on the wgmma
   kernel, the rest on the SIMT kernel); the device time of each
   (``torch.profiler``: the kernels' own durations), the host time per call
   and the card's bound for the same work; for flash attention at the
   prefill shape and at hd 80 (stablelm-3b's) in bf16, in turns in one call,
   the SIMT kernel, the wgmma kernel, the wgmma kernel and the SIMT kernel
   on the same inputs, then the plain version and
   ``scaled_dot_product_attention``; flash attention held and timed the
   same way (the variant the table names, the plain version, SDPA, the
   bound and the host time) at phase 14's prefill shapes (``FLASH_NEW``:
   glm4-9b's GQA 16:1, qwen3-14b's 5:1, qwen2-moe-a2.7b's MHA and
   internvl2-26b's 6:1 in bf16, head dim 80 in bf16 and f32, whisper-tiny's
   causal decoder self attention, unmasked encoder, Sq = Sk = 1500, and
   cross attention, Sq 1024 over Sk 1500, at hd 64 in bf16);
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
   occupancy-kernel launch a batch (the 16-node runs on ``LABEL_JOBS`` (30)
   generated jobs, the grouped ones on the first ``PHASE4_GROUPED_JOBS`` (30)
   replayed jobs);
5. main path, dense: one simulation at CEA-Curie scale (11 200 nodes, the
   ``cea_curie`` workload, 1000 jobs, EASY PSUS, timeout 1800 s) — the
   ledger kernel must have launched once per event batch, and the schedule
   must equal the oracle's; a second run is timed;
6. main path, grouped: the first 1000 jobs of the synthesized Curie SWF
   trace replayed on the 3-group 11 200-node Curie platform, EASY PSUS,
   timeout 1800 s, grouped tables — the occupancy kernel must have launched
   once per event batch, and the schedule must equal the oracle's and a
   dense port run's of the same inputs; a second run is timed. The oracle
   of phases 5 and 6 is host work: two worker processes, started before
   phase 1, compute it while phases 1-4 run;
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
   bf16 at ``XPAIRS`` (4) of its 12 pairs — ``ssd_scan`` must have been
   called twice per ``xlstm_pair`` per request (128, each call three
   launches) and no other kernel; one
   ``xlstm_pair`` block at S 1024
   is timed, its mLSTM and its sLSTM are profiled, and so is one decode
   step; then, in f32 at the same 4 pairs,
   two 1024-token prompts go through ``prefill`` by the kernel route and
   by the plain route, whose last-position logits must agree;
10. power rules at Curie scale, grouped: EASY PSUS+Forecast (horizon
   1800 s) on the first ``FORECAST_JOBS`` (250) of phase 6's jobs (against
   phase 6's configuration on them), and EASY PSUS+DVFS on the DVFS
   platform at 11 200 nodes with phase 5's workload cut to ``DVFS_JOBS``
   (125) jobs (timeout 900 s, ``node_order=
   "cheap"``, ``terminate_overrun``) — the occupancy kernel must have
   launched once a batch and the schedule must equal the same run's on the
   plain per-node route (energy and mode ledgers to rel 1e-5); the Forecast
   run at horizon 0 must give phase 6's schedule and energy bit for bit;
   the Forecast run's first 100 batches are profiled (device ops a batch,
   device busy share; the DVFS run's and phase 6's windows are cut for
   time, to pay for phase 17);
11. the batched sweep at Curie scale (``repro_torch.core.sweep``):
   ``benchmarks/bench_scale.py``'s grid, ``("EASY PSUS", "FCFS PSAS+IPM")``
   x timeouts ``300 + 300 i``, on phase 5's inputs at E = 8 on their first
   ``SWEEP_JOBS`` (250) jobs and at E = 64 on ``SWEEP_E64_JOBS`` (125) — one
   ``event_fuse_ledger`` launch per loop iteration for the grid, at most
   two host syncs an iteration; (e) the
   grouped E = 8 grid (timeouts 600-2400) on the first 250 of phase 6's
   jobs with ``OPTIONS`` (``node_order="pack"``, ``allocation=
   "partition"``, ``merge_bursts``) — one ``event_fuse_occ`` launch an
   iteration; (f) a dense E = 4 grid (the two schedulers x 600 and 1800 s)
   with ``OPTIONS`` on phase 4's 280-node Curie platform and trace (the
   first ``GROUPED_JOBS``, 60, of its jobs). Held bit for bit
   against single runs of their scenarios on the same jobs (state, schedule
   table, every ``SimMetrics`` field), run in a worker process beside the
   grids: the E = 64 row EASY PSUS 1800 (phase 5's configuration), the E =
   8 row FCFS PSAS+IPM 600, (e)'s rows EASY PSUS 1800 and FCFS PSAS+IPM 600
   and every row of (f). Per grid the wall and
   the wall a scenario, iterations, µs and host syncs an iteration (the
   loop's, the passes' windows, the partition head outcomes and the merge
   repeat conditions counted apart), the first 100 iterations of the dense
   grids profiled (device ops an iteration, busy share) and peak device
   memory. No sweep row runs the oracle on the card: the CPU tests hold
   rows against it and against the JAX sweep;
12. the RL stack (``repro_torch.core.rl``): (a) 16 envs of the grouped
   Curie platform (11 200 nodes), each on one of 16 consecutive 500-job
   windows of phase 6's trace, EASY RL:groups at a 600 s decision interval,
   256 batched steps of fixed actions ``(3t + b) mod n_actions`` — one
   ``event_fuse_occ`` launch a step, at most two host syncs a step, every
   row's state and per-step observations, rewards and done equal to the same
   steps on the plain per-node route (``fused_kernel=False``), rows 0 and 15
   equal to their own ``HPCGymEnv`` episodes bit for bit (state,
   observations, rewards), ms a step, env steps/s, the busy share of the
   first 100 steps and peak memory; (b) eight A2C updates on that batch
   (16 envs, 16 steps): finite losses, entropy above 0, parameters moved;
   (c) ``benchmarks/bench_rl.py``'s configuration (256 envs, 64 nodes, 64
   jobs, EASY RL) for 64 batched steps with one ``event_fuse_ledger`` launch
   each, every row equal to the plain per-node route's as in (a), then one
   A2C and one PPO update; (d) (b)'s policy saved with
   ``save_policy`` and run by ``python -m repro_torch.launch.sim`` (EASY
   RL:groups) on phase 4's 280-node Curie inputs, equal to the plain
   per-node route bit for bit with one ``event_fuse_occ`` launch a batch;
   (e) a sweep of EASY DVFS, EASY PSUS+DVFS and EASY RL on phase 4's
   280-node DVFS inputs, each row equal to its single run bit for bit;
13. the experiment layer and the service (``repro_torch.experiments``,
   ``repro_torch.launch.sim_serve``): (a) ``benchmarks/bench_energy.py``'s
   Figs. 4/5 grid (the ``nasa_ipsc`` preset at 400 jobs on its 128 nodes,
   the six timeout schedulers x 300/900/1800/3600 s, E = 24) through
   ``experiments.run`` with ``out`` set — one ``event_fuse_ledger`` launch
   an iteration and no other kernel, at most two host syncs an iteration,
   the four rows the oracle holds equal to their single runs bit for bit
   and to the oracle (schedule exact, energy rel 1e-5; the oracle runs in
   the worker processes; the single runs of the other two schedulers and
   a streamed rerun are cut for time: (c) streams chunks through the
   service); (b) ``benchmarks/bench_forecast.py``'s
   grid (EASY PSUS, EASY PSUS+Forecast, EASY RL:groups x timeout 1800 x
   forecasts 0 and 1800 on ``curie_platform(280)``, the first 200 jobs of a
   2000-line synthesized Curie SWF, ``node_order="cheap"``, a random-init
   group policy saved by ``save_policy``) on grouped tables — one
   ``event_fuse_occ`` launch an iteration, every row equal to its single
   run (the RL rows with the same controller; a label without rule 10
   reads no horizon, so its two rows share one single run), the horizon-0
   identity; (c)
   five requests to one ``SimService`` (chunks of 4): the reference smoke's
   two same-shaped requests (the second all cache hits), a ``profiles``
   request, ``bench_scale.py``'s Curie grid at phase 11's depth (E = 8, each
   row equal to phase 11's dense E = 8 row bit for bit) and a request whose
   workload does not exist (an error response while the others finish);
14. dense, hybrid, MoE, VLM and encoder-decoder archs:
   ``repro_torch.launch.serve --per-slot-positions`` serves glm4-9b,
   stablelm-3b, qwen3-14b, zamba2-2.7b, qwen2-moe-a2.7b, internvl2-26b (at
   ``INTERNVL_LAYERS``, 12 of its 48 layers, a cut for time) and
   whisper-tiny at full width and depth in bf16 (random weights from seed
   0; 8 requests of 1024 tokens, 4 slots, 32 new tokens, cache 1280; zero
   image embeds and encoder frames, as the reference's loop), one model at
   a time — each must launch flash attention once per attention per
   request, all on the variant ``ARCHS14`` names (320 wgmma, 256 wgmma, 320
   wgmma, 72 wgmma: 9 shared-attention applications, 192 wgmma, 192 wgmma,
   96 wgmma: 4 encoder, 4 self and 4 cross attentions), zamba2 ``ssd_scan``
   once per Mamba-2 layer per request (432), the others none, no event
   kernel; the refilled requests 4 and 7 are held against their own decode
   within ``REFILL_TOL`` (single-sequence; the MoE's at the serve's batch
   shape of 4 rows, since a bf16 routing choice tips between batch shapes,
   with their single-sequence gaps printed, not held); tokens/s, TTFT,
   prefill and decode ms, the weights' GB and peak memory are printed, and
   one decode step of the 4 slots (and zamba2's prefill) profiled; then, in
   f32 at full width and cut depth (2 layers, one super-block of 6 Mamba-2
   layers and the shared block, or 2 encoder and 2 decoder layers), two
   1024-token prompts (with seeded image embeds or frames) go through
   ``prefill`` by the kernel route and by the plain route
   (``attn_impl="naive"``, ``gla_impl="plain"``): last-position logits
   within ``LOGITS_REL_TOL``, the same greedy tokens, and for the MoE the
   smallest router margin seen.
15. LM training (``repro_torch.training.train_step``, on the plain routes):
   (a) the full-width internlm2-1.8b in bf16 (24 layers, d 2048, remat as
   configured) through ``make_train_step`` with ``make_optimizer("adamw",
   cosine_schedule(3e-4, 2, 8))`` for ``TRAIN_STEPS`` (8) steps on
   ``TokenStream`` batches of 4 x 1024 tokens: losses and gradient norms
   finite, parameters moved, no flash attention or ``ssd_scan`` launch
   during the steps; the median ms a step over steps 2-8, tokens/s, peak
   memory, the ms of stacking the parameters into the reference's leaves
   and of writing them back, and one more step profiled (host ops, device
   ms, busy share, device time split into matmuls and the rest); (b) the
   flash wrapper refuses CUDA inputs that require grad; (c) the reduced
   internlm2 in f32 from one set of weights and batches: 3 SGD and 3 AdamW
   steps on the card against the same steps on the CPU (losses within
   ``TRAIN_REL`` relative, the SGD leaves within ``TRAIN_REL`` of each
   leaf's largest entry); (d) ``python -m repro_torch.launch.train --arch
   internlm2-1.8b --reduced --steps 20 --batch 2 --seq 32 --ckpt-every 5``:
   with ``--fail-at 12``, in a subprocess, it exits 17; the rerun (the
   launcher's ``main`` in this process, as is the uninterrupted run beside
   the crashing one) resumes from step 10 and runs 10 steps, and its last
   loss is within ``TRAIN_REL`` of an uninterrupted run's (the card's
   embedding backward adds with atomics, in any order).
16. mixed block programs and the legacy loop: (a) zamba2-2.7b's width with
   ``stages=MIXED16`` (6 Mamba-2 layers, then 2 dense ones) served in bf16
   (seed-0 weights; 6 requests of 1024 tokens on 4 slots, 16 new tokens,
   cache 1056, per-slot positions) — ``ssd_scan`` once per Mamba-2 layer
   and the wgmma flash kernel once per dense layer per request (36, 12), the
   refilled requests 4 and 5 against their own decode at the serve's batch
   shape (4 rows) — and ``MIXED16_F32`` in f32 on the kernel routes against
   the plain routes (last-position logits within ``LOGITS_REL_TOL``, the
   same greedy tokens); (b) xlstm-350m's width with ``stages=RECURRENT16``
   (two standalone mLSTM stages' blocks, then an sLSTM one; 4 requests of
   1024 tokens on 4 slots, 8 new tokens) — ``ssd_scan`` twice per mLSTM
   block per request (16), no flash — and ``RECURRENT16_F32`` the same way
   in f32; (c) ``fused_events=False``: phase 4's seven labels on the 16-node
   homogeneous and mixed platforms and on ``curie_platform(280)`` (grouped)
   rerun on the legacy loop, each equal to its fused run bit for bit (every
   state field, the schedule table, ``SimMetrics``) and to the oracle; a
   dense E = 4 grid (``LEGACY_GRID``) on 280 nodes and the grouped B = 2
   env for 16 steps on ``curie_platform(280)``, legacy equal to fused; no
   event-kernel launch on any legacy run; the grouped 280-node EASY PSUS
   run timed on both loops in turns (µs and host syncs a batch).
17. sharded sweeps and data-parallel rollouts, one worker process per card
   (``repro_torch.core.shard``): (a) phase 11's dense E = 8 grid at
   ``devices=1``, on one worker; (b) the same grid on two workers pinned to
   card 0 (``shard.pinned_cards([0, 0])``), each row of both bit for bit
   phase 11's, one ``event_fuse_ledger`` launch an iteration of each block
   (the workers' counts reach this process); (c) ``SHARD_UPDATES`` (2) A2C
   updates of phase 12 (a)'s grouped batch (16 envs) on two workers on
   card 0, the parameters within ``SHARD_TOL`` (1e-6) of the same updates
   run in this process (each block with its own generator, the mean of the
   two blocks' gradients, one clip and one AdamW step), the losses finite,
   one ``event_fuse_occ`` launch a step a worker; (d) with two cards or
   more, (a) at D = the card count, one worker a card. The two workers
   start beside phase 16 (``start_workers``); the phase prints their
   start-up seconds, and each part its checks, wall and cards.
18. the dry run's count on the card (``repro_torch.launch.dryrun``), after
   phase 15: (a) one more of phase 15's training steps, counted by the dry
   run's ``count`` on the card, against ``lower_cell`` at phase 15's shape
   (internlm2-1.8b, 4 x 1024, bf16, remat, AdamW) on fake tensors:
   ``flops_computed`` equal exactly (shapes alone decide it); the step's
   median ms (phase 15) against the cell's ``roofline_step_s`` (its share
   of the roofline, against the H100 SXM data-sheet peaks) and
   ``args_bytes_per_device`` against phase 15's peak device memory, with
   the card's name and power limit; (b) ``lower_spars_rl`` (one A2C update
   of the reference's 64-node setting at 4096 envs) on the card: ``ok``,
   FLOPs above 0, its wall and its event-kernel launches (the kernels
   line's ``phase 18 spars-rl``).
19. the pipeline and elastic resharding (``repro_torch.training``) on
   phase 17's two workers on card 0, after phase 17: (a) ``pipeline``'s
   GPipe over ``internlm2-1.8b``'s full-width trunk (24 dense layers, bf16,
   seeded weights) in 2 stages of 12, 8 microbatches of ``[2, 1024,
   2048]``: each stage's weights placed in its worker once (timed apart),
   the output bit for bit the same layers run in this process one
   microbatch at a time, 192 ``flash_attention`` launches (24 x 8) on the
   wgmma kernel counted from the workers (the kernels line's ``phase 19
   pipeline``) and 192 in this process; both walls, run twice in turns,
   and the bubble ``(S-1)/(M+S-1)``; (b) ``elastic``: phase 12 (a)'s
   grouped 16-env batch state resharded onto 2 workers, 1 and 2 again and
   gathered back bit for bit, shrunk to 12 envs and grown to 16, then one
   batched step: one ``event_fuse_occ`` launch (``phase 19 elastic``),
   rows 12-15 equal to rows 0-3, whose copies they are, bit for bit.
20. tensor parallelism (``repro_torch.training.tensor_parallel``) on the
   same two workers on card 0, after phase 19: a (data, model) = (1, 2)
   grid of ``internlm2-1.8b`` at full width (bf16, remat) with ``gloo``,
   each rank drawing the model from seed 0 and keeping its half; each
   rank's bf16 and f32 sum and max over the model group checked; (b) the
   grid's prefill of one 1024-token prompt on the kernel routes, 24 wgmma
   flash launches a rank at H 8, KH 4, hd 128 (the kernels line's ``phase
   20 tp prefill``), its last-position logits within ``TP_LOGITS_REL`` of
   one process's; (a) 3 AdamW steps on phase 15's batches, each loss within
   ``TP_LOSS_TOL`` of phase 15's, with ms a step, ms in all-reduces a
   step (the last step timed around each, so that step carries the
   barriers), each rank's peak memory and the backend.

Phase 3 also holds ``ssd_scan`` against its plain version at the xLSTM
serve shapes (dv 512 and the normaliser's dv 1) in the mLSTM's mixed
dtypes and in f32, at zamba2's Mamba-2 shape (``SSD_MAMBA``: H 80, dk = dv
= 64, q a stride-0 view of C over the heads) in the same dtypes and in
f32, at a ragged S, from a non-zero state and at the
reference's kernel-test shapes (f32: 1e-4 of max |y|; bf16 y: one bf16 ulp
of the element plus 1e-5 of max |y|), checks that a second run is bit for
bit the first and that the built library's launch plan is
``ssd_scan.launch_plan``'s, and times its three passes at the two xLSTM
shapes and the Mamba-2 one.

Then it prints the kernels' JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It imports
the port (``src/repro_torch``), torch and numpy — nothing of JAX and nothing
of the JAX reference package.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

from repro_torch.launch import mesh  # noqa: E402  (the card's data-sheet peaks)

HBM_BYTES_PER_S = mesh.HBM_BW  # H100 SXM device memory rate
# the event kernels' work is int32 compares and adds outside the tensor
# cores; the closest published scalar peak is the 67 TFLOP/s of float32
SCALAR_OPS_PER_S = mesh.PEAK_FLOPS_F32
# H100 SXM dense bf16 tensor-core peak: flash attention's bound
TENSOR_BF16_FLOPS_PER_S = mesh.PEAK_FLOPS_BF16
ARCH = "internlm2-1.8b"
# (B, Sq, Sk, H, KH, hd, causal): the serve path's prefill shape first
FLASH_MAIN = (1, 1024, 1024, 16, 8, 128, True)
# phase 14's prefill shapes: glm4-9b's GQA 16:1 and qwen3-14b's 5:1 (wgmma
# in bf16), head dim 80 (stablelm-3b, and zamba2-2.7b's shared attention;
# wgmma in bf16, SIMT in f32), qwen2-moe-a2.7b's MHA and internvl2-26b's
# 6:1 (wgmma), and whisper-tiny's causal decoder self attention, unmasked
# encoder (Sq = Sk = 1500) and cross attention (Sq 1024 over the 1500
# frames) at hd 64 (wgmma; 1500 = 23 x 64 + 28)
FLASH_NEW = {
    "glm4-9b": (1, 1024, 1024, 32, 2, 128, True),
    "qwen3-14b": (1, 1024, 1024, 40, 8, 128, True),
    "hd 80": (1, 1024, 1024, 32, 32, 80, True),
    "qwen2-moe-a2.7b": (1, 1024, 1024, 16, 16, 128, True),
    "internvl2-26b": (1, 1024, 1024, 48, 8, 128, True),
    "whisper decoder": (1, 1024, 1024, 6, 6, 64, True),
    "whisper encoder": (1, 1500, 1500, 6, 6, 64, False),
    "whisper cross": (1, 1024, 1500, 6, 6, 64, False),
}
FLASH_SHAPES = [
    FLASH_MAIN,
    *FLASH_NEW.values(),
    (1, 256, 256, 8, 1, 128, True),    # MQA
    (1, 384, 256, 2, 2, 128, True),    # Sq > Sk
    (1, 128, 320, 4, 2, 64, True),     # KV tail not a tile multiple
    (2, 128, 384, 4, 4, 64, False),    # non-causal, Sk > Sq
    (1, 100, 100, 2, 2, 64, True),     # ragged Sq
    (1, 64, 64, 4, 2, 16, True),       # hd 16
    (2, 256, 256, 4, 2, 64, True),
    (1, 100, 100, 4, 2, 80, True),     # hd 80: ragged Sq, GQA
    (1, 128, 200, 4, 4, 80, True),     # hd 80: KV tail not a tile multiple
    (2, 96, 320, 4, 4, 80, False),     # hd 80: non-causal, Sk > Sq
    (1, 256, 256, 8, 2, 80, True),     # hd 80: GQA 4:1
]
FLASH_HD80 = FLASH_NEW["hd 80"]  # timed in turns on both kernels, as FLASH_MAIN
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # atol and rtol, as the tests
SERVE_ARGS = ["--arch", ARCH, "--requests", "16", "--slots", "4",
              "--prompt-len", "1024", "--max-new", "32", "--cache-len", "1280",
              "--device", "cuda", "--per-slot-positions"]
XARCH = "xlstm-350m"
XSERVE_ARGS = ["--arch", XARCH] + SERVE_ARGS[2:]
# phase 9 serves and checks the xLSTM at full width and 4 of its 12 pairs
# (a cut for time)
XPAIRS = 4
# phase 14: the dense, hybrid, MoE, VLM and encoder-decoder archs at full
# width, 8 requests of 1024 tokens on 4 slots (requests 4-7 each refill a
# freed slot); per arch the flash launches of the serve (one per attention
# a prefill: a layer's, a super-block's shared block's, or whisper's
# encoder, self and cross attention) and their variant, its ssd_scan
# calls, the depth of its f32 kernel-route check (2 layers, or one
# super-block of 6 Mamba-2 layers and the shared block, or 2 encoder and 2
# decoder layers) and its serve depth (None: the full depth)
# a cut for time: internvl2-26b serves 12 of its 48 layers (24 to PR 30;
# phase 20 pays for it)
INTERNVL_LAYERS = 12
ARCHS14 = {
    "glm4-9b": (320, "wgmma", 0, 2, None),
    "stablelm-3b": (256, "wgmma", 0, 2, None),
    "qwen3-14b": (320, "wgmma", 0, 2, None),
    "zamba2-2.7b": (72, "wgmma", 432, 6, None),
    "qwen2-moe-a2.7b": (192, "wgmma", 0, 2, None),
    "internvl2-26b": (8 * INTERNVL_LAYERS, "wgmma", 0, 2, INTERNVL_LAYERS),
    "whisper-tiny": (96, "wgmma", 0, 2, None),
}
SERVE14_ARGS = ["--requests", "8", "--slots", "4", "--prompt-len", "1024", "--max-new", "32",
                "--cache-len", "1280", "--per-slot-positions"]
REFILLED14 = (4, 7)
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
# zamba2-2.7b's Mamba-2 scan at prefill: q is C, one group broadcast over
# the 80 heads as a stride-0 view (mamba_ssd_inputs)
SSD_MAMBA = (1, 1024, 80, 64, 64, 128)
# (label, shape, dtypes of q, k, v, non-zero h0): the serve shapes in the
# mLSTM's dtypes (q bf16, k f32, v bf16) and in f32, a ragged S, a
# continued prefill, the Mamba-2 scan (the same dtypes) and the
# reference's kernel-test shapes (SSD_CASES of tests/test_kernels.py) in
# f32 and bf16
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
    ("mamba2 stride-0 q", SSD_MAMBA, _MIXED, False),
    ("mamba2 stride-0 q f32", SSD_MAMBA, _F32, False),
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
F32_FLOPS_PER_S = mesh.PEAK_FLOPS_F32  # H100 SXM f32 peak outside the tensor cores
# f32 kernel route against plain route, last-position logits of the full
# model: the two differ only in f32 summation order, which 24 layers
# amplify; atol = 1e-3 of the logits' largest magnitude
LOGITS_REL_TOL = 1e-3
INF_TIME = 2**30
# captures of one profiled window before "the profiler saw nothing" (or, in
# device_ms, "recorded less than half") fails
PROFILE_TRIES = 3
# phase 15: LM training
TRAIN_STEPS = 8  # (a): steps of the full-width internlm2-1.8b
TRAIN_BATCH, TRAIN_SEQ = 4, 1024  # (a): a batch of 4 x 1024 tokens
TRAIN_REL = 1e-5  # (c)-(d): the card against the CPU, and a resumed run against a straight one
TRAIN_SGD_LR = 0.5  # (c): SGD's rate (the update is the clipped gradient's, norm <= 1)
TRAIN_LAUNCH = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced", "--steps", "20",
                "--batch", "2", "--seq", "32", "--ckpt-every", "5", "--log-every", "100"]
# rows of 11 199 and 11 201 nodes start off a 16-byte boundary from row 1 on
# (256, 64): phase 12 (c)'s RL-throughput batch
EXACT_SHAPES = [(1, 16), (1, 131), (13, 131), (1, 11200), (64, 11200),
                (3, 11199), (2, 11201), (256, 64)]
ZERO_SHAPES = [(0, 16), (4, 0), (0, 0)]
MAIN_SHAPE = (1, 11200)  # what engine.event_horizon hands the kernels
# (E, N, G) for the occupancy kernel; the main path's is (1, 11200, 3),
# phase 12 (a)'s grouped RL batch (16, 11200, 3)
OCC_SHAPES = [(1, 16, 1), (13, 131, 3), (1, 11200, 3), (64, 11200, 3),
              (1, 11200, 64), (3, 11199, 3), (2, 11201, 3), (2, 11201, 64),
              (1, 11200, 1536), (3, 5003, 1536),  # 1536: event_fuse.MAX_GROUPS
              (16, 11200, 3)]
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
# depth cuts that keep the script inside its time: phase 10's Forecast run
# replays the first 250 jobs, not 1000, phase 11's dense E = 8 grid the
# first 250, not 500 (the cut that pays for phase 18; phase 13 (c)'s Curie
# grid and phase 17 (a)-(b) follow it, since they hold their rows to it),
# and phase 10's DVFS run takes phase 5's workload cut to 125 jobs
FORECAST_JOBS = 250
SWEEP_JOBS = 250
DVFS_JOBS = 125
# phase 11's (e) replays the first 250 jobs, not 500, and its plain grouped
# E = 8 grid is dropped, so that (e) and (f) fit; its dense E = 64 grid
# replays the first 125 (250 before the cut that pays for phase 19)
SWEEP_CUT_JOBS = 250
SWEEP_E64_JOBS = 125
# phase 11 (e) and (f): the engine options a grid runs with
OPTIONS = dict(node_order="pack", allocation="partition", merge_bursts=True)
# and phase 4's 16-node runs take 30 generated jobs, not 100 (50 to PR
# 22), and its grouped runs the first 30 replayed jobs, not 120 (60 to PR
# 23, the cut that pays for phase 15; phase 11 (f) keeps 60)
LABEL_JOBS = 30
PHASE4_GROUPED_JOBS = 30
GROUPED_JOBS = 60
# phase 16 (a): a mixed block program at zamba2-2.7b's width (6 Mamba-2
# layers, then 2 dense ones), 6 requests of 1024 tokens on 4 slots (4 and 5
# refill a freed slot), 16 new tokens, cache 1056; its f32 check program
MIXED16 = (("mamba2", 6), ("dense", 2))
MIXED16_F32 = (("mamba2", 1), ("dense", 1))
MIXED16_ARGS = ["--requests", "6", "--slots", "4", "--prompt-len", "1024", "--max-new", "16",
                "--cache-len", "1056", "--per-slot-positions"]
REFILLED16 = (4, 5)
# (b): standalone mLSTM and sLSTM stages at xlstm-350m's width, 4 requests
# of 1024 tokens on 4 slots, 8 new tokens; its f32 check program
RECURRENT16 = (("mlstm", 2), ("slstm", 1))
RECURRENT16_F32 = (("mlstm", 1), ("slstm", 1))
RECURRENT16_ARGS = ["--requests", "4", "--slots", "4", "--prompt-len", "1024", "--max-new",
                    "8", "--cache-len", "1056", "--per-slot-positions"]
# (c): the legacy loop's dense grid (E = 4) and grouped env (B = 2, 16 steps)
LEGACY_GRID = [{"scheduler": sc, "timeout": t}
               for sc in ("EASY PSUS", "FCFS PSAS+IPM") for t in (600, 1800)]
LEGACY_ENV_STEPS = 16
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
    """The card's name and power limit (``mesh.card``); fails without one."""
    line = mesh.card()
    check(line is not None, "nvidia-smi gave no card's name and power limit")
    return line


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


def captured(torch, body, what, cpu=True):
    """(the profile, ``body()``'s result): ``body`` run under
    ``torch.profiler`` (CUDA activity, and CPU with ``cpu``). The profiler
    has lost whole captures on the card, so a capture that records no
    device operation is taken again, ``body`` and all, up to
    ``PROFILE_TRIES`` captures; the callers' checks then read the last."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    for attempt in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            result = body()
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            break
        print(f"profiler: capture {attempt + 1} of {PROFILE_TRIES} of {what} recorded "
              "no device operation", flush=True)
    return prof, result


def device_ms(torch, fn, args, calls=200, warmup=20):
    """(device ms per call, device ops per call, {op name: device ms per
    call}, share recorded): the durations of the device operations that
    ``calls`` calls launch, read from ``torch.profiler``, after a warm-up.
    Gaps between them and the host's time are not counted. The profiler may
    lose records of a capture, so each op name is timed by its mean recorded
    duration times its launches per call (its recorded count over ``calls``,
    rounded). A capture that records less than half of the expected records
    is taken again, up to ``PROFILE_TRIES`` captures; the share seen in the
    capture read is returned and must be at least a half."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()

    for attempt in range(PROFILE_TRIES):
        prof, _ = captured(torch, body, fn.__name__)
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(e.device_time_total)
        check(len(by_name) > 0, f"the profiler saw no device operation of {fn.__name__}")
        per_call = {k: max(1, round(len(v) / calls)) for k, v in by_name.items()}
        n_ops = sum(per_call.values())
        seen = sum(len(v) for v in by_name.values()) / (n_ops * calls)
        if seen >= 0.5:
            break
        print(f"profiler: capture {attempt + 1} of {PROFILE_TRIES} of {fn.__name__} "
              f"recorded {seen:.2f} of its device operations", flush=True)
    check(seen >= 0.5, f"the profiler recorded {seen:.2f} of the device "
          f"operations of {fn.__name__} in each of {PROFILE_TRIES} captures")
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


def ssd_bound(b, s, h, dk, dv, chunk, itemsizes, h0, q_heads=None):
    """(ms, "bytes" or "operations") for one GLA scan: q, k, v, g (and h0)
    read once, y and h_final written once, against the f32 products the
    recurrence needs in its chunk form — per chunk of L steps the causal
    L(L+1)/2 scores (dk each) and their products with v (dv each), and
    q . h_in and the state update (dk dv each per step), 2 flops a
    multiply-add — at the f32 peak (the kernel computes in f32). A q of
    ``q_heads`` heads broadcast over the H (Mamba-2's C: 1) is read as
    those."""
    flops = 0
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        pairs = n * (n + 1) // 2
        flops += 2 * (pairs * dk + pairs * dv + 2 * n * dk * dv)
    flops *= b * h
    iq, ik, iv = itemsizes
    qh = h if q_heads is None else q_heads
    bytes_moved = (b * s * (qh * dk * iq + h * (dk * ik + dv * iv + 4 + dv * iv))
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


def mamba_ssd_inputs(torch, np, shape, dtypes, h0=False, seed=0):
    """q, k, v, g, h0 (or None) on the card, as Mamba-2 makes them: q = C
    ``[B, S, dk]`` broadcast over the H heads (a stride-0 view), k = B dt
    with B ``[B, S, dk]`` shared by the heads and dt = softplus of a
    pre-activation near -4 (about the init's 1e-3..1e-1), v standard
    normal, g = -dt A with A = linspace(1, 16) over the heads (the init's
    ``A_log``), a non-zero h0 standard normal."""
    b, s, h, dk, dv, _ = shape
    rng = np.random.default_rng(seed + s + 7 * dk + 31 * dv + 101 * h)
    c = rng.normal(size=(b, s, dk))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 4))
    k = rng.normal(size=(b, s, 1, dk)) * dt[..., None]
    v = rng.normal(size=(b, s, h, dv))
    g = -dt * np.linspace(1.0, 16.0, h)
    st = rng.normal(size=(b, h, dk, dv)) if h0 else None

    def dev(x, dname):
        return torch.from_numpy(x.astype(np.float32)).to("cuda", getattr(torch, dname))

    q = dev(c, dtypes[0])[:, :, None, :].expand(b, s, h, dk)
    return [q, dev(k, dtypes[1]), dev(v, dtypes[2]), dev(g, "float32"),
            None if st is None else dev(st, "float32")]


def refill_gaps(torch, model, prompts, tokens, rids, cache_len, dev="cuda", extras=None,
                rows=1):
    """(each token's gap below its own decode's greedy maximum over the
    largest |logit|, the count of tokens that are that maximum) of the
    requests ``rids``' served ``tokens``: each request's prompt (``prompts``,
    numpy) prefilled alone, with the prefill keywords ``extras``, and
    decoded teacher-forced with the served tokens, so one token within
    tolerance does not derail the rest. With ``rows`` > 1 the request's
    cache fills each of ``rows`` slots and decodes at ``[rows]`` positions,
    the serve loop's batch shape: every product then has the shape the
    served row's had, and an MoE layer's routing, which a last bf16 bit
    can tip, is the served row's own."""
    from repro_torch.launch import serve

    gaps, exact = [], 0
    with torch.inference_mode():
        for rid in rids:
            served = tokens[rid]
            prompt = torch.from_numpy(prompts[rid][None]).to(dev)
            logits, one = model.prefill(prompt, cache_len=cache_len, **(extras or {}))
            if rows > 1:
                alone, one = one, model.init_cache(rows, cache_len)
                for r in range(rows):
                    serve.insert_cache(one, alone, r)
                del alone
            for i, tok in enumerate(served):
                ref = logits[0, -1].float()
                gaps.append(float(ref.max() - ref[tok]) / float(ref.abs().max()))
                exact += int(ref.argmax()) == tok
                if i + 1 < len(served):
                    pos = prompt.shape[1] + i
                    if rows > 1:
                        logits, one = model.decode_step(
                            torch.full((rows, 1), tok, device=dev), one,
                            torch.full((rows,), pos, device=dev))
                    else:
                        logits, one = model.decode_step(
                            torch.tensor([[tok]], device=dev), one, pos)
    return gaps, exact


def kernel_kind(name: str) -> str:
    """ssd, flash, matmul or other, for a device kernel's name."""
    if kernel_base(name).startswith("ssd_scan"):
        return "ssd"
    return kernel_class(name)


def profile_split(torch, fn, calls):
    """Profile ``calls`` calls of ``fn`` (after one warm-up): ({kind: device
    ms per call}, top-level host ops per call, device ops per call, ssd_scan
    launches per call, share of the device records seen, wall ms per call
    with the profiler on, {device op name: ms per call}). As in
    :func:`device_ms`, each op name is timed by its mean recorded duration
    times its launches per call (its recorded count over ``calls``,
    rounded), because the profiler may lose records of a long capture; the
    share seen must be at least a half."""
    fn()
    torch.cuda.synchronize()

    def body():
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall = captured(torch, body, "a profiled split")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    check(len(by_name) > 0, "the profiler saw no device operation")
    per_call = {k: max(1, round(len(v) / calls)) for k, v in by_name.items()}
    n_ops = sum(per_call.values())
    seen = sum(len(v) for v in by_name.values()) / (n_ops * calls)
    check(seen >= 0.5, f"the profiler recorded {seen:.2f} of the device operations")
    each = {k: statistics.fmean(v) * per_call[k] for k, v in by_name.items()}
    by_kind = {"ssd": 0.0, "flash": 0.0, "matmul": 0.0, "other": 0.0}
    for k, ms in each.items():
        by_kind[kernel_kind(k)] += ms
    ssd_per_call = sum(n for k, n in per_call.items() if kernel_kind(k) == "ssd")
    return (by_kind, top_level_ops(torch, prof) / calls, n_ops, ssd_per_call, seen,
            1e3 * wall / calls, each)


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


def oracle_of(plat, wl, cfg):
    """The port's sequential oracle on the host: (metrics, schedule table,
    seconds it took). Module-level, so that a worker process can run it."""
    from repro_torch.core.ref.pydes import run_pydes

    t0 = time.perf_counter()
    m_o, des = run_pydes(plat, wl, cfg)
    return m_o, des.schedule_table(), time.perf_counter() - t0


def held_against_oracle(metrics, np, plat, wl, cfg, s, oracle=None):
    """(schedule == the port's oracle's, the largest relative error of total
    energy, wasted energy and each DVFS mode-energy cell, metrics).
    ``oracle`` is :func:`oracle_of`'s result, computed here when None."""
    m_o, table, _ = oracle or oracle_of(plat, wl, cfg)
    m = metrics.metrics_from_state(s, plat)
    same = np.array_equal(metrics.schedule_table(s), table)
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

        def body():
            t0 = time.perf_counter()
            nb = run(cut)
            torch.cuda.synchronize()
            return nb, time.perf_counter() - t0

        prof, (nb, wall) = captured(torch, body, "a profiled window", cpu=False)
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
    """Each case's kernel output == its plain version's, bit for bit (f32
    outputs compared as their int32 bits), with one launch per non-empty
    call at the cluster size the wrapper records; zero sizes give
    ``zero_out(args)``. Prints the cluster size of each non-empty case and
    returns the max abs difference seen (0.0 when all are equal)."""
    from repro_torch.kernels import event_fuse

    max_err, sizes = 0.0, []
    for label, args, empty in cases:
        poison(torch)
        before = event_fuse.LAUNCHES[name]
        event_fuse.CLUSTER.pop(name, None)
        got = fn(*args)
        torch.cuda.synchronize()
        want = zero_out(args) if empty else plain(*args)
        check(event_fuse.LAUNCHES[name] == before + (0 if empty else 1),
              f"{name} launch count at {label}")
        if not empty:
            check(event_fuse.CLUSTER.get(name, 0) >= 1,
                  f"{name} recorded no cluster size at {label}")
            sizes.append(f"{label}: {event_fuse.CLUSTER[name]}")
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} output shape/dtype at {label}")
            same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                    if a.dtype == torch.float32 else torch.equal(a, b))
            check(same, f"{name} == plain bit for bit at {label}")
            if a.numel():
                max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    print(f"phase 3 kernels: {name} held bit for bit at {len(cases)} cases; cluster "
          f"size by case: {'; '.join(sizes)}", flush=True)
    return max_err


def time_kernel(torch, name, fn, plain, args, bound, shape, floor_ms, fill):
    """(kernel device ms, plain device ms, kernel wrapper host ms, fill host
    ms) at ``args``, printed with the plain version's device ops and host
    time, the bound, the cluster size and the launch floor ``floor_ms``.
    The wrapper's host time is taken in turns with that of ``fill`` (a
    function and its arguments: the 1-element fill), fill, wrapper, wrapper,
    fill, so each is read against the host's speed of the same moment; each
    figure is the mean of its two turns."""
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
    print(f"phase 3 kernels: {name} {shape} (cluster of {event_fuse.CLUSTER[name]} "
          f"CTAs a row): "
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


def phase10(torch, np, swf, g_state, g_cfg, dev="cuda", nodes=11200,
            max_jobs=1000):
    """Phase 10: the grouped Forecast (the trace's first ``FORECAST_JOBS``
    jobs) and DVFS (``DVFS_JOBS``) runs at Curie scale on ``dev``, each
    against its plain per-node route, the Forecast run at horizon 0 against
    phase 6's run (``g_state``, ``g_cfg``, ``max_jobs`` jobs), and the
    Forecast run's profiled window. Returns the event kernels' launches of the Forecast
    and the DVFS run."""
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
    fc_wl = replay_workload(swf, nb_nodes=nodes, oversize="clamp",
                            max_jobs=FORECAST_JOBS)
    dvfs_plat = dvfs_platform_example(nodes)
    # phase 5's workload (the cea_curie preset cut to DVFS_JOBS jobs)
    dvfs_wl = generate_workload(dataclasses.replace(
        PRESETS["cea_curie"], n_jobs=DVFS_JOBS, nb_res=nodes,
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
    g_wl = replay_workload(swf, nb_nodes=nodes, oversize="clamp", max_jobs=max_jobs)
    fc0 = engine.simulate(curie, g_wl, dataclasses.replace(fc_cfg, forecast_horizon=0),
                          device=dev)
    check(np.array_equal(metrics.schedule_table(fc0), metrics.schedule_table(g_state)),
          "phase 10: Forecast at horizon 0 == phase 6's EASY PSUS schedule")
    d0, d6 = metrics.np_state(fc0), metrics.np_state(g_state)
    for fld in ("energy", "n_batches", "n_switch_on", "n_switch_off"):
        check(np.array_equal(d0[fld], d6[fld]), f"phase 10: horizon 0 {fld} == phase 6's")
    # one profiled window, the Forecast run's (the phase 6 and DVFS windows
    # are cut for time, to pay for phase 17)
    prof10 = {"forecast": profile_batches(torch, engine, curie, fc_wl, fc_cfg, dev=dev)}
    fc, dv = runs10["forecast"], runs10["dvfs"]
    fc_by_kernel, dv_by_kernel = fc["by_kernel"], dv["by_kernel"]
    fm, dm = fc["m"], dv["m"]
    # the reactive base at the Forecast run's depth: phase 6's configuration
    base_s = engine.simulate(curie, fc_wl, g_cfg, device=dev)
    bm = metrics.metrics_from_state(base_s, curie)
    for name, r in runs10.items():
        print(f"phase 10 {name}: n_batches {r['n_batches']}, occ kernel launches "
              f"{r['occ']}, host syncs {r['syncs']} ({r['syncs'] / r['n_batches']:.3f}"
              f"/batch); wall {r['wall']:.2f} s = "
              f"{1e6 * r['wall'] / r['n_batches']:.1f} us/batch (plain per-node route "
              f"{r['plain_wall']:.2f} s, schedule equal, energy and mode ledgers max rel "
              f"diff {r['rel']:.2e})", flush=True)
    print(f"phase 10 forecast: EASY PSUS+Forecast horizon 1800 on curie_platform({nodes}), "
          f"{len(fc_wl)} replayed jobs: switch-ons {int(fc['state'].n_switch_on)} (phase "
          f"6's EASY PSUS on these jobs {int(base_s.n_switch_on)}), total {fm.total_energy_j / 3.6e6:.1f} "
          f"kWh ({bm.total_energy_j / 3.6e6:.1f}), mean wait {fm.mean_wait_s:.1f} s "
          f"({bm.mean_wait_s:.1f}), makespan {fm.makespan_s} s "
          f"({bm.makespan_s}); horizon 0 on phase 6's {len(g_wl)} jobs: schedule, "
          "energy, batches and switch counts == phase 6's bit for bit", flush=True)
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


def pass_counters(sweep):
    """Count what a sweep's scheduler passes read while the context is open:
    ``windows`` (one read a pass), ``partition`` (the head-outcome reads,
    one a step with a partition head attempt), ``passes`` (each pass and
    each burst-merge repeat) and ``merge`` (the repeat-condition reads, one
    after each pass that attempted under ``merge_bursts``)."""
    counts = dict(windows=0, partition=0, passes=0, merge=0)
    real_pass, real_run, real_fail = sweep._scheduler_pass, sweep._run_pass, sweep._PassPlan.fail

    def scheduler_pass(s, g, cfg, *a):
        counts["windows"] += 1
        return real_pass(s, g, cfg, *a)

    def run_pass(s, g, cfg, *a):
        counts["passes"] += 1
        out = real_run(s, g, cfg, *a)
        counts["merge"] += bool(cfg.merge_bursts and out[1])
        return out

    def fail(plan, a, ok):
        counts["partition"] += 1
        return real_fail(plan, a, ok)

    @contextlib.contextmanager
    def opened():
        sweep._scheduler_pass, sweep._run_pass, sweep._PassPlan.fail = (
            scheduler_pass, run_pass, fail)
        try:
            yield counts
        finally:
            sweep._scheduler_pass, sweep._run_pass, sweep._PassPlan.fail = (
                real_pass, real_run, real_fail)

    return opened()


def single_runs(runs, dev="cuda"):
    """Each ``(platform, workload, config)`` of ``runs`` simulated alone on
    ``dev``: (numpy state, schedule table, metrics row, wall seconds) each.
    Module-level, so that a worker process can run it: phase 11's single
    runs go on in a worker beside its grids (the card is idle most of a
    host-bound loop)."""
    import torch

    from repro_torch.core import engine, metrics
    out = []
    for plat, wl, cfg in runs:
        t0 = time.perf_counter()
        s = engine.simulate(plat, wl, cfg, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append((metrics.np_state(s), metrics.schedule_table(s),
                    metrics.metrics_from_state(s, plat).row(), wall))
    return out


def phase11(torch, np, swf, dev="cuda", nodes=11200, max_jobs=SWEEP_JOBS,
            cut_jobs=SWEEP_CUT_JOBS, e64_jobs=SWEEP_E64_JOBS):
    """Phase 11: the batched sweep at Curie scale. Dense grids at E = 8 on
    phase 5's inputs cut to their first ``max_jobs`` jobs and at E = 64 on
    ``e64_jobs``; (e) a grouped E = 8 grid on phase 6's inputs cut to
    ``cut_jobs`` with ``OPTIONS`` (pack, partition, burst merging); (f) a
    dense E = 4 grid with ``OPTIONS`` on phase 4's 280-node Curie platform
    and trace (``GROUPED_JOBS`` jobs).
    Each checked row is held bit for bit against a single run of its
    scenario on the same inputs; the single runs go on in a worker process
    while the grids run. Returns the event kernels' launches of the timed
    dense grids (summed), of (e) and of (f) by kernel, and the dense E = 8
    grid's metrics rows by (scheduler, timeout)."""
    from repro_torch.core import engine, sweep
    from repro_torch.core.metrics import metrics_from_state, np_state, schedule_table
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

    def dense_jobs(n):  # phase 5's workload (the cea_curie preset cut to n jobs)
        return generate_workload(dataclasses.replace(
            PRESETS["cea_curie"], n_jobs=n, nb_res=nodes,
            max_res=min(PRESETS["cea_curie"].max_res, nodes)))

    dense_wl, dense_cut = dense_jobs(max_jobs), dense_jobs(e64_jobs)
    base, pol = from_label("EASY PSUS")
    dense_cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    g_plat = curie_platform(nodes)
    g_wl = replay_workload(swf, nb_nodes=nodes, oversize="clamp", max_jobs=cut_jobs)
    e_cfg = EngineConfig(base=base, policy=pol, timeout=1800, grouped_tables=True,
                         **OPTIONS)
    # (f): phase 4's grouped platform and trace, on the dense route
    f_plat = curie_platform(280)
    f_wl = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=GROUPED_JOBS)
    f_cfg = dataclasses.replace(dense_cfg, **OPTIONS)
    grids = [  # name, platform, jobs, config, scenarios, kernel, profiled
        ("dense E=8", dense_plat, dense_wl, dense_cfg, sweep_grid(8), "event_fuse_ledger",
         True),
        ("dense E=64", dense_plat, dense_cut, dense_cfg, sweep_grid(64),
         "event_fuse_ledger", True),
        ("(e) options E=8", g_plat, g_wl, e_cfg, sweep_grid(8, [600, 1200, 1800, 2400]),
         "event_fuse_occ", False),
        ("(f) options dense E=4", f_plat, f_wl, f_cfg, sweep_grid(4, [600, 1800]), None,
         False),
    ]

    def scenario_cfg(cfg, scheduler, timeout):
        base, pol = from_label(scheduler)
        return dataclasses.replace(cfg, base=base, policy=pol, timeout=timeout)

    # (grid, scenario, platform, jobs, config) of every checked row
    checks = [
        ("dense E=64", ("EASY PSUS", 1800), dense_plat, dense_cut, dense_cfg),
        ("dense E=8", ("FCFS PSAS+IPM", 600), dense_plat, dense_wl, dense_cfg),
        ("(e) options E=8", ("EASY PSUS", 1800), g_plat, g_wl, e_cfg),
        ("(e) options E=8", ("FCFS PSAS+IPM", 600), g_plat, g_wl, e_cfg),
    ] + [("(f) options dense E=4", (sc["scheduler"], sc["timeout"]), f_plat, f_wl, f_cfg)
         for sc in grids[-1][4]]
    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.terminate)
    pending = pool.apply_async(single_runs, (
        [(plat, wl, scenario_cfg(cfg, *sc)) for _, sc, plat, wl, cfg in checks], dev))
    pool.close()
    runs = {}
    for name, plat, wl, cfg, scen, kname, profiled in grids:
        def run(c, plat=plat, wl=wl, scen=scen):
            return int(sweep.sweep(plat, wl, scen, c, device=dev).states.n_batches.max())

        # the first call: the profiled window's warm-up, then its window
        prof = profile_window(torch, run, cfg) if profiled else None
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0
        live_mib = torch.cuda.memory_allocated() / 2**20  # earlier phases' tensors
        torch.cuda.reset_peak_memory_stats()
        with pass_counters(sweep) as reads:
            t0 = time.perf_counter()
            b = sweep.sweep(plat, wl, scen, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(event_fuse.LAUNCHES)
        syncs = engine.HOST_SYNCS
        nb = b.states.n_batches.cpu().numpy()
        iters = int(nb.max())
        peak_mib = torch.cuda.max_memory_allocated() / 2**20 - live_mib
        check(not b.states.truncated.any(), f"phase 11 {name}: a row truncated")
        # under partition a job wider than every group never starts
        runnable = cfg.allocation != "partition" or (
            max(j.res for j in wl.jobs) <= max(grp.count for grp in plat.node_groups))
        check(not runnable or bool(sweep.all_done(b.states).all()),
              f"phase 11 {name}: a row left jobs")
        check(kname is None or launches[kname] == iters,
              f"phase 11 {name}: {kname} launches {launches} != iterations {iters}")
        check(all(v == 0 for k, v in launches.items() if k != kname)
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 11 {name}: other kernels launched: {launches}")
        # every read is the loop's (one an iteration), a pass's window, a
        # partition head step's outcomes or a merge repeat's condition
        check(syncs == iters + reads["windows"] + reads["partition"] + reads["merge"],
              f"phase 11 {name}: {syncs} host syncs for {iters} iterations, {reads}")
        check(cfg.allocation == "partition" or reads["partition"] == 0,
              f"phase 11 {name}: partition reads without partition")
        runs[name] = dict(batch=b, scen=scen, wall=wall, iters=iters,
                          launches={k: launches[k] for k in ("event_fuse_ledger",
                                                             "event_fuse_occ")})
        line = (f"phase 11 {name}: {len(scen)} scenarios on {plat.nb_nodes} nodes, "
                f"{len(wl)} jobs: wall {wall:.2f} s, {wall / len(scen):.3f} s a scenario; "
                f"iterations {iters} (rows' n_batches {int(nb.min())}..{iters}), "
                f"{1e6 * wall / iters:.1f} us an iteration; "
                f"{kname or 'no kernel'} launches "
                f"{launches[kname] if kname else sum(launches.values())}; host syncs "
                f"{syncs} ({syncs / iters:.3f} an iteration: {iters} loop, "
                f"{reads['windows']} window, {reads['partition']} partition head-outcome "
                f"and {reads['merge']} merge-condition reads; {reads['passes']} passes, "
                f"{reads['passes'] - reads['windows']} of them burst-merge repeats); ")
        if prof:
            line += (f"(a call after the profiled window and its warm-up) first 100 "
                     f"iterations profiled: {prof[0]:.1f} device ops an iteration, "
                     f"device {1e3 * prof[1]:.1f} us an iteration, wall "
                     f"{1e3 * prof[2]:.1f} us (profiled), busy {100 * prof[3]:.1f} %; ")
        print(line + f"peak device memory {peak_mib:.1f} MiB above the {live_mib:.1f} "
              "MiB live before it", flush=True)

    syncs, reported, small_iters = sweep_sync_check(torch, dev)
    check(reported == syncs, f"phase 11: PyTorch reports {reported} synchronizing calls "
          f"in a small grid's loop, the sweep counts {syncs} host reads")
    t0 = time.perf_counter()
    singles = pending.get()
    wait_s = time.perf_counter() - t0
    pool.join()
    walls = {}
    for (name, (scheduler, timeout), plat, _, _), (state, table, mrow, wall) in zip(
            checks, singles):
        r = runs[name]
        i = r["scen"].index({"scheduler": scheduler, "timeout": timeout})
        got = r["batch"].state_at(i)
        mine = np_state(got)
        bad = [k for k in state if not (mine[k].dtype == state[k].dtype
                                        and np.array_equal(mine[k], state[k]))]
        what = f"phase 11: {name} row {scheduler} {timeout} == its single run"
        check(not bad, f"{what}: fields {bad} differ")
        check(np.array_equal(schedule_table(got), table)
              and r["batch"].metrics[i].row() == mrow == metrics_from_state(got, plat).row(),
              f"{what}: schedule table or metrics differ")
        walls[name, scheduler] = wall
    e, m8 = runs["(e) options E=8"], runs["dense E=8"]
    print(f"phase 11 rows: the E=64 row EASY PSUS 1800 == phase 5's configuration run "
          f"alone on its first {e64_jobs} jobs, the E=8 row FCFS PSAS+IPM 600 == its "
          f"single run on {max_jobs}, bit for bit; (e) "
          f"{OPTIONS}: rows EASY PSUS 1800 and FCFS PSAS+IPM 600 == their single runs "
          "(every state field, the schedule table, every SimMetrics field); (f) every "
          f"row == its single run on curie_platform(280), {len(f_wl)} jobs, dense. The "
          f"{len(checks)} single runs ran in a worker process beside the grids (waited "
          f"{wait_s:.2f} s for them): dense EASY PSUS 1800 on {e64_jobs} jobs "
          f"{walls['dense E=64', 'EASY PSUS']:.2f} s, FCFS PSAS+IPM 600 "
          f"{walls['dense E=8', 'FCFS PSAS+IPM']:.2f} s; (e)'s EASY PSUS 1800 "
          f"{walls['(e) options E=8', 'EASY PSUS']:.2f} s and FCFS PSAS+IPM 600 "
          f"{walls['(e) options E=8', 'FCFS PSAS+IPM']:.2f} s against (e)'s "
          f"{e['wall'] / len(e['scen']):.2f} s a scenario; a 16-node grid of 8 rows "
          f"under torch.cuda.set_sync_debug_mode: {reported} synchronizing calls "
          f"reported == the sweep's {syncs} host reads in {small_iters} iterations; "
          "dense E=8 total energy kWh by timeout, EASY PSUS "
          + ", ".join(f"{sc['timeout']}: {mm.total_energy_j / 3.6e6:.1f}"
                      for sc, mm in zip(m8["scen"], m8["batch"].metrics)
                      if sc["scheduler"] == "EASY PSUS")
          + f"; phase wall {time.perf_counter() - t11:.1f} s", flush=True)
    dense = sum(runs[n]["launches"]["event_fuse_ledger"]
                for n in ("dense E=8", "dense E=64"))
    e8_rows = {(sc["scheduler"], sc["timeout"]): mm.row()
               for sc, mm in zip(m8["scen"], m8["batch"].metrics)}
    return dense, e["launches"], runs["(f) options dense E=4"]["launches"], e8_rows


RL_ENVS = 16  # phase 12 (a)-(b): envs in the grouped Curie batch
RL_WINDOW = 500  # jobs a window of the synthesized Curie SWF
RL_STEPS = 256  # batched steps of phase 12 (a)
RL_ROWS = (0, 15)  # rows held against their own HPCGymEnv episodes


def curie_rl_batch(swf, dev="cuda", nodes=11200, envs=RL_ENVS, window=RL_WINDOW):
    """Phase 12 (a)'s env batch: ``envs`` envs of ``curie_platform(nodes)``,
    each on one of as many consecutive ``window``-job windows of the trace,
    EASY RL:groups at a 600 s decision interval. Returns (platform,
    workloads, EnvConfig, const, ``[envs]`` initial states)."""
    from repro_torch.core import engine
    from repro_torch.core.policy import RLController
    from repro_torch.core.rl import a2c, env
    from repro_torch.core.types import EngineConfig
    from repro_torch.workloads.platform import curie_platform
    from repro_torch.workloads.traces import rebase_submit_times, replay_workload
    from repro_torch.workloads.workload import Workload
    plat = curie_platform(nodes)
    trace = replay_workload(swf, nb_nodes=nodes, oversize="clamp", max_jobs=envs * window)
    wls = [rebase_submit_times(Workload(nodes, trace.jobs[i * window:(i + 1) * window]))
           for i in range(envs)]
    cfg = env.EnvConfig(
        engine=EngineConfig(policy=RLController(grouped=True), rl_decision_interval=600,
                            grouped_tables=True),
        feature="compact_groups", action="group_target_fraction",
        reward="group_waste_wait", n_groups=plat.n_groups(), max_steps=512)
    cfg = dataclasses.replace(cfg, engine=engine.trim_window(cfg.engine, window))
    const = engine.make_const(plat, cfg.engine, device=dev)
    return plat, wls, cfg, const, a2c.make_batched_sims(plat, wls, cfg, device=dev)


def phase12(torch, np, swf, tmp, dev="cuda", nodes=11200):
    """Phase 12: the RL stack on ``dev``. (a) the grouped env over 16 Curie
    windows, rows 0 and 15 against their own single envs; (b) A2C on it;
    (c) the reference's RL-throughput configuration with one A2C and one
    PPO update; (d) a saved policy through ``python -m
    repro_torch.launch.sim`` (EASY RL:groups) against the plain per-node
    route; (e) a sweep of DVFS and RL rows against their single runs.
    Returns the event kernels' launches of each part, by kernel."""
    from repro_torch.core import engine, metrics, sweep
    from repro_torch.core.policy import RLController, from_label
    from repro_torch.core.rl import a2c, env, networks, ppo
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.training.checkpoint import save_policy
    from repro_torch.workloads.generator import GeneratorConfig, generate_workload
    from repro_torch.workloads.platform import (
        PlatformSpec, curie_platform, dvfs_platform_example,
    )

    t12 = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest",
          "phase 12: f32 matmuls in full f32 (no TF32)")
    by_part = {}

    def reset_counts():
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0

    def launches(part, kname, want):
        got = dict(event_fuse.LAUNCHES)
        by_part[part] = got
        check(got[kname] == want and all(v == 0 for k, v in got.items() if k != kname)
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 12 {part}: launches {got}, {want} {kname} expected")

    # ---- (a) the grouped env over 16 Curie windows ----
    plat, wls, cfg, const, sims0 = curie_rl_batch(swf, dev, nodes)
    grid = env.make_env_grid(const, RL_ENVS)
    actions = ((3 * torch.arange(RL_STEPS, device=dev)[:, None]
                + torch.arange(RL_ENVS, device=dev)) % cfg.n_actions).to(torch.int32)
    rows = list(RL_ROWS)

    def plain_route(c):
        """``c`` with the event pass on the plain per-node route."""
        return dataclasses.replace(
            c, engine=dataclasses.replace(c.engine, fused_kernel=False))

    def same_run(part, got, want):
        """Two batched runs, each (final state, [(obs, reward, done)] a
        step), equal bit for bit in every row."""
        (sa, ka), (sb, kb) = got, want
        bad = [f for f, x, y in zip(engine.SimState._fields, sa.sim, sb.sim)
               if not torch.equal(x, y)]
        bad += [f for f in ("steps", "done") if not torch.equal(getattr(sa, f),
                                                                 getattr(sb, f))]
        bad += [f"per-step {f}" for f, x, y in zip(("obs", "reward", "done"),
                                                   zip(*ka), zip(*kb))
                if not torch.equal(torch.stack(x), torch.stack(y))]
        check(not bad, f"phase 12 {part}: the kernel run's {bad} != the plain "
              "route's")

    def run_env(n_steps, keep, c=cfg):
        st, obs = env.batched_reset(c, grid, sims0)
        kept = []
        for t in range(n_steps):
            st, obs, r, d, _ = env.batched_step(c, grid, st, actions[t])
            if keep:
                kept.append((obs, r, d))
        return st, kept

    torch.cuda.synchronize()
    live_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    st, kept = run_env(RL_STEPS, True)
    torch.cuda.synchronize()
    env_wall = time.perf_counter() - t0
    env_syncs = engine.HOST_SYNCS
    peak_mib = torch.cuda.max_memory_allocated() / 2**20 - live_mib
    launches("env grouped", "event_fuse_occ", RL_STEPS)
    check(env_syncs <= 2 * RL_STEPS,
          f"phase 12 (a): {env_syncs} host syncs for {RL_STEPS} steps")
    n_done = int(st.done.sum())
    # the first 100 steps profiled (a warm run of the same steps came first)
    n_prof = min(100, RL_STEPS)
    torch.cuda.synchronize()
    def env_window():
        t0 = time.perf_counter()
        run_env(n_prof, False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, prof_wall = captured(torch, env_window, "phase 12 (a)'s steps", cpu=False)
    dev_ms = [e.device_time_total / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev_ms, "phase 12 (a): the profiler saw no device op")
    busy = sum(dev_ms) / (1e3 * prof_wall)
    # the whole batch again on the plain per-node route (no event kernel)
    reset_counts()
    t0 = time.perf_counter()
    plain_run = run_env(RL_STEPS, True, plain_route(cfg))
    torch.cuda.synchronize()
    env_plain_wall = time.perf_counter() - t0
    check(not any(event_fuse.LAUNCHES.values()),
          f"phase 12 (a): the plain route launched {dict(event_fuse.LAUNCHES)}")
    same_run("(a)", (st, kept), plain_run)
    del plain_run
    # rows 0 and 15 against their own single envs, step by step
    obs_k, rew_k, done_k = (torch.stack(x)[:, rows].cpu() for x in zip(*kept))
    t0 = time.perf_counter()
    for j, b in enumerate(rows):
        single = env.HPCGymEnv(plat, wls[b], cfg, device=dev)
        single.reset()
        for t in range(RL_STEPS):
            ob, rb, db, _ = single.step(int(actions[t, b]))
            check(torch.equal(ob.cpu(), obs_k[t, j]) and rb == float(rew_k[t, j])
                  and db == bool(done_k[t, j]),
                  f"phase 12 (a): row {b} step {t} != its HPCGymEnv step")
        da = metrics.np_state(engine.SimState(*[x[b] for x in st.sim]))
        db_ = metrics.np_state(single.state.sim)
        bad = [k for k in da if not np.array_equal(da[k], db_[k])]
        check(not bad, f"phase 12 (a): row {b} state fields {bad} != its HPCGymEnv's")
    single_wall = time.perf_counter() - t0
    print(f"phase 12 (a) env: {RL_ENVS} envs on curie_platform({nodes}), grouped, "
          f"EASY RL:groups interval 600, group_target_fraction / compact_groups / "
          f"group_waste_wait, 16 consecutive {RL_WINDOW}-job windows of the Curie SWF: "
          f"{RL_STEPS} batched steps in {env_wall:.2f} s = {1e3 * env_wall / RL_STEPS:.2f} "
          f"ms a step, {RL_ENVS * RL_STEPS / env_wall:.0f} env steps/s; "
          f"event_fuse_occ launches {by_part['env grouped']['event_fuse_occ']}, host syncs "
          f"{env_syncs} ({env_syncs / RL_STEPS:.3f} a step); {n_done} envs done; first "
          f"{n_prof} steps profiled: {len(dev_ms) / n_prof:.1f} device ops a step, device "
          f"{sum(dev_ms) / n_prof * 1e3:.1f} us a step, busy {100 * busy:.1f} %; peak device "
          f"memory {peak_mib:.1f} MiB above the {live_mib:.1f} MiB live; every row's "
          f"state and per-step observations, rewards and done == the plain per-node "
          f"route's bit for bit ({env_plain_wall:.2f} s); rows {rows} == their "
          f"HPCGymEnv episodes bit for bit (state, observations, rewards, done; "
          f"{single_wall:.1f} s for both)", flush=True)

    # ---- (b) A2C on (a)'s batch ----
    acfg = a2c.A2CConfig(n_envs=RL_ENVS, n_steps=16)
    key = torch.Generator(device=dev).manual_seed(acfg.seed)
    params = networks.policy_init(key, cfg.obs_size, cfg.n_actions, acfg.hidden)
    before = [p.detach().clone() for p in params.parameters()]
    update, opt = a2c.make_update_fn(cfg, const, sims0, acfg)
    env_states, obs = env.batched_reset(cfg, grid, sims0)
    ts = a2c.TrainState(params, opt.init(params.parameters()), env_states, obs, key)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = []
    for _ in range(8):
        ts, m = update(ts)
        hist.append({k: float(v) for k, v in m.items()})
    a2c_wall = time.perf_counter() - t0
    launches("a2c grouped", "event_fuse_occ", 8 * acfg.n_steps)
    moved = sum(float((a - b.detach()).abs().sum())
                for a, b in zip(before, params.parameters()))
    check(all(np.isfinite(h["loss"]) and h["entropy"] > 0 for h in hist) and moved > 0,
          f"phase 12 (b): A2C losses {[h['loss'] for h in hist]}, moved {moved}")
    print(f"phase 12 (b) A2C: n_envs {RL_ENVS}, n_steps {acfg.n_steps}, 8 updates in "
          f"{a2c_wall:.2f} s = {a2c_wall / 8:.3f} s an update, "
          f"{8 * acfg.n_steps * RL_ENVS / a2c_wall:.0f} env steps/s in training; loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, entropy "
          f"{hist[-1]['entropy']:.4f}, parameters moved {moved:.4f} (sum |delta|)",
          flush=True)

    # ---- (c) the reference's RL-throughput configuration ----
    tplat = PlatformSpec(nb_nodes=64)
    twl = generate_workload(GeneratorConfig(n_jobs=64, nb_res=64, seed=0))
    tcfg = env.EnvConfig(engine=EngineConfig(policy=RLController(), rl_decision_interval=600),
                         max_steps=64 * 4)
    tcfg = dataclasses.replace(tcfg, engine=engine.trim_window(tcfg.engine, len(twl)))
    tconst = engine.make_const(tplat, tcfg.engine, device=dev)
    tsims = a2c.make_batched_sims(tplat, [twl] * 256, tcfg, device=dev)
    tgrid = env.make_env_grid(tconst, 256)
    zeros = torch.zeros(256, dtype=torch.int32, device=dev)

    def run_thr(c, n_steps=64):
        s, _ = env.batched_reset(c, tgrid, tsims)
        kept = []
        for _ in range(n_steps):
            s, ob, r, d, _ = env.batched_step(c, tgrid, s, zeros)
            kept.append((ob, r, d))
        return s, kept

    run_thr(tcfg, 1)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thr_run = run_thr(tcfg)
    torch.cuda.synchronize()
    thr_wall = time.perf_counter() - t0
    launches("rl-throughput env", "event_fuse_ledger", 64)
    thr_syncs = engine.HOST_SYNCS
    # the same 64 steps on the plain per-node route (no event kernel)
    reset_counts()
    t0 = time.perf_counter()
    plain_run = run_thr(plain_route(tcfg))
    torch.cuda.synchronize()
    thr_plain_wall = time.perf_counter() - t0
    check(not any(event_fuse.LAUNCHES.values()),
          f"phase 12 (c): the plain route launched {dict(event_fuse.LAUNCHES)}")
    same_run("(c)", thr_run, plain_run)
    del thr_run, plain_run
    key = torch.Generator(device=dev).manual_seed(0)
    losses = {}
    reset_counts()
    for name, mod, lcfg in (
            ("A2C", a2c, a2c.A2CConfig(n_envs=256, n_steps=8)),
            ("PPO", ppo, ppo.PPOConfig(n_envs=256, n_steps=8, n_epochs=2,
                                       n_minibatches=4))):
        params = networks.policy_init(key, tcfg.obs_size, tcfg.n_actions, lcfg.hidden)
        upd, o = mod.make_update_fn(tcfg, tconst, tsims, lcfg)
        s0, ob0 = env.batched_reset(tcfg, tgrid, tsims)
        t0 = time.perf_counter()
        _, m = upd(a2c.TrainState(params, o.init(params.parameters()), s0, ob0, key))
        losses[name] = (float(m["loss"]), time.perf_counter() - t0)
        check(np.isfinite(losses[name][0]), f"phase 12 (c): {name} loss {losses[name][0]}")
    launches("rl-throughput learners", "event_fuse_ledger", 16)
    print(f"phase 12 (c) RL throughput (benchmarks/bench_rl.py defaults): 256 envs on a "
          f"64-node PlatformSpec, 64 jobs, EASY RL interval 600, target_fraction: 64 "
          f"batched steps in {thr_wall:.3f} s = {256 * 64 / thr_wall:.0f} env steps/s, "
          f"event_fuse_ledger launches 64, host syncs {thr_syncs}; every row's state and "
          f"per-step observations, rewards and done == the plain per-node route's bit "
          f"for bit ({thr_plain_wall:.3f} s); one A2C update (n_steps "
          f"8) loss {losses['A2C'][0]:.4f} in {losses['A2C'][1]:.2f} s, one PPO update "
          f"(n_epochs 2, n_minibatches 4) loss {losses['PPO'][0]:.4f} in "
          f"{losses['PPO'][1]:.2f} s", flush=True)

    # ---- (d) the saved policy through the command line ----
    ckpt = os.path.join(tmp, "policy")
    save_policy(ckpt, ts.params, obs_size=cfg.obs_size, n_actions=cfg.n_actions,
                feature=cfg.feature, action=cfg.action, n_levels=cfg.n_action_levels,
                hidden=acfg.hidden, grouped=True, n_groups=plat.n_groups())
    small = os.path.join(tmp, "curie280.json")
    curie_platform(280).save(small)
    run_cfg = {"workload": {"swf": swf, "nb_nodes": 280, "oversize": "clamp",
                            "max_jobs": 120},
               "platform": small, "scheduler": "EASY RL:groups", "timeout": 1800,
               "grouped_tables": True, "gantt": False,
               "rl": {"checkpoint": ckpt, "decision_interval": 600}}
    out = os.path.join(tmp, "rl_out")
    cfg_path = os.path.join(tmp, "rl_cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({**run_cfg, "out": out}, f)
    # python -m repro_torch.launch.sim --config, in this process so that its
    # kernel launches are counted (runpy is what -m runs)
    reset_counts()
    argv, sys.argv = sys.argv, ["repro_torch.launch.sim", "--config", cfg_path]
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            runpy.run_module("repro_torch.launch.sim", run_name="__main__",
                             alter_sys=True)
    finally:
        sys.argv = argv
    cli_wall = time.perf_counter() - t0
    cli_launches = dict(event_fuse.LAUNCHES)
    wrote = sorted(os.listdir(out))
    check(wrote == ["jobs.csv", "metrics.json"], f"phase 12 (d): outputs {wrote}")
    with open(os.path.join(out, "metrics.json")) as f:
        cli_row = json.load(f)
    check(json.loads(printed.getvalue()) == cli_row,
          "phase 12 (d): the printed metrics != metrics.json")
    jobs = np.loadtxt(os.path.join(out, "jobs.csv"), delimiter=",", skiprows=1,
                      usecols=(0, 3, 4), dtype=np.int64, ndmin=2)
    # the plain per-node route of the same configuration (the module is
    # imported only now: runpy runs it as __main__, not as an import)
    from repro_torch.launch import sim as tsim

    wl280, plat280, sched, ecfg = tsim.engine_config(run_cfg, dev)
    s_p = engine.simulate(plat280, wl280, dataclasses.replace(ecfg, fused_kernel=False),
                          device=dev)
    n_batches = int(s_p.n_batches)
    by_part["launch RL:groups"] = cli_launches
    check(cli_launches["event_fuse_occ"] == n_batches
          and cli_launches["event_fuse_ledger"] == cli_launches["event_fuse"] == 0,
          f"phase 12 (d): launches {cli_launches}, {n_batches} event_fuse_occ expected")
    dp = metrics.np_state(s_p)
    ids = wl280.arrays()["job_id"]
    check(np.array_equal(jobs[:, 0], ids)
          and np.array_equal(jobs[:, 1], dp["job_start"][:len(ids)])
          and np.array_equal(jobs[:, 2], dp["job_finish"][:len(ids)]),
          "phase 12 (d): the command line's schedule != the plain route's")
    m_p = metrics.metrics_from_state(s_p, plat280)
    check(cli_row == json.loads(json.dumps({"scheduler": sched, "timeout": ecfg.timeout,
                                            **m_p.row()})),
          "phase 12 (d): the command line's metrics (energy included) != the plain "
          "route's")
    print(f"phase 12 (d) launch: (b)'s policy saved and run by python -m "
          f"repro_torch.launch.sim (EASY RL:groups, decision interval 600) on "
          f"curie_platform(280), 120 replayed jobs, grouped tables: wrote {wrote} in "
          f"{cli_wall:.1f} s, {n_batches} batches with one event_fuse_occ launch each; "
          f"its schedule and metrics.json (energy included) == the plain per-node route "
          f"bit for bit; total {m_p.total_energy_j / 3.6e6:.3f} kWh, mean wait "
          f"{m_p.mean_wait_s:.1f} s", flush=True)

    # ---- (e) a sweep of DVFS and RL rows ----
    dplat = dvfs_platform_example(280)
    labels = ["EASY DVFS", "EASY PSUS+DVFS", "EASY RL"]
    scfg = EngineConfig(timeout=1800, node_order="cheap", grouped_tables=True)
    reset_counts()
    t0 = time.perf_counter()
    b = sweep.sweep(dplat, wl280, labels, scfg, device=dev)
    sweep_wall = time.perf_counter() - t0
    iters = int(b.states.n_batches.max())
    launches("sweep dvfs/rl", "event_fuse_occ", iters)
    for i, label in enumerate(labels):
        base, pol = from_label(label)
        single = engine.simulate(dplat, wl280, dataclasses.replace(scfg, base=base,
                                                                   policy=pol), device=dev)
        da, ds = metrics.np_state(b.state_at(i)), metrics.np_state(single)
        bad = [k for k in da if not np.array_equal(da[k], ds[k])]
        check(not bad, f"phase 12 (e): sweep row {label} fields {bad} != its single run")
    print(f"phase 12 (e) sweep: {labels} on dvfs_platform_example(280), 120 replayed "
          f"jobs, grouped: {iters} iterations in {sweep_wall:.2f} s with one "
          f"event_fuse_occ launch each; each row == its single run bit for bit; phase "
          f"wall {time.perf_counter() - t12:.1f} s", flush=True)
    return by_part


# phase 13 (a): benchmarks/bench_energy.py's defaults (the nasa_ipsc preset
# cut to 400 jobs, its 128 nodes, the six timeout schedulers x timeouts of
# 5, 15, 30 and 60 minutes)
FIG45_SCHEDULERS = tuple(f"{b} {p}" for p in ("PSUS", "PSAS", "PSAS+IPM")
                         for b in ("FCFS", "EASY"))
FIG45_TIMEOUTS = (300, 900, 1800, 3600)
# the (scheduler, timeout) rows phase 13 (a) holds against the oracle
FIG45_ORACLE_ROWS = (("FCFS PSUS", 300), ("EASY PSAS", 900),
                     ("FCFS PSAS+IPM", 1800), ("EASY PSAS+IPM", 3600))
# phase 13 (b): benchmarks/bench_forecast.py's grid on grouped tables
FORECAST_SCHEDULERS = ("EASY PSUS", "EASY PSUS+Forecast", "EASY RL:groups")


def fig45_experiment(out=None):
    """Phase 13 (a)'s spec: ``bench_energy.py``'s Figs. 4/5 grid."""
    from repro_torch.experiments import Experiment

    return Experiment(
        name="fig45_nasa_ipsc", workload={"preset": "nasa_ipsc", "n_jobs": 400},
        platform=128, schedulers=FIG45_SCHEDULERS, timeouts=FIG45_TIMEOUTS, out=out)


def fig45_oracle_inputs():
    """(platform, workload, config) of each of FIG45_ORACLE_ROWS, as the
    runner runs them (the spec's engine config under the row's label)."""
    from repro_torch.core.policy import from_label
    from repro_torch.experiments import resolve_platform, resolve_workload

    exp = fig45_experiment()
    plat, wl = resolve_platform(exp.platform), resolve_workload(exp.workload)
    out = []
    for label, timeout in FIG45_ORACLE_ROWS:
        base, pol = from_label(label)
        out.append((plat, wl, dataclasses.replace(
            exp.engine_config(), base=base, policy=pol, timeout=timeout)))
    return out


@contextlib.contextmanager
def sweep_iterations():
    """Record each ``sweep.run_sim`` call's loop iterations (its longest
    row's ``n_batches``, read once after the loop) in the yielded list."""
    from repro_torch.core import sweep

    iters, real = [], sweep.run_sim

    def counting(s, g, cfg, cap):
        out = real(s, g, cfg, cap)
        iters.append(int(out.n_batches.max()))
        return out

    sweep.run_sim = counting
    try:
        yield iters
    finally:
        sweep.run_sim = real


def phase13(torch, np, tmp, fig45_oracles, e8_rows, dev="cuda"):
    """Phase 13: the experiment layer and the service on ``dev``. (a) the
    Figs. 4/5 grid through ``experiments.run``, rows held against single
    runs and the oracle; (b)
    ``bench_forecast.py``'s grid on grouped tables with a checkpointed
    RL:groups controller, every row against its single run; (c) five
    requests to one ``SimService``, the Curie grid's rows against phase 11's
    dense E = 8 rows (``e8_rows``: (scheduler, timeout) -> metrics row).
    Returns the event kernels' launches of each part, by kernel."""
    from repro_torch import experiments
    from repro_torch.core import engine, metrics, sweep
    from repro_torch.core.policy import RLController, from_label
    from repro_torch.core.rl.actions import action_space_size
    from repro_torch.core.rl.features import feature_size
    from repro_torch.core.rl.networks import policy_init
    from repro_torch.experiments.runner import _engine_config_with_rl, _row
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import sim_serve
    from repro_torch.training.checkpoint import save_policy
    from repro_torch.workloads.platform import curie_platform
    from repro_torch.workloads.traces import synthesize_curie_swf

    t13 = time.perf_counter()
    by_part = {}

    def counted(part, fn, kname):
        """``fn()`` with the launch and host-read counters reset and the
        sweeps' iterations recorded: (its result, wall, iterations, host
        reads); every iteration launched ``kname`` once and nothing else."""
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0
        with sweep_iterations() as iters:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = dict(event_fuse.LAUNCHES)
        by_part[part] = got
        n = sum(iters)
        check(n > 0 and got[kname] == n
              and all(v == 0 for k, v in got.items() if k != kname)
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 13 {part}: launches {got}, {n} {kname} expected (one an iteration)")
        check(engine.HOST_SYNCS <= 2 * n,
              f"phase 13 {part}: {engine.HOST_SYNCS} host syncs for {n} iterations")
        return out, wall, n, engine.HOST_SYNCS

    # ---- (a) the Figs. 4/5 grid ----
    out_a = os.path.join(tmp, "fig45")
    exp = fig45_experiment(out=out_a)
    res, wall_a, iters_a, syncs_a = counted(
        "a", lambda: experiments.run(exp, device=dev), "event_fuse_ledger")
    check(len(res.rows) == 24 and res.n_compiles is None
          and not any(r.get("truncated") for r in res.rows),
          f"phase 13 (a): {len(res.rows)} rows")
    plat_a = experiments.resolve_platform(exp.platform)
    wl_a = experiments.resolve_workload(exp.workload)
    by_row = {(r["scheduler"], r["timeout"]): r for r in res.rows}
    singles, t0 = {}, time.perf_counter()
    for label, timeout in FIG45_ORACLE_ROWS:  # the rows the oracle holds
        base, pol = from_label(label)
        cfg = dataclasses.replace(exp.engine_config(), base=base, policy=pol,
                                  timeout=timeout)
        s = engine.simulate(plat_a, wl_a, cfg, device=dev)
        sc = {"scheduler": label, "timeout": timeout}
        check(_row(sc, 0, metrics.metrics_from_state(s, plat_a)) == by_row[label, timeout],
              f"phase 13 (a): row {sc} != its single run")
        singles[label, timeout] = s, cfg
    singles_wall = time.perf_counter() - t0
    worst = 0.0
    for (label, timeout), oracle in zip(FIG45_ORACLE_ROWS, fig45_oracles):
        s, cfg = singles[label, timeout]
        same, rel, _ = held_against_oracle(metrics, np, plat_a, wl_a, cfg, s,
                                           oracle.get())
        check(same and rel <= 1e-5,
              f"phase 13 (a): row {label} {timeout} vs the oracle: schedule {same}, "
              f"energy rel {rel}")
        worst = max(worst, rel)
    print(f"phase 13 (a) experiments.run: bench_energy.py's grid (nasa_ipsc, 400 jobs, "
          f"128 nodes, 6 schedulers x timeouts {list(FIG45_TIMEOUTS)}, E = 24): wall "
          f"{wall_a:.2f} s, {wall_a / 24:.3f} s a scenario; "
          f"iterations {iters_a}, {1e6 * wall_a / iters_a:.1f} us an iteration; "
          f"event_fuse_ledger launches {iters_a}, host syncs {syncs_a} "
          f"({syncs_a / iters_a:.3f} an iteration); the {len(singles)} oracle rows == "
          f"their single runs "
          f"({singles_wall:.2f} s for {len(singles)}) and the oracle's schedule (energy rel "
          f"{worst:.2e})", flush=True)

    # ---- (b) bench_forecast.py's grid, grouped ----
    plat_b = curie_platform(280)
    swf2k = synthesize_curie_swf(os.path.join(tmp, "curie2000.swf"), n_jobs=2000)
    ckpt = os.path.join(tmp, "forecast_policy")
    obs, n_act = feature_size("compact"), action_space_size(
        "group_target_fraction", 9, plat_b.n_groups())
    save_policy(ckpt, policy_init(torch.Generator(device=dev).manual_seed(0), obs, n_act),
                obs_size=obs, n_actions=n_act, feature="compact",
                action="group_target_fraction", n_levels=9, grouped=True,
                n_groups=plat_b.n_groups())
    exp_b = experiments.Experiment(
        name="forecast_bench",
        workload={"swf": swf2k, "nb_nodes": 280, "oversize": "clamp", "max_jobs": 200},
        platform=280, schedulers=FORECAST_SCHEDULERS, timeouts=(1800,),
        forecasts=(0, 1800), rl={"checkpoint": ckpt, "decision_interval": 1800},
        node_order="cheap", grouped_tables=True)
    res_b, wall_b, iters_b, syncs_b = counted(
        "b", lambda: experiments.run(exp_b, platform=plat_b, device=dev), "event_fuse_occ")
    check(len(res_b.rows) == 6, f"phase 13 (b): {len(res_b.rows)} rows")
    wl_b = experiments.resolve_workload(exp_b.workload)
    cfg_b = _engine_config_with_rl(exp_b, plat_b, dev)
    t0 = time.perf_counter()
    singles_b = {}
    for sc, row in zip(exp_b.grid(), res_b.rows):
        base, pol = from_label(sc["scheduler"])
        # the horizon is read by rule 10 alone (the controller's "compact"
        # features do not read it): the rows of a label without rule 10
        # share one single run
        horizon = sc["forecast"] if pol.flags()["forecast_enabled"] else 0
        key = sc["scheduler"], horizon
        if key not in singles_b:
            if isinstance(pol, RLController):
                pol = cfg_b.policy  # the same checkpointed controller
            cfg = dataclasses.replace(cfg_b, base=base, policy=pol,
                                      forecast_horizon=horizon, timeout=sc["timeout"])
            singles_b[key] = metrics.metrics_from_state(
                engine.simulate(plat_b, wl_b, cfg, device=dev), plat_b)
        check(_row(sc, 0, singles_b[key]) == row,
              f"phase 13 (b): row {sc} != its single run")
    singles_b_wall = time.perf_counter() - t0
    rb = {(r["scheduler"], r["forecast"]): r for r in res_b.rows}

    def drop(r, *keys):
        return {k: v for k, v in r.items() if k not in keys}

    check(drop(rb["EASY PSUS", 0], "forecast") == drop(rb["EASY PSUS", 1800], "forecast")
          and drop(rb["EASY PSUS+Forecast", 0], "scheduler")
          == drop(rb["EASY PSUS", 0], "scheduler"),
          "phase 13 (b): the horizon-0 identity")
    print(f"phase 13 (b) forecast grid: bench_forecast.py's {list(FORECAST_SCHEDULERS)} "
          f"x timeout 1800 x forecasts (0, 1800) on curie_platform(280), the first 200 "
          f"jobs of a 2000-line synthesized Curie SWF, node_order cheap, grouped tables, "
          f"a random-init RL:groups policy (decision interval 1800): wall {wall_b:.2f} s, "
          f"{wall_b / 6:.3f} s a scenario; iterations {iters_b}, event_fuse_occ launches "
          f"{iters_b}, host syncs {syncs_b} ({syncs_b / iters_b:.3f} an iteration); each "
          f"row == its single run ({singles_b_wall:.2f} s for {len(singles_b)}); horizon 0 "
          f"== the reactive "
          f"base; total kWh "
          + ", ".join(f"{s} h{f}: {r['total_energy_kwh']:.3f}" for (s, f), r in rb.items()),
          flush=True)

    # ---- (c) the service, in process ----
    sweep.clear_cache()
    service = sim_serve.SimService(os.path.join(tmp, "serve"), chunk_scenarios=4,
                                   device=dev)
    small = dict(workload={"preset": "fig3_small", "n_jobs": 30}, platform=16,
                 schedulers=("EASY PSUS", "FCFS PSAS"))
    curie = dict(workload={"preset": "cea_curie", "n_jobs": SWEEP_JOBS, "nb_res": 11200,
                           "max_res": 8192},
                 platform=11200, schedulers=SWEEP_SCHEDULERS, timeouts=(300, 600, 900, 1200))
    requests = [
        ("user-a", dict(name="user-a", timeouts=(60, 600), **small)),
        ("user-b", dict(name="user-b", timeouts=(120, 1200), **small)),
        ("profiles", dict(name="profiles", workload="profiles", platform=128,
                          schedulers=("EASY PSUS", "EASY PSAS+IPM"), timeouts=(300, 1800))),
        ("curie", dict(name="curie", **curie)),
        ("bad", dict(name="bad", workload=os.path.join(tmp, "no-such-workload.json"),
                     platform=16)),
    ]
    for name, spec in requests:
        service.submit(name, spec)
    responses, wall_c, iters_c, syncs_c = counted("c", service.drain, "event_fuse_ledger")
    by = {r["request"]: r for r in responses}
    check(sorted(by) == sorted(n for n, _ in requests), f"phase 13 (c): {sorted(by)}")
    check(by["bad"]["status"] == "error"
          and all(by[n]["status"] == "done" for n in by if n != "bad"),
          f"phase 13 (c): statuses {[(n, r['status']) for n, r in by.items()]}")
    a, b = by["user-a"], by["user-b"]
    check(a["compile_cache"]["misses"] >= 1
          and b["compile_cache"] == {"hits": b["chunks"], "misses": 0},
          f"phase 13 (c): the second same-shaped request {b['compile_cache']}")
    check((by["curie"]["rows"], by["curie"]["chunks"]) == (8, 2)
          and by["profiles"]["rows"] == 4, "phase 13 (c): curie and profiles rows")
    with open(os.path.join(by["curie"]["out"], "metrics.json")) as f:
        curie_rows = json.load(f)["rows"]
    for r in curie_rows:
        want = e8_rows[r["scheduler"], r["timeout"]]
        check({k: v for k, v in r.items() if k not in ("scheduler", "timeout",
                                                        "replication")} == want,
              f"phase 13 (c): curie row {r['scheduler']} {r['timeout']} != phase 11's")
    print(f"phase 13 (c) service: 5 requests to one SimService (chunk_scenarios 4), "
          f"drained in {wall_c:.2f} s: iterations {iters_c}, event_fuse_ledger launches "
          f"{iters_c}, host syncs {syncs_c}; "
          + "; ".join(f"{n} {r['status']} wall {r.get('wall_s')} s rows {r.get('rows')} "
                      f"chunks {r.get('chunks')} cache {r.get('compile_cache')}"
                      for n, r in by.items())
          + f"; the Curie rows == phase 11's dense E = 8 rows bit for bit; bad: "
          f"{by['bad'].get('error', '')[:80]}; phase wall {time.perf_counter() - t13:.1f} s",
          flush=True)
    return by_part


def flash_per_prefill(cfg) -> int:
    """Flash launches of one prefill: one per attention — a layer's, a
    super-block's shared block's, or whisper's encoder, self and cross
    attention."""
    n = cfg.block_program()[0][1]
    return 2 * n + cfg.encoder_layers if cfg.encoder_layers else n


def random_front_end(torch, np, cfg, batch, dev, seed=2):
    """Seeded standard normal image embeds or encoder frames for ``batch``
    sequences of ``cfg``, in its dtype, as ``prefill`` keywords."""
    from repro_torch.launch import serve

    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)).to(
        dev, cfg.dtype) for k, v in serve.front_end_inputs(cfg, batch, "cpu").items()}


def phase14(torch, np, dev="cuda"):
    """Phase 14: each of ``ARCHS14`` served at full width (and depth, or
    its serve depth) in bf16 with random weights from seed 0
    (``SERVE14_ARGS``; the reference loop's zero image embeds and encoder
    frames) on ``dev``, its kernel launches counted, its refilled requests
    held against their own decode, then its f32 kernel route against the
    plain route at full width and cut depth (random front-end inputs; for
    the MoE, the smallest margin between the k-th and (k+1)-th router
    probability of either route). Returns {arch: the serve's launches by
    counter}."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    t14 = time.perf_counter()
    n_req, max_new, prompt_len, cache_len = 8, 32, 1024, 1280
    launches = {}
    for arch, (n_flash, route, n_ssd, depth, layers) in ARCHS14.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        check(fa.variant(cfg.dtype, cfg.hd) == route,
              f"{arch}: flash_attention.variant names {fa.variant(cfg.dtype, cfg.hd)}, "
              f"not {route}")
        check(n_flash == n_req * flash_per_prefill(cfg),
              f"{arch}: {n_flash} flash launches expected, {n_req} prefills of "
              f"{flash_per_prefill(cfg)}")
        stats = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        result = serve.main(["--arch", arch] + SERVE14_ARGS + ["--device", dev], stats=stats,
                            config=cfg)
        got = dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"])
        events = dict(event_fuse.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches[arch] = got
        check(got["flash_attention"] == got[f"flash_attention_{route}"] == n_flash
              and got["ssd_scan"] == n_ssd,
              f"{arch} serve: launches {got}, expected {n_flash} flash on {route} and "
              f"{n_ssd} ssd_scan")
        check(not any(events.values()), f"{arch} serve launched {events}")
        check((result["requests"], result["decode_steps"], result["total_tokens"])
              == (n_req, 2 * (max_new - 1), n_req * max_new), f"{arch} serve counts {result}")
        toks = [t for ts in stats["tokens"].values() for t in ts]
        check(len(toks) == n_req * max_new and all(0 <= t < cfg.padded_vocab for t in toks),
              f"{arch} serve tokens")
        pre_ms = [1e3 * x for x in stats["prefill_s"]]
        dec_ms = [1e3 * x for x in stats["decode_s"]]

        # the refilled requests against their own prefill + decode, on
        # serve's weights, prompts and front-end inputs
        model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        prompt_rng = np.random.default_rng(0)
        queue = [prompt_rng.integers(0, cfg.vocab_size, size=prompt_len)
                 for _ in range(n_req)]
        # an MoE's refilled requests are held at the serve's batch shape (4
        # rows): a bf16 routing choice tips between a batch of 4 and of 1
        # (PERF.md §6, the MoE's refill finding), so their decode as 1 row is
        # printed, not held
        extras = serve.front_end_inputs(cfg, 1, dev)
        rows = 4 if cfg.n_experts else 1
        gaps, exact = refill_gaps(torch, model, queue, stats["tokens"], REFILLED14, cache_len,
                                  dev, extras, rows)
        check(max(gaps) <= REFILL_TOL,
              f"{arch} serve: a refilled request's token is {max(gaps):.4g} of the largest "
              f"|logit| below its own decode's maximum (tolerance {REFILL_TOL})")
        one_row = ""
        if rows > 1:
            gaps1, exact1 = refill_gaps(torch, model, queue, stats["tokens"], REFILLED14,
                                        cache_len, dev, extras)
            one_row = (f"; decoded as 1 row: {exact1} of {len(gaps1)} the greedy maximum, "
                       f"largest gap {max(gaps1):.4g} (not held)")
        # one decode step of the 4 slots at [4] positions, as serve runs it,
        # profiled, and for the hybrid one prefill (1 x 1024 tokens) too (a
        # profile costs seconds of host time: the dense prefills are
        # internlm2's, profiled in phase 8, at other widths)
        prompt = torch.from_numpy(queue[0][None]).to(dev)
        cache4 = model.init_cache(4, cache_len)
        tok4 = torch.zeros((4, 1), dtype=torch.int64, device=dev)
        pos4 = torch.full((4,), 1100, dtype=torch.int64, device=dev)
        parts = {"decode step": lambda: model.decode_step(tok4, cache4, pos4)}
        if n_ssd:
            parts["prefill"] = lambda: model.prefill(prompt, cache_len=cache_len)
        with torch.inference_mode():
            prof = {part: profile_split(torch, fn, calls=1) for part, fn in parts.items()}
        del model, cache4
        torch.cuda.empty_cache()

        # the kernel route against the plain route, full width, cut depth, f32
        cut = cfg.replace(dtype_name="float32", n_layers=depth,
                          encoder_layers=depth if cfg.encoder_layers else 0)
        n_attn = flash_per_prefill(cut)
        n_mamba = cut.block_program()[0][1] * cut.mamba_per_super if n_ssd else 0
        model = build_model(cut, dev).init(torch.Generator(device=dev).manual_seed(0))
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, prompt_len))).to(dev)
        front = random_front_end(torch, np, cut, 2, dev)
        margins = []

        def router_margin(module, args, out):
            top = torch.softmax(args[0].float() @ module.router, -1).topk(
                module.top_k + 1, dim=-1).values
            margins.append(float((top[..., -2] - top[..., -1]).min()))

        hooks = [b.moe.register_forward_hook(router_margin) for b in model.blocks
                 if hasattr(b, "moe")]
        with torch.inference_mode():
            fa.reset_launches()
            ssd.reset_launches()
            model.attn_impl, model.gla_impl = "auto", "auto"
            logits_k = model.prefill(prompts, **front)[0][:, -1]
            torch.cuda.synchronize()
            k_got = dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"])
            check(k_got["flash_attention"] == k_got["flash_attention_simt"] == n_attn
                  and k_got["ssd_scan"] == n_mamba,
                  f"{arch} f32 prefill: launches {k_got}, expected {n_attn} SIMT flash and "
                  f"{n_mamba} ssd_scan")
            model.attn_impl, model.gla_impl = "naive", "plain"
            logits_p = model.prefill(prompts, **front)[0][:, -1]
            check(dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"]) == k_got,
                  f"{arch}: the plain route launched a kernel")
        for hook in hooks:
            hook.remove()
        scale = float(logits_p.abs().max())
        diff = float((logits_k - logits_p).abs().max())
        tok_k, tok_p = logits_k.argmax(-1).tolist(), logits_p.argmax(-1).tolist()
        top2 = logits_p.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        del model, logits_k, logits_p, front
        torch.cuda.empty_cache()
        routing = (f"; smallest router margin (k-th less (k+1)-th probability) of "
                   f"{len(margins)} MoE layer calls {min(margins):.3g}" if margins else "")
        check(diff <= LOGITS_REL_TOL * max(scale, 1.0),
              f"{arch} f32 logits: kernel route vs plain route max abs diff {diff} > "
              f"{LOGITS_REL_TOL} x {scale}{routing}")
        check(tok_k == tok_p,
              f"{arch} f32 greedy tokens: kernel {tok_k} vs plain {tok_p}{routing}")
        f32_depth = (f"{depth} encoder and {depth} decoder layers" if cut.encoder_layers
                     else f"{depth} layers")
        print(f"phase 14 serve: {arch} full width bf16 on cuda ({cfg.n_layers} layers"
              f"{f' (of {get_arch(arch).n_layers})' if layers is not None else ''}"
              f"{f' and {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}"
              f", d {cfg.d_model}, H {cfg.n_heads}, KH {cfg.n_kv_heads}, hd {cfg.hd}"
              f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}; "
              f"{weights_gb:.2f} GB of weights), 8 requests x 1024 tokens, 4 slots, 32 new "
              f"tokens, cache 1280, per-slot positions: {result}; flash_attention launches "
              f"{got['flash_attention']} all {route}, ssd_scan calls {got['ssd_scan']}, no "
              f"event kernel; prefill first {pre_ms[0]:.2f} ms, median of the rest "
              f"{statistics.median(pre_ms[1:]):.2f} ms per request; decode median "
              f"{statistics.median(dec_ms):.3f} ms, mean {statistics.fmean(dec_ms):.3f} ms "
              f"per step ({len(dec_ms)} steps); peak device memory {peak_gib:.2f} GiB; "
              f"refilled requests {REFILLED14} against their own decode at {rows} "
              f"row(s): {exact} of {len(gaps)} tokens the greedy maximum, largest gap "
              f"{max(gaps):.4g} (tolerance {REFILL_TOL}){one_row}; f32 at {f32_depth}, 2 x "
              f"1024-token prompts, kernel route ({n_attn} SIMT flash, {n_mamba} ssd_scan) vs plain route: "
              f"last-position logits max abs diff {diff:.3g} (largest |logit| {scale:.3g}, "
              f"tolerance {LOGITS_REL_TOL} of it), greedy tokens {tok_k} == {tok_p} (top-2 "
              f"margin {margin:.3g}){routing}; arch wall {time.perf_counter() - t_arch:.1f} s",
              flush=True)
        for part, (by_kind, ops, n_dev, _, seen, wall, _) in prof.items():
            dev_ms = sum(by_kind.values())
            print(f"phase 14 serve: {arch} one bf16 {part} profiled: wall {wall:.2f} ms, "
                  f"{ops:.0f} top-level host ops, {n_dev} device ops, device {dev_ms:.3f} ms "
                  f"(busy {100 * dev_ms / wall:.1f} %): "
                  + ", ".join(f"{k} {ms:.3f} ms" for k, ms in by_kind.items())
                  + f" (records seen {seen:.3f})", flush=True)
    print(f"phase 14 dense, hybrid, MoE, VLM and encoder-decoder archs: wall "
          f"{time.perf_counter() - t14:.1f} s", flush=True)
    return launches


def phase15(torch, np, tmp):
    """Phase 15: LM training on the card (see the module docstring). Returns
    the flash and ``ssd_scan`` launches of (a)'s steps (none), and for phase
    18 (a) the steps' median ms, the peak device memory and the dry run's
    count of one more step."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.models.convert import (
        params_from_arrays, params_to_arrays, reference_leaves,
    )
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts

    t15 = time.perf_counter()
    dev = "cuda"
    sync = torch.cuda.synchronize

    def kernel_launches():
        return {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_scan": ssd.LAUNCHES["ssd_scan"]}

    # ---- (a) the full-width model, trained ----
    cfg = get_arch(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    opt = tts.make_optimizer("adamw", topt.cosine_schedule(3e-4, 2, TRAIN_STEPS))
    step = tts.make_train_step(model, opt)
    state = tts.init_opt_state(model, opt)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    # matrices (a bf16 norm gain at 1.0 does not move: its ulp is 2**-7, an
    # update at these rates about 3e-4)
    watched = {"embed": model.embed.weight, "blocks.0.attn.wq": model.blocks[0].attn.wq.weight,
               "blocks.-1.mlp.w_down": model.blocks[-1].mlp.w_down.weight,
               "lm_head": model.lm_head.weight}
    before = {k: v.detach().clone() for k, v in watched.items()}
    launches0 = kernel_launches()
    ms, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = stream.batch_at(i)
        sync()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        sync()
        ms.append(1e3 * (time.perf_counter() - t))
    check(all(np.isfinite(losses + gnorms)),
          f"phase 15 (a): losses {losses}, gradient norms {gnorms}")
    moved = {k: float((v.detach().float() - before[k].float()).abs().max())
             for k, v in watched.items()}
    check(all(x > 0 for x in moved.values()), f"phase 15 (a): parameters moved {moved}")
    check(int(state.step) == TRAIN_STEPS, f"phase 15 (a): optimizer step {int(state.step)}")
    peak_bytes = torch.cuda.max_memory_allocated()  # over the 8 steps
    peak_gib = peak_bytes / 2**30
    median = statistics.median(ms[1:])
    # the copies the step makes to run the optimizer on the reference's
    # leaves: the parameters stacked, then written back
    leaves = reference_leaves(model)
    sync()
    t = time.perf_counter()
    stacked = [leaf.stack() for leaf in leaves]
    sync()
    stack_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    for leaf, p in zip(leaves, stacked):
        leaf.write(p)
    sync()
    write_ms = 1e3 * (time.perf_counter() - t)
    del stacked
    # one more step (after profile_split's warm-up step), profiled
    holder = [state]
    extra = stream.batch_at(TRAIN_STEPS)

    def one_step():
        holder[0], _ = step(holder[0], extra)

    by_kind, ops, n_dev, _, seen, wall, each = profile_split(torch, one_step, calls=1)
    dev_ms = sum(by_kind.values())
    rest = sorted(((ms, k) for k, ms in each.items() if kernel_kind(k) != "matmul"),
                  reverse=True)[:6]
    train_launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    check(not any(train_launches.values()),
          f"phase 15 (a): the training steps launched {train_launches}")
    # one more step, counted by the dry run's counter (phase 18 (a))
    from repro_torch.launch import dryrun

    sync()
    t = time.perf_counter()
    _, counter = dryrun.count(one_step)
    sync()
    p18 = {"median_ms": median, "peak_bytes": peak_bytes, "losses": losses,
           "count": counter.record(), "count_ms": 1e3 * (time.perf_counter() - t)}
    n_params = model.n_params()
    del model, state, step, holder, before
    torch.cuda.empty_cache()
    a_s = time.perf_counter() - t15
    print(f"phase 15 (a) train: {cfg.name} full width {str(cfg.dtype).split('.')[1]} "
          f"({cfg.n_layers} layers, d {cfg.d_model}, remat {cfg.remat}; {n_params:,} params), "
          f"adamw (bf16 moments) on cosine_schedule(3e-4, 2, {TRAIN_STEPS}), "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens on {dev}: losses "
          f"{[round(x, 4) for x in losses]}, gradient norms {[round(x, 3) for x in gnorms]}; "
          f"largest moves {moved}; flash/ssd_scan launches during the steps {train_launches}; "
          f"step ms {[round(x, 2) for x in ms]}, median over steps 2-{TRAIN_STEPS} "
          f"{median:.2f} ms, {TRAIN_BATCH * TRAIN_SEQ / (median / 1e3):.0f} tokens/s; peak "
          f"device memory {peak_gib:.2f} GiB; stacking the {len(leaves)} reference leaves "
          f"{stack_ms:.2f} ms, writing them back {write_ms:.2f} ms; one step profiled: wall "
          f"{wall:.2f} ms, {ops:.0f} top-level host ops, {n_dev} device ops, device "
          f"{dev_ms:.3f} ms (busy {100 * dev_ms / wall:.1f} %): matmuls "
          f"{by_kind['matmul']:.3f} ms, the rest {dev_ms - by_kind['matmul']:.3f} ms (records "
          f"seen {seen:.3f}), its largest: "
          + "; ".join(f"{k[:90]} {ms:.3f} ms" for ms, k in rest)
          + f"; wall {a_s:.1f} s", flush=True)

    # ---- (d), started here: the launcher's run that crashes, a process of
    # its own (it exits hard); the uninterrupted run and the restart are
    # calls of the launcher's main in this process, which saves two process
    # starts (about 25 s each on the card's machine)
    from repro_torch.launch import train as launcher

    dirs = {name: os.path.join(tmp, f"train_{name}") for name in ("straight", "crashed")}

    def argv(name, *extra):
        return [*TRAIN_LAUNCH[2:], "--ckpt-dir", dirs[name], *extra]

    def run_main(name):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launcher.main(argv(name))
        return out.getvalue()

    crash = subprocess.Popen(
        [sys.executable, *TRAIN_LAUNCH[:2], *argv("crashed", "--fail-at", "12")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC), cwd=ROOT)
    try:
        # ---- (b) the guard ----
        q, k, v = (torch.randn((1, 128, 16, 128), device=dev, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3))
        n0 = kernel_launches()
        refused = ""
        try:
            fa.flash_attention(q, k, v, causal=True)
        except RuntimeError as e:
            refused = str(e)
        check("no backward" in refused and kernel_launches() == n0,
              f"phase 15 (b): flash_attention on CUDA inputs that require grad: "
              f"{refused or 'no error'}")
        print(f"phase 15 (b) guard: flash_attention on bf16 CUDA inputs that require "
              f"grad raised, no launch: {refused}", flush=True)

        # ---- (c) the reduced model in f32: the card against the CPU ----
        t_c = time.perf_counter()
        rcfg = get_arch(ARCH, reduced=True)
        tree = params_to_arrays(build_model(rcfg, "cpu").init(torch.Generator().manual_seed(0)))
        rstream = TokenStream(vocab_size=rcfg.vocab_size, seq_len=64, global_batch=4, seed=1)

        def run(device, make_opt):
            m = params_from_arrays(rcfg, tree, device)
            o = make_opt()
            s = tts.make_train_step(m, o)
            st = tts.init_opt_state(m, o)
            out = []
            for i in range(3):
                st, met = s(st, rstream.batch_at(i))
                out.append(float(met["loss"]))
            return out, [(leaf.name, leaf.stack().cpu().numpy()) for leaf in reference_leaves(m)]

        lines = []
        for name, make in (("SGD", lambda: topt.sgd(lr=TRAIN_SGD_LR)),
                           ("AdamW", lambda: tts.make_optimizer("adamw", 1e-3))):
            (card, card_p), (host, host_p) = run(dev, make), run("cpu", make)
            rel = max(abs(a - b) / abs(b) for a, b in zip(card, host))
            check(rel <= TRAIN_REL, f"phase 15 (c) {name}: losses {card} on {dev}, {host} on "
                  f"the CPU (largest relative difference {rel:.3g})")
            line = f"{name} losses {card} vs {host} (largest relative difference {rel:.3g})"
            if name == "SGD":
                worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                            for (_, a), (_, b) in zip(card_p, host_p))
                check(worst <= TRAIN_REL,
                      f"phase 15 (c): SGD leaves {worst:.3g} of a leaf's largest entry apart")
                line += f", leaves within {worst:.3g} of each leaf's largest entry"
            lines.append(line)
        c_s = time.perf_counter() - t_c
        print(f"phase 15 (c) {dev} vs cpu: reduced {ARCH} in f32, 3 steps each from one set "
              f"of weights and batches: " + "; ".join(lines)
              + f"; wall {c_s:.1f} s (the crashing process runs meanwhile)", flush=True)

        # ---- (d) finished: the rerun starts once the crashed run has exited ----
        t_d = time.perf_counter()
        out_s = run_main("straight")
        straight_s = time.perf_counter() - t_d
        out_c, err_c = crash.communicate(timeout=600)
        wait_s = time.perf_counter() - t_d - straight_s
        check(crash.returncode == 17 and "simulated failure at step 12" in out_c,
              f"phase 15 (d): --fail-at 12 exited {crash.returncode}: {err_c[-2000:]}")
        out_r = run_main("crashed")
        d_s = time.perf_counter() - t_d
    finally:
        if crash.poll() is None:
            crash.kill()
            crash.wait()
    check("[train] resumed from step 10" in out_r and '"steps_run": 10' in out_r,
          f"phase 15 (d): the rerun printed {out_r[-2000:]}")
    done_s = json.loads(out_s.split("[train] done: ")[1])
    done_r = json.loads(out_r.split("[train] done: ")[1])
    rel = abs(done_r["last_loss"] - done_s["last_loss"]) / abs(done_s["last_loss"])
    check(rel <= TRAIN_REL, f"phase 15 (d): last loss {done_r['last_loss']} after the restart, "
          f"{done_s['last_loss']} uninterrupted")
    print(f"phase 15 (d) launch: python {' '.join(TRAIN_LAUNCH[1:])}: --fail-at 12 (a "
          f"process) exited 17, the rerun (main in this process) resumed from step 10 and ran "
          f"10 steps (last loss {done_r['last_loss']}), the uninterrupted run (main) "
          f"{done_s['steps_run']} steps (last loss {done_s['last_loss']}; relative difference "
          f"{rel:.3g}, its steps' wall {done_s['wall_s']} s); after (c): the uninterrupted run "
          f"{straight_s:.1f} s, then waiting for the crashed process {wait_s:.1f} s, the rerun "
          f"{d_s - straight_s - wait_s:.1f} s", flush=True)
    print(f"phase 15 wall: (a) {a_s:.1f} s, (b) and the crashing process's start "
          f"{t_c - t15 - a_s:.1f} s, (c) {c_s:.1f} s, (d) after (c) {d_s:.1f} s; all "
          f"{time.perf_counter() - t15:.1f} s", flush=True)
    return train_launches, p18


SPARS_RL_ENVS = 4096  # phase 18 (b): the reference's A2C batch


def phase18(torch, np, p15, dev="cuda"):
    """Phase 18: the dry run's count on the card (see the module
    docstring). Returns the event kernels' launches of (b)'s update."""
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec

    t18 = time.perf_counter()
    smi = nvidia_smi()

    # ---- (a) phase 15's step: counted on the card and on fake tensors ----
    shape = ShapeSpec("phase15", "train", TRAIN_SEQ, TRAIN_BATCH)
    fake = dryrun.lower_cell(ARCH, shape)
    real = p15["count"]
    check(fake["status"] == "ok" and fake["accum_steps"] == 1,
          f"phase 18 (a): lower_cell {fake.get('status')}, accum {fake.get('accum_steps')}")
    check(real["flops_computed"] == fake["flops_computed"] > 0,
          f"phase 18 (a): flops_computed {real['flops_computed']} on the card, "
          f"{fake['flops_computed']} on fake tensors")
    rf = fake["roofline"]
    share = 1e3 * rf["roofline_step_s"] / p15["median_ms"]
    check(0 < share <= 1, f"phase 18 (a): share of roofline {share}")
    print(f"phase 18 (a) dry run vs the card ({smi}): {ARCH} train at {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (bf16, remat, adamw, accum 1): flops_computed {real['flops_computed']} "
          f"on the card == {fake['flops_computed']} on fake tensors; flops_per_device (the "
          f"causal half off) {fake['flops_per_device']}, hbm_bytes_per_device "
          f"{fake['hbm_bytes_per_device']}, op_bytes {fake['op_bytes']} fake / "
          f"{real['op_bytes']} card; roofline ({fake['peak']['source']}) "
          f"{1e3 * rf['roofline_step_s']:.3f} ms, {rf['dominant']}-bound (compute "
          f"{1e3 * rf['t_compute_s']:.3f} ms, memory {1e3 * rf['t_memory_s']:.3f} ms); phase "
          f"15's median step {p15['median_ms']:.2f} ms: share of roofline {100 * share:.2f} %; "
          f"args_bytes_per_device {fake['args_bytes_per_device']} "
          f"({fake['args_bytes_per_device'] / 2**30:.2f} GiB) against phase 15's peak device "
          f"memory {p15['peak_bytes']} ({p15['peak_bytes'] / 2**30:.2f} GiB); the fake count "
          f"took {fake['total_s']} s, the counted step on the card {p15['count_ms']:.0f} ms",
          flush=True)

    # ---- (b) the paper's own cell on the card ----
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    t = time.perf_counter()
    rl = dryrun.lower_spars_rl(SPARS_RL_ENVS, device=dev)
    wall = time.perf_counter() - t
    launches = dict(event_fuse.LAUNCHES)
    check(rl["status"] == "ok" and rl["flops_per_device"] > 0,
          f"phase 18 (b): spars-rl {rl.get('status')}, flops {rl.get('flops_per_device')}")
    check(all(np.isfinite(v) for v in rl["metrics"].values()),
          f"phase 18 (b): metrics {rl['metrics']}")
    check(launches["event_fuse_ledger"] > 0 and fa.LAUNCHES["flash_attention"] == 0
          and ssd.LAUNCHES["ssd_scan"] == 0,
          f"phase 18 (b): launches {launches}, flash {fa.LAUNCHES}, ssd {ssd.LAUNCHES}")
    rrf = rl["roofline"]
    print(f"phase 18 (b) spars-rl on the card ({smi}): one A2C update, {SPARS_RL_ENVS} envs of "
          f"64 nodes and 128 jobs, EASY RL at decision interval 600, 8 steps: wall "
          f"{wall:.2f} s (the update {rl['update_s']} s), flops_per_device "
          f"{rl['flops_per_device']}, hbm_bytes_per_device {rl['hbm_bytes_per_device']}, "
          f"op_bytes {rl['op_bytes']}, {rl['n_ops']} ops; roofline {rrf['roofline_step_s']:.3g} s "
          f"({rrf['dominant']}); event-kernel launches {launches}; metrics {rl['metrics']}",
          flush=True)
    print(f"phase 18 wall {time.perf_counter() - t18:.1f} s", flush=True)
    return launches


def kernel_vs_plain_f32(torch, np, cfg, stages, want, dev="cuda"):
    """A program at ``cfg``'s full width in f32 from seed 0: two 1024-token
    prompts through ``prefill`` on the kernel routes, then on the plain
    routes. ``want`` is the kernel launches expected ({counter: n}); the
    plain routes must launch none. Returns (max abs diff of the
    last-position logits, the largest |logit|, the kernel route's greedy
    tokens, the plain route's, their top-2 margin)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model

    cut = cfg.replace(dtype_name="float32", stages=stages)
    model = build_model(cut, dev).init(torch.Generator(device=dev).manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1024))).to(dev)
    with torch.inference_mode():
        fa.reset_launches()
        ssd.reset_launches()
        model.attn_impl, model.gla_impl = "auto", "auto"
        logits_k = model.prefill(prompts)[0][:, -1]
        torch.cuda.synchronize()
        got = dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"])
        check(all(got[k] == n for k, n in want.items()),
              f"{stages} f32 prefill: launches {got}, expected {want}")
        model.attn_impl, model.gla_impl = "naive", "plain"
        logits_p = model.prefill(prompts)[0][:, -1]
        check(dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"]) == got,
              f"{stages}: the plain routes launched a kernel")
    scale = float(logits_p.abs().max())
    diff = float((logits_k - logits_p).abs().max())
    tok_k, tok_p = logits_k.argmax(-1).tolist(), logits_p.argmax(-1).tolist()
    top2 = logits_p.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    del model, logits_k, logits_p
    torch.cuda.empty_cache()
    check(diff <= LOGITS_REL_TOL * max(scale, 1.0),
          f"{stages} f32 logits: kernel routes vs plain routes max abs diff {diff} > "
          f"{LOGITS_REL_TOL} x {scale}")
    check(tok_k == tok_p, f"{stages} f32 greedy tokens: kernel {tok_k} vs plain {tok_p}")
    return diff, scale, tok_k, tok_p, margin


def flag(args, name: str) -> int:
    """The int value of ``name`` in a command line ``args``."""
    return int(args[args.index(name) + 1])


def serve_program(torch, np, cfg, args, want, what, refilled=(), dev="cuda"):
    """``serve.main`` of ``cfg`` (bf16, seed-0 weights) with ``args`` on
    ``dev``: its kernel launches must be ``want`` ({counter: n}) and no event
    kernel, every request served, and each of ``refilled`` held against its
    own decode at the serve's batch shape (4 rows). Returns (the launches,
    the result, a text of the check and the times)."""
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    n_req, max_new = flag(args, "--requests"), flag(args, "--max-new")
    prompt_len, cache_len = flag(args, "--prompt-len"), flag(args, "--cache-len")
    stats = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    result = serve.main(args + ["--device", dev], stats=stats, config=cfg)
    got = dict(fa.LAUNCHES, ssd_scan=ssd.LAUNCHES["ssd_scan"])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(got[k] == n for k, n in want.items()),
          f"{what} serve: launches {got}, expected {want}")
    check(not any(event_fuse.LAUNCHES.values()),
          f"{what} serve launched {dict(event_fuse.LAUNCHES)}")
    waves = -(-n_req // flag(args, "--slots"))
    check((result["requests"], result["decode_steps"], result["total_tokens"])
          == (n_req, waves * (max_new - 1), n_req * max_new), f"{what} serve counts {result}")
    toks = [t for ts in stats["tokens"].values() for t in ts]
    check(len(toks) == n_req * max_new and all(0 <= t < cfg.padded_vocab for t in toks),
          f"{what} serve tokens")
    pre_ms = [1e3 * x for x in stats["prefill_s"]]
    dec_ms = [1e3 * x for x in stats["decode_s"]]
    text = (f"{result}; launches {got}, no event kernel; prefill first {pre_ms[0]:.2f} ms, "
            f"median of the rest {statistics.median(pre_ms[1:]):.2f} ms; decode median "
            f"{statistics.median(dec_ms):.3f} ms ({len(dec_ms)} steps); peak device memory "
            f"{peak_gib:.2f} GiB")
    if refilled:
        model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(0)
        queue = [rng.integers(0, cfg.vocab_size, size=prompt_len) for _ in range(n_req)]
        gaps, exact = refill_gaps(torch, model, queue, stats["tokens"], refilled, cache_len,
                                  dev, rows=4)
        del model
        torch.cuda.empty_cache()
        check(max(gaps) <= REFILL_TOL,
              f"{what} serve: a refilled request's token is {max(gaps):.4g} of the largest "
              f"|logit| below its own decode's maximum (tolerance {REFILL_TOL})")
        text += (f"; refilled requests {refilled} against their own decode at 4 rows: "
                 f"{exact} of {len(gaps)} tokens the greedy maximum, largest gap "
                 f"{max(gaps):.4g} (tolerance {REFILL_TOL})")
    return got, result, text


def phase16(torch, np, fused_runs, swf, dev="cuda"):
    """Phase 16: (a) a block program that mixes Mamba-2 and dense stages at
    zamba2-2.7b's width and (b) standalone mLSTM and sLSTM stages at
    xlstm-350m's width, each served in bf16 and checked in f32 on the kernel
    routes against the plain routes; (c) the legacy event loop
    (``fused_events=False``) on phase 4's runs (``fused_runs``: (what,
    platform, workload, config, the fused run's state)), a dense E = 4 grid
    and a grouped B = 2 env, each bit for bit the fused loop's, with no
    event-kernel launch. Returns the launches of (a), (b) and (c), by
    counter."""
    from repro_torch.configs import get_arch
    from repro_torch.core import engine, metrics, sweep
    from repro_torch.core.policy import RLController
    from repro_torch.core.rl import a2c, env
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.workloads.platform import PlatformSpec, curie_platform
    from repro_torch.workloads.traces import rebase_submit_times, replay_workload
    from repro_torch.workloads.workload import Workload

    t16 = time.perf_counter()
    out = {}

    # ---- (a) a mixed program at zamba2-2.7b's width ----
    t0 = time.perf_counter()
    cfg = get_arch("zamba2-2.7b").replace(stages=MIXED16)
    n_req = flag(MIXED16_ARGS, "--requests")
    route = fa.variant(cfg.dtype, cfg.hd)
    check(route == "wgmma", f"phase 16 (a): flash_attention.variant names {route}")
    want = {"flash_attention": 2 * n_req, "flash_attention_wgmma": 2 * n_req,
            "flash_attention_simt": 0, "ssd_scan": 6 * n_req}
    out["mixed"], _, text = serve_program(torch, np, cfg, MIXED16_ARGS, want,
                                          "phase 16 (a)", REFILLED16, dev)
    f32 = kernel_vs_plain_f32(torch, np, cfg, MIXED16_F32,
                              {"flash_attention_simt": 1, "ssd_scan": 1}, dev)
    print(f"phase 16 (a) mixed program: zamba2-2.7b's width (d {cfg.d_model}, H "
          f"{cfg.n_heads}, hd {cfg.hd}, Mamba-2 heads "
          f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim}) with stages {MIXED16}, bf16 "
          f"on cuda, 6 requests x 1024 tokens, 4 slots, 16 new tokens, cache 1056, per-slot "
          f"positions: {text}; f32 {MIXED16_F32}, 2 x 1024-token prompts, kernel routes vs "
          f"plain routes: last-position logits max abs diff {f32[0]:.3g} (largest |logit| "
          f"{f32[1]:.3g}, tolerance {LOGITS_REL_TOL} of it), greedy tokens {f32[2]} == "
          f"{f32[3]} (top-2 margin {f32[4]:.3g}); wall {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- (b) standalone recurrent stages at xlstm-350m's width ----
    t0 = time.perf_counter()
    cfg = get_arch(XARCH).replace(stages=RECURRENT16)
    n_req = flag(RECURRENT16_ARGS, "--requests")
    # each mLSTM prefill scans twice (the values and the normaliser)
    want = {"flash_attention": 0, "ssd_scan": 2 * 2 * n_req}
    out["recurrent"], _, text = serve_program(torch, np, cfg, RECURRENT16_ARGS, want,
                                              "phase 16 (b)", (), dev)
    f32 = kernel_vs_plain_f32(torch, np, cfg, RECURRENT16_F32,
                              {"flash_attention": 0, "ssd_scan": 2}, dev)
    print(f"phase 16 (b) recurrent stages: xlstm-350m's width (d {cfg.d_model}, H "
          f"{cfg.n_heads}) with stages {RECURRENT16}, bf16 on cuda, 4 requests x 1024 "
          f"tokens, 4 slots, 8 new tokens, cache 1056: {text}; f32 {RECURRENT16_F32}, 2 x "
          f"1024-token prompts, kernel routes vs plain routes: last-position logits max abs "
          f"diff {f32[0]:.3g} (largest |logit| {f32[1]:.3g}, tolerance {LOGITS_REL_TOL} of "
          f"it), greedy tokens {f32[2]} == {f32[3]} (top-2 margin {f32[4]:.3g}); wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (c) the legacy event loop ----
    t0 = time.perf_counter()
    legacy_launches = {k: 0 for k in event_fuse.LAUNCHES}

    def add_launches():
        for k, v in event_fuse.LAUNCHES.items():
            legacy_launches[k] += v

    def same_state(a, b, what):
        da, db = metrics.np_state(a), metrics.np_state(b)
        bad = [k for k in da if not (da[k].dtype == db[k].dtype
                                     and np.array_equal(da[k], db[k]))]
        check(not bad, f"phase 16 (c) {what}: legacy fields {bad} != the fused run's")

    worst = 0.0
    for what, plat, wl, cfg, fused in fused_runs:
        legacy = dataclasses.replace(cfg, fused_events=False)
        event_fuse.reset_launches()
        s = engine.simulate(plat, wl, legacy, device=dev)
        add_launches()
        same_state(s, fused, what)
        check(metrics.metrics_from_state(s, plat).row()
              == metrics.metrics_from_state(fused, plat).row(),
              f"phase 16 (c) {what}: legacy SimMetrics != the fused run's")
        same, rel, _ = held_against_oracle(metrics, np, plat, wl, legacy, s)
        check(same and rel <= 1e-5,
              f"phase 16 (c) {what}: legacy vs the oracle: schedule {same}, energy rel {rel}")
        worst = max(worst, rel)
    runs_wall = time.perf_counter() - t0

    # a dense E = 4 grid on 280 nodes (one group: the fused grid launches
    # event_fuse_ledger once an iteration)
    t1 = time.perf_counter()
    trace = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=PHASE4_GROUPED_JOBS)
    plat = PlatformSpec(nb_nodes=280)
    grid_cfg = EngineConfig(timeout=1800)
    event_fuse.reset_launches()
    fused_b = sweep.sweep(plat, trace, LEGACY_GRID, grid_cfg, device=dev)
    grid_fused_launches = event_fuse.LAUNCHES["event_fuse_ledger"]
    event_fuse.reset_launches()
    legacy_b = sweep.sweep(plat, trace, LEGACY_GRID,
                           dataclasses.replace(grid_cfg, fused_events=False), device=dev)
    add_launches()
    for i, sc in enumerate(LEGACY_GRID):
        same_state(legacy_b.state_at(i), fused_b.state_at(i), f"grid row {sc}")
        check(legacy_b[i].row() == fused_b[i].row(), f"phase 16 (c) grid row {sc}: metrics")
    check(grid_fused_launches > 0, "phase 16 (c): the fused grid launched no ledger kernel")
    grid_wall = time.perf_counter() - t1

    # the grouped B = 2 env on curie_platform(280), 16 steps, both loops
    t1 = time.perf_counter()
    cplat = curie_platform(280)
    half = PHASE4_GROUPED_JOBS // 2
    ctrace = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=2 * half)
    wls = [rebase_submit_times(Workload(280, ctrace.jobs[i * half:(i + 1) * half]))
           for i in range(2)]
    steps = {}
    for fused_loop in (True, False):
        ecfg = EngineConfig(policy=RLController(grouped=True), rl_decision_interval=600,
                            grouped_tables=True, fused_events=fused_loop)
        ecfg = engine.trim_window(ecfg, half)
        ecfg_env = env.EnvConfig(engine=ecfg, feature="compact_groups",
                                 action="group_target_fraction", reward="group_waste_wait",
                                 n_groups=cplat.n_groups(), max_steps=512)
        const = engine.make_const(cplat, ecfg, device=dev)
        grid = env.make_env_grid(const, 2)
        event_fuse.reset_launches()
        st, obs = env.batched_reset(ecfg_env, grid, a2c.make_batched_sims(
            cplat, wls, ecfg_env, device=dev))
        seen = [obs]
        for k in range(LEGACY_ENV_STEPS):
            acts = torch.tensor([(3 * k + b) % ecfg_env.n_actions for b in range(2)],
                                dtype=torch.int32, device=dev)
            st, obs, r, d, _ = env.batched_step(ecfg_env, grid, st, acts)
            seen += [obs, r, d]
        if not fused_loop:
            add_launches()
        else:
            env_fused_launches = event_fuse.LAUNCHES["event_fuse_occ"]
        steps[fused_loop] = (seen, st.sim)
    check(all(torch.equal(a, b) for a, b in zip(steps[True][0], steps[False][0])),
          "phase 16 (c): the legacy env's observations, rewards or done != the fused env's")
    same_state(steps[False][1], steps[True][1], "the grouped env")
    check(env_fused_launches == LEGACY_ENV_STEPS,
          f"phase 16 (c): the fused env launched {env_fused_launches} event_fuse_occ")
    env_wall = time.perf_counter() - t1
    check(not any(legacy_launches.values()),
          f"phase 16 (c): the legacy runs launched {legacy_launches}")

    # the grouped 280-node run on both loops, timed in turns
    gplat = curie_platform(280)
    gwl = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=GROUPED_JOBS)
    gcfg = EngineConfig(timeout=1800, node_order="cheap", grouped_tables=True)
    turns = []
    for fused_loop in (True, False, False, True):
        cfg = dataclasses.replace(gcfg, fused_events=fused_loop)
        engine.HOST_SYNCS = 0
        event_fuse.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s = engine.simulate(gplat, gwl, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if not fused_loop:
            add_launches()
        turns.append((fused_loop, int(s.n_batches), wall, engine.HOST_SYNCS, s))
    check(not any(legacy_launches.values()),
          f"phase 16 (c): the legacy runs launched {legacy_launches}")
    same_state(turns[1][4], turns[0][4], "the timed grouped run")
    nb = turns[0][1]
    by = {f: [t for t in turns if t[0] == f] for f in (True, False)}
    us = {f: [1e6 * t[2] / t[1] for t in ts] for f, ts in by.items()}
    sync = {f: ts[0][3] / ts[0][1] for f, ts in by.items()}
    check(sync[False] <= 2.0 and by[False][0][3] >= by[True][0][3],
          f"phase 16 (c): host syncs a batch legacy {sync[False]}, fused {sync[True]}")
    out["legacy"] = dict(legacy_launches)
    print(f"phase 16 (c) legacy loop (fused_events=False): {len(fused_runs)} of phase 4's "
          f"label runs (the 16-node homogeneous and mixed platforms, curie_platform(280) "
          f"grouped) == the fused runs bit for bit (every state field, the schedule table, "
          f"every SimMetrics field) and the oracle (schedule exact, energy rel <= "
          f"{worst:.2e}) in {runs_wall:.1f} s; a dense E = 4 grid {LEGACY_GRID} on 280 nodes "
          f"({len(trace)} replayed jobs) == the fused grid row for row ({grid_fused_launches} "
          f"event_fuse_ledger launches fused) in {grid_wall:.1f} s; the grouped B = 2 env on "
          f"curie_platform(280) for {LEGACY_ENV_STEPS} steps == the fused env "
          f"({env_fused_launches} event_fuse_occ launches fused) in {env_wall:.1f} s; event "
          f"kernel launches on every legacy run {legacy_launches}; the grouped EASY PSUS run "
          f"on curie_platform(280), {len(gwl)} jobs, {nb} batches, in turns (fused, legacy, "
          f"legacy, fused): us a batch fused {us[True][0]:.1f} and {us[True][1]:.1f}, legacy "
          f"{us[False][0]:.1f} and {us[False][1]:.1f}; host syncs a batch fused "
          f"{sync[True]:.3f}, legacy {sync[False]:.3f}; wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"phase 16 mixed programs and the legacy loop: wall "
          f"{time.perf_counter() - t16:.1f} s", flush=True)
    return out


SHARD_UPDATES = 2  # phase 17 (c): A2C updates on two workers
SHARD_TOL = 1e-6  # (c): parameters against the in-process per-block mean
SHARD_CARDS = (0, 0)  # phase 17 (b)-(c): two workers pinned to card 0


def start_workers(torch, dev="cuda"):
    """Start phase 17's two workers on card 0 (``SHARD_CARDS``) without
    waiting: each initialises CUDA, then reports its clock. Returns (the
    submit time, the calls); :func:`phase17` reads the start-up from them,
    so the workers start while an earlier phase runs."""
    from repro_torch.core import shard
    t0 = time.time()
    with shard.pinned_cards(SHARD_CARDS):
        mesh = shard.mesh(len(SHARD_CARDS), dev)
    calls = []
    for d in range(len(mesh)):
        if dev == "cuda":
            mesh.submit(d, torch.cuda.init)
        calls.append(mesh.submit(d, time.time))
    return t0, calls


def phase17(torch, np, swf, e8_rows, warm, dev="cuda", nodes=11200,
            max_jobs=SWEEP_JOBS, rl=(RL_ENVS, RL_WINDOW)):
    """Phase 17: sharded sweeps and data-parallel rollouts, one worker
    process per card (``repro_torch.core.shard``). (a) phase 11's dense E =
    8 grid (``max_jobs`` jobs of phase 5's inputs) at ``devices=1``, on one
    worker; (b) the same grid on two workers pinned to card 0; each row bit
    for bit phase 11's (``e8_rows``); (c) ``SHARD_UPDATES`` A2C updates of
    phase 12 (a)'s grouped batch on two workers on card 0, the parameters
    within ``SHARD_TOL`` of the same updates in this process (each block's
    rollout with its block's generator, the gradients' mean, one clip and
    one AdamW step), the losses finite; (d) with two cards or more, (a) at
    D = the card count, one worker a card. ``warm`` is
    :func:`start_workers`' handle. Returns each part's event-kernel
    launches, by kernel, counted from the workers' deltas."""
    import copy

    from repro_torch.core import engine, shard, sweep
    from repro_torch.core.policy import from_label
    from repro_torch.core.rl import a2c, env, networks
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.training.optimizer import adamw, apply_updates, clip_by_global_norm
    from repro_torch.workloads.generator import PRESETS, generate_workload
    from repro_torch.workloads.platform import PlatformSpec
    t17 = time.perf_counter()
    cuda = dev == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset_counts():
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0

    t_submit, calls = warm
    up = max(c.result() for c in calls) - t_submit
    print(f"phase 17 workers: {len(SHARD_CARDS)} started on cards {list(SHARD_CARDS)} "
          f"beside phase 16, each up (spawned, the port imported, CUDA initialised) "
          f"{up:.2f} s after the start", flush=True)

    by_part = {}
    plat = PlatformSpec(nb_nodes=nodes)
    wl = generate_workload(dataclasses.replace(
        PRESETS["cea_curie"], n_jobs=max_jobs, nb_res=nodes,
        max_res=min(PRESETS["cea_curie"].max_res, nodes)))
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    scen = sweep_grid(8)

    def grid_part(part, cards):
        """The dense grid on workers pinned to ``cards``: its rows against
        phase 11's, one ledger launch an iteration of each block."""
        with shard.pinned_cards(cards):
            reset_counts()
            t0 = time.perf_counter()
            b = sweep.sweep(plat, wl, scen, cfg, devices=len(cards), device=dev)
            sync()
            wall = time.perf_counter() - t0
        launches = dict(event_fuse.LAUNCHES)
        by_part[part] = launches
        nb = b.states.n_batches.cpu().numpy()
        iters = [int(nb[lo:hi].max()) for lo, hi in shard.block_bounds(len(scen), len(cards))
                 if hi > lo]
        check(b.devices == len(cards) and not b.states.truncated.any(),
              f"phase 17 {part}: devices {b.devices}, truncated rows")
        check((not cuda or launches["event_fuse_ledger"] == sum(iters))
              and all(v == 0 for k, v in launches.items() if k != "event_fuse_ledger")
              and fa.LAUNCHES["flash_attention"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0,
              f"phase 17 {part}: launches {launches}, {sum(iters)} ledger expected "
              f"(the blocks' iterations {iters})")
        check(engine.HOST_SYNCS >= sum(iters),
              f"phase 17 {part}: {engine.HOST_SYNCS} host syncs for {iters} iterations")
        bad = [(sc["scheduler"], sc["timeout"]) for sc, m in zip(scen, b.metrics)
               if m.row() != e8_rows[sc["scheduler"], sc["timeout"]]]
        check(not bad, f"phase 17 {part}: rows {bad} != phase 11's dense E=8 rows")
        print(f"phase 17 {part}: phase 11's dense E=8 grid ({len(scen)} scenarios, "
              f"{plat.nb_nodes} nodes, {len(wl)} jobs) on {len(cards)} worker(s), cards "
              f"{list(cards)}: wall {wall:.2f} s "
              f"({wall / len(scen):.3f} s a scenario); the blocks' iterations {iters}, "
              f"event_fuse_ledger launches {launches['event_fuse_ledger']}, host syncs "
              f"{engine.HOST_SYNCS}; every row == phase 11's bit for bit", flush=True)

    grid_part("(a)", SHARD_CARDS[:1])
    grid_part("(b)", SHARD_CARDS)

    # ---- (c) A2C on two workers on card 0 ----
    envs, window = rl
    _, _, ecfg, const, sims0 = curie_rl_batch(swf, dev, nodes, envs, window)
    acfg = a2c.A2CConfig(n_envs=envs, n_steps=16)
    key = torch.Generator(device=dev).manual_seed(acfg.seed)
    params = networks.policy_init(key, ecfg.obs_size, ecfg.n_actions, acfg.hidden)
    ref = copy.deepcopy(params)
    with shard.pinned_cards(SHARD_CARDS):
        t0 = time.perf_counter()
        update, opt = a2c.make_update_fn(ecfg, const, sims0, acfg, devices=2)
        open_s = time.perf_counter() - t0
        ts = a2c.TrainState(params, opt.init(params.parameters()), None, None, key)
        reset_counts()
        t0 = time.perf_counter()
        hist = []
        for _ in range(SHARD_UPDATES):
            ts, m = update(ts)
            hist.append({k: float(v) for k, v in m.items()})
        sync()
        a2c_wall = time.perf_counter() - t0
        halves = env.shard_env_batch(sims0, 2)  # the workers' blocks
    launches = dict(event_fuse.LAUNCHES)
    by_part["(c)"] = launches
    want = SHARD_UPDATES * acfg.n_steps * 2
    check((not cuda or launches["event_fuse_occ"] == want)
          and all(v == 0 for k, v in launches.items() if k != "event_fuse_occ"),
          f"phase 17 (c): launches {launches}, {want} event_fuse_occ expected")
    check(all(np.isfinite(h["loss"]) for h in hist), f"phase 17 (c): losses {hist}")
    # the same updates in this process: each block's rollout with its
    # block's generator, the mean of the two blocks' gradients, one step
    blocks = []
    for d, blk in enumerate(halves):
        grid, fresh = a2c._grid_and_reset(ecfg, const, blk)
        blocks.append([grid, fresh, fresh, torch.Generator(device=dev).manual_seed(
            a2c.shard_seed(acfg.seed, d))])
    ref_params = list(ref.parameters())
    ref_opt = adamw(lr=acfg.lr)
    ref_state = ref_opt.init(ref_params)
    for _ in range(SHARD_UPDATES):
        grads = []
        for blk in blocks:
            grid, fresh, (states, obs), gen = blk
            states, obs, roll = a2c.collect_rollout(ref, states, obs, gen, fresh, ecfg,
                                                    grid, acfg.n_steps)
            blk[2] = (states, obs)
            advs, returns = a2c.gae(roll, acfg.gamma, acfg.gae_lambda)
            loss, _ = a2c.a2c_loss(ref, roll, advs, returns, acfg)
            grads.append(torch.autograd.grad(loss, ref_params))
        mean = [a2c.mean_in_order(g) for g in zip(*grads)]
        mean, _ = clip_by_global_norm(mean, acfg.max_grad_norm)
        updates, ref_state = ref_opt.update(mean, ref_state, ref_params)
        apply_updates(ref_params, updates)
    with torch.no_grad():
        diff = max(float((a - b).abs().max())
                   for a, b in zip(params.parameters(), ref_params))
        moved = sum(float((a - b).abs().sum()) for a, b in zip(
            params.parameters(), networks.policy_init(
                torch.Generator(device=dev).manual_seed(acfg.seed), ecfg.obs_size,
                ecfg.n_actions, acfg.hidden).parameters()))
    check(diff <= SHARD_TOL and moved > 0,
          f"phase 17 (c): parameters {diff} from the in-process per-block mean "
          f"(tolerance {SHARD_TOL}), moved {moved}")
    print(f"phase 17 (c) A2C: {envs} envs of curie_platform({nodes}) (phase 12 (a)'s "
          f"batch) on 2 workers on card 0, {envs // 2} envs each: blocks opened (grid "
          f"and reset in each worker) in {open_s:.2f} s; "
          f"{SHARD_UPDATES} updates of {acfg.n_steps} steps in {a2c_wall:.2f} s = "
          f"{a2c_wall / SHARD_UPDATES:.3f} s an update; event_fuse_occ launches "
          f"{launches['event_fuse_occ']} (= {SHARD_UPDATES} x {acfg.n_steps} x 2); "
          f"losses {[round(h['loss'], 6) for h in hist]}; parameters max abs diff "
          f"{diff:.3g} from the same updates in this process (tolerance {SHARD_TOL}), "
          f"moved {moved:.4f} (sum |delta|)", flush=True)
    del update, ts, blocks

    # ---- (d) one worker a card ----
    n_cards = torch.cuda.device_count() if cuda else 1
    if n_cards >= 2:
        grid_part("(d)", list(range(n_cards)))
    else:
        print(f"phase 17 (d): {n_cards} card, so no grid on distinct cards", flush=True)
    print(f"phase 17 wall {time.perf_counter() - t17:.1f} s", flush=True)
    return by_part


PIPE_STAGES = 2  # phase 19 (a): internlm2-1.8b's 24 dense layers in 2 stages of 12
PIPE_MICRO, PIPE_MB, PIPE_SEQ = 8, 2, 1024  # (a): 8 microbatches of [2, 1024, d_model]
ELASTIC_SHRINK = 12  # (b): the 16-env batch shrunk to 12 envs, then grown back to 16


def env_axis_placement(mesh, shapes):
    """Phase 19 (b)'s ``sharding_fn``: every leaf with the env axis first
    is split over the workers, the rest replicated."""
    from repro_torch.core import shard
    from repro_torch.training import elastic
    return shard.tree_map(lambda s: elastic.SPLIT if s.ndim and s.shape[0] == RL_ENVS
                          else elastic.REPLICATE, shapes)


def phase19(torch, np, swf, dev="cuda", nodes=11200, arch=None,
            pipe=(PIPE_MICRO, PIPE_MB, PIPE_SEQ)):
    """Phase 19: the pipeline and elastic resharding on phase 17's two
    workers on card 0 (``SHARD_CARDS``). (a) ``training.pipeline``: the
    full-width ``ARCH`` trunk (24 dense layers, bf16, seeded weights) in
    ``PIPE_STAGES`` stages over ``pipe`` = (``PIPE_MICRO`` microbatches of
    ``[PIPE_MB, PIPE_SEQ, d_model]``), each stage's weights placed in its
    worker once (timed apart), the output bit for bit the same layers run
    in this process one microbatch at a time, ``flash_attention`` launched
    once a layer a microbatch on the wgmma kernel in the workers (counted
    from their deltas) and in this process; the two run twice in turns. (b)
    ``training.elastic``: phase 12 (a)'s grouped 16-env batch state after
    its reset resharded onto 2 workers, 1, and 2 again (``surviving_mesh``
    inside ``shard.pinned_cards``) and gathered back bit for bit, shrunk to
    ``ELASTIC_SHRINK`` envs and grown back to 16, then one batched step: one
    ``event_fuse_occ`` launch, rows 12-15 (copies of rows 0-3, under their
    actions) equal to rows 0-3 bit for bit. Returns the flash launches of
    (a)'s pipeline by kernel and the event kernels' launches of (b)."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.core import engine, shard
    from repro_torch.core.rl import env
    from repro_torch.kernels import event_fuse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.training import elastic, pipeline
    t19 = time.perf_counter()
    cuda = dev == "cuda"
    n_micro, mb, seq = pipe

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset_counts():
        event_fuse.reset_launches()
        fa.reset_launches()
        ssd.reset_launches()
        engine.HOST_SYNCS = 0

    # ---- (a) GPipe over two workers ----
    cfg = arch or get_arch(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(gen)
    sync()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages = pipeline.split_stages(pipeline.stack_blocks(model.blocks), PIPE_STAGES)
    del model
    x = torch.randn((n_micro, mb, seq, cfg.d_model), generator=gen, device=dev,
                    dtype=cfg.dtype)
    sync()
    stack_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in stages.values())
    stage_fn = pipeline.make_stage_fn(
        functools.partial(pipeline.dense_block_apply, cfg, None, "auto"))
    with shard.pinned_cards(SHARD_CARDS):
        mesh = pipeline.stage_mesh(PIPE_STAGES, dev)
    t0 = time.perf_counter()
    placed = pipeline.place_stages(stages, mesh)
    place_s = time.perf_counter() - t0

    def sequential():
        """The same layers in this process, one microbatch at a time."""
        outs = []
        with torch.no_grad():
            for m in range(n_micro):
                h = x[m]
                for r in range(PIPE_STAGES):
                    h = stage_fn({k: a[r] for k, a in stages.items()}, h)
                outs.append(h)
        return torch.stack(outs)

    def timed(run):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        out = run()
        sync()
        return out, time.perf_counter() - t0, dict(fa.LAUNCHES), dict(event_fuse.LAUNCHES)

    def piped():
        return pipeline.pipeline_forward(stage_fn, placed, x, mesh=mesh, axis="pod")

    want = cfg.n_layers * n_micro
    walls = {"pipeline": [], "sequential": []}
    outs, counts = {}, {}
    for name, run in (("pipeline", piped), ("sequential", sequential),
                      ("sequential", sequential), ("pipeline", piped)):
        out, wall, flash, events = timed(run)
        walls[name].append(wall)
        check((not cuda or flash["flash_attention"] == want == flash["flash_attention_wgmma"])
              and flash["flash_attention_simt"] == 0 and ssd.LAUNCHES["ssd_scan"] == 0
              and not any(events.values()),
              f"phase 19 (a) {name}: launches {flash} {events}, {want} wgmma flash expected")
        check(out.shape == x.shape and out.dtype == x.dtype and bool(out.isfinite().all()),
              f"phase 19 (a) {name}: output {tuple(out.shape)} {out.dtype}, or not finite")
        if name in outs:
            check(torch.equal(out, outs[name]), f"phase 19 (a) {name}: a rerun differs")
        outs[name], counts[name] = out, flash
    diff = float((outs["pipeline"].float() - outs["sequential"].float()).abs().max())
    check(torch.equal(outs["pipeline"], outs["sequential"]),
          f"phase 19 (a): the pipeline's output != the sequential run's (max abs diff "
          f"{diff:.3g})")
    placed.close()
    del stages, placed, outs
    if cuda:
        torch.cuda.empty_cache()
    bubble = (PIPE_STAGES - 1) / (n_micro + PIPE_STAGES - 1)
    print(f"phase 19 (a) pipeline: {ARCH} full width {cfg.dtype} ({cfg.n_layers} dense "
          f"layers, d {cfg.d_model}, H {cfg.n_heads}, KH {cfg.n_kv_heads}, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}; {n_params:,} trunk params, seed 0) in {PIPE_STAGES} stages on "
          f"workers pinned to cards {list(SHARD_CARDS)}, {n_micro} microbatches of "
          f"[{mb}, {seq}, {cfg.d_model}]: the model built and initialised in "
          f"{init_s:.2f} s, its blocks stacked in {stack_s:.2f} s, placed (a stage a "
          f"worker, pickled through the parent) in {place_s:.2f} s; "
          f"pipeline wall {walls['pipeline'][0]:.3f} and {walls['pipeline'][1]:.3f} s, "
          f"sequential in this process {walls['sequential'][0]:.3f} and "
          f"{walls['sequential'][1]:.3f} s (in turns: pipeline, sequential, sequential, "
          f"pipeline); bubble (S-1)/(M+S-1) = {bubble:.4f}; flash_attention launches "
          f"{counts['pipeline']['flash_attention']} from the workers (wgmma "
          f"{counts['pipeline']['flash_attention_wgmma']}) and "
          f"{counts['sequential']['flash_attention']} in this process; output == the "
          f"sequential run's bit for bit ({nvidia_smi()})", flush=True)

    # ---- (b) elastic resharding of the grouped env batch ----
    t0 = time.perf_counter()
    _, _, ecfg, const, sims0 = curie_rl_batch(swf, dev, nodes)
    state, _ = env.batched_reset(ecfg, env.make_env_grid(const, RL_ENVS), sims0)
    sync()
    setup_s = time.perf_counter() - t0

    def fields(st):
        return list(zip((*engine.SimState._fields, "steps", "done"), (*st.sim, st.steps,
                                                                      st.done)))

    t0 = time.perf_counter()
    with shard.pinned_cards(SHARD_CARDS):
        m2 = elastic.surviving_mesh(len(SHARD_CARDS), 1, device=dev)
    with shard.pinned_cards(SHARD_CARDS[:1]):
        m1 = elastic.surviving_mesh(1, 1, device=dev)
    p2 = elastic.reshard(state, m2, env_axis_placement)
    p1 = elastic.reshard(p2, m1, env_axis_placement)
    p2b = elastic.reshard(p1, m2, env_axis_placement)
    back = p2b.gather()
    sync()
    reshard_s = time.perf_counter() - t0
    for p in (p2, p1, p2b):
        p.close()
    bad = [f for (f, a), (_, b) in zip(fields(back), fields(state))
           if not (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
                   and torch.equal(a, b))]
    check(not bad, f"phase 19 (b): fields {bad} changed through the reshards")
    n_bytes = sum(a.numel() * a.element_size() for _, a in fields(state))
    grown = elastic.grow_env_axis(elastic.shrink_env_axis(back, ELASTIC_SHRINK), RL_ENVS)
    check(all(a.shape[0] == RL_ENVS for _, a in fields(grown) if a.ndim),
          "phase 19 (b): the grown batch's env axis")
    # rows 12-15 are copies of rows 0-3 and take their actions
    actions = ((5 * (torch.arange(RL_ENVS, device=dev) % ELASTIC_SHRINK) + 1)
               % ecfg.n_actions).to(torch.int32)
    reset_counts()
    t0 = time.perf_counter()
    st, obs, reward, done, _ = env.batched_step(ecfg, env.make_env_grid(const, RL_ENVS),
                                                grown, actions)
    sync()
    step_s = time.perf_counter() - t0
    events = dict(event_fuse.LAUNCHES)
    check((not cuda or events["event_fuse_occ"] == 1) and all(v == 0 for k, v in events.items()
                                                if k != "event_fuse_occ")
          and fa.LAUNCHES["flash_attention"] == 0,
          f"phase 19 (b): launches {events}, one event_fuse_occ expected")
    copies = slice(ELASTIC_SHRINK, RL_ENVS)
    rows = slice(0, RL_ENVS - ELASTIC_SHRINK)
    bad = [f for f, a in fields(st) + [("obs", obs), ("reward", reward)]
           if not torch.equal(a[copies], a[rows])]
    check(not bad, f"phase 19 (b): rows 12-15 {bad} != rows 0-3 after the step")
    print(f"phase 19 (b) elastic: phase 12 (a)'s batch ({RL_ENVS} grouped envs of "
          f"curie_platform({nodes}), {n_bytes / 2**20:.1f} MiB of state after its reset, "
          f"set up in {setup_s:.2f} s) resharded 2 -> 1 -> 2 workers on card 0 and "
          f"gathered back in {reshard_s:.2f} s, every field bit for bit; shrunk to "
          f"{ELASTIC_SHRINK} envs, grown to {RL_ENVS}, one batched step in {step_s:.3f} s "
          f"with launches {events}: rows 12-15 == rows 0-3 bit for bit (state, obs, "
          f"reward, done)", flush=True)
    print(f"phase 19 wall {time.perf_counter() - t19:.1f} s", flush=True)
    return counts["pipeline"], events


TP_STEPS = 3  # phase 20 (a): AdamW steps of the grid, against phase 15's first three
TP_MODEL = 2  # phase 20: (data, model) = (1, TP_MODEL), two ranks pinned to card 0
# phase 20 (a): each grid loss within this of phase 15's (absolute; bf16: a
# rank's partial products round to bf16 before their sum, so each layer's
# output may differ from one process's by a bf16 ulp, and AdamW's first
# steps amplify small gradient differences)
TP_LOSS_TOL = 0.05
# phase 20 (b): the grid's last-position logits within this share of the
# largest |logit| of one process's (bf16, the same rounding)
TP_LOGITS_REL = 0.05
TP_PREFILL = (1, 1024)  # phase 20 (b): one prompt of 1024 tokens


def phase20(torch, np, ref_losses, dev="cuda", arch=None):
    """Phase 20: tensor-parallel training and prefill
    (``training.tensor_parallel``) of the full-width ``ARCH`` on a (data,
    model) = (1, ``TP_MODEL``) grid of two ranks pinned to card 0 with
    ``gloo`` (phase 17's workers, kept by phase 19). Each rank draws the
    model from seed 0 as phase 15 does and keeps its half. First each
    rank's bf16 and f32 sum and max over the model group are checked; (b)
    the grid's prefill of one 1024-token prompt on the kernel routes, 24
    wgmma flash launches a rank (H 8, KH 4, hd 128), its last-position
    logits against one process's prefill within ``TP_LOGITS_REL``; (a)
    ``TP_STEPS`` AdamW steps on phase 15's batches, each loss within
    ``TP_LOSS_TOL`` of phase 15's ``ref_losses``, with ms a step, ms in
    all-reduces a step (the last step waits for the card around each to
    time them), each rank's peak memory and the backend. Returns
    (b)'s flash launches by kernel."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.core import shard
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import scheduled_optimizer
    from repro_torch.models import build_model
    from repro_torch.training.tensor_parallel import Grid

    t20 = time.perf_counter()
    cuda = dev == "cuda"
    cfg = arch or get_arch(ARCH)
    print(f"phase 20 tolerances: losses within {TP_LOSS_TOL} of phase 15's, prefill logits "
          f"within {TP_LOGITS_REL} of the largest |logit|", flush=True)
    make_opt = functools.partial(scheduled_optimizer, "adamw", 3e-4, TRAIN_STEPS, 2)
    t0 = time.perf_counter()
    with shard.pinned_cards(SHARD_CARDS):
        grid = Grid(cfg, TP_MODEL, len(SHARD_CARDS), device=dev, backend="gloo",
                    make_optimizer=make_opt, seed=0)
    open_s = time.perf_counter() - t0
    try:
        probe = grid.check_collectives()
        check(all(all(r.values()) for r in probe),
              f"phase 20: gloo sums and maxes on {dev} over the model group: {probe}")
        # ---- (b) the prefill, before any step changes the weights ----
        b, s = TP_PREFILL
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
        fa.reset_launches()
        t0 = time.perf_counter()
        logits = grid.prefill(tokens)
        prefill_s = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        want = cfg.n_layers * TP_MODEL
        check(not cuda or launches["flash_attention"] == want == launches["flash_attention_wgmma"],
              f"phase 20 (b): flash launches {launches}, {cfg.n_layers} wgmma a rank expected")
        model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            one, _ = model.prefill(tokens.to(dev))
        del model
        if cuda:
            torch.cuda.empty_cache()
        one = one.cpu()
        scale = float(one.abs().max())
        diff = float((logits - one).abs().max())
        check(logits.shape == one.shape == (b, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()) and diff <= TP_LOGITS_REL * scale,
              f"phase 20 (b): grid logits {tuple(logits.shape)} vs one process's "
              f"{tuple(one.shape)}: max abs diff {diff:.4g} against {TP_LOGITS_REL} x {scale:.4g}")
        same = int((logits.argmax(-1) == one.argmax(-1)).sum())
        print(f"phase 20 (b) prefill: {cfg.name} {cfg.dtype} on (data, model) = (1, {TP_MODEL}), "
              f"ranks on cards {list(SHARD_CARDS)} (gloo): one {s}-token prompt in "
              f"{1e3 * prefill_s:.1f} ms; flash_attention launches {launches['flash_attention']} "
              f"({launches['flash_attention'] // TP_MODEL} a rank at H {cfg.n_heads // TP_MODEL}, KH "
              f"{cfg.n_kv_heads // TP_MODEL}, hd {cfg.hd}; wgmma "
              f"{launches['flash_attention_wgmma']}); last-position logits against one "
              f"process's: max abs diff {diff:.4g} (largest |logit| {scale:.4g}), greedy token "
              f"equal in {same} of {b}", flush=True)

        # ---- (a) training steps on phase 15's batches ----
        stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=0)
        rows, walls = [], []
        for i in range(TP_STEPS):  # the last step waits for the card around each all-reduce
            batch = stream.batch_at(i)
            t0 = time.perf_counter()
            rows.append(grid.step(batch, time_all_reduces=i == TP_STEPS - 1))
            walls.append(1e3 * (time.perf_counter() - t0))
        stats = grid.stats()
    finally:
        grid.close()
    losses = [r["loss"] for r in rows]
    gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
    check(all(np.isfinite(losses)) and max(gaps) <= TP_LOSS_TOL,
          f"phase 20 (a): grid losses {losses} against phase 15's {ref_losses[:TP_STEPS]} "
          f"(largest gap {max(gaps):.4g}, tolerance {TP_LOSS_TOL})")
    peaks = [r.get("peak_bytes", 0) / 2**30 for r in stats]
    print(f"phase 20 (a) train: {cfg.name} {cfg.dtype} (remat {cfg.remat}) on (data, model) = (1, "
          f"{TP_MODEL}), ranks on cards {list(SHARD_CARDS)}, backend {grid.backend} "
          f"(reductions in each tensor's own dtype), grid opened in {open_s:.2f} s (each rank "
          f"draws the model from seed 0 and keeps its half: "
          f"{stats[0]['params']:,} params a rank); {TP_STEPS} AdamW steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens on phase 15's batches: losses {[round(x, 5) for x in losses]} "
          f"against phase 15's {[round(x, 5) for x in ref_losses[:TP_STEPS]]} (largest gap "
          f"{max(gaps):.4g}, tolerance {TP_LOSS_TOL}); gradient norms "
          f"{[round(r['grad_norm'], 4) for r in rows]}; ms a step (rank 0) "
          f"{[round(r['step_ms'], 1) for r in rows]}, in the parent {[round(x, 1) for x in walls]}; "
          f"all-reduces a step {[r['all_reduces'] for r in rows]} taking "
          f"{[round(r['all_reduce_ms'], 1) for r in rows]} ms (rank 0; host wall, and in the "
          f"last step, timed, each waits for the card before and after); bytes all-reduced since the grid opened "
          f"{[round(r['all_reduce_bytes'] / 2**30, 2) for r in stats]} GiB a rank; peak device "
          f"memory {[round(x, 2) for x in peaks]} GiB a rank"
          + (f" ({nvidia_smi()})" if cuda else ""), flush=True)
    shard.shutdown()
    print(f"phase 20 wall {time.perf_counter() - t20:.1f} s", flush=True)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — nothing was run")
    import numpy as np

    from repro_torch.core import engine, metrics
    from repro_torch.core.policy import from_label, scheduler_labels
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    swf = synthesize_curie_swf(os.path.join(tmp, "curie.swf"))  # seed 1300
    # phases 5-6's inputs; their oracles are host work that needs no card,
    # so two worker processes compute them while phases 1-4 run
    base, pol = from_label("EASY PSUS")
    dense_in = (PlatformSpec(nb_nodes=11200),
                generate_workload(dataclasses.replace(PRESETS["cea_curie"], n_jobs=1000)),
                EngineConfig(base=base, policy=pol, timeout=1800))
    grouped_in = (curie_platform(11200),
                  replay_workload(swf, nb_nodes=11200, oversize="clamp", max_jobs=1000),
                  EngineConfig(base=base, policy=pol, timeout=1800, grouped_tables=True))
    oracle_pool = multiprocessing.get_context("spawn").Pool(2)
    atexit.register(oracle_pool.terminate)
    oracles = [oracle_pool.apply_async(oracle_of, args) for args in (dense_in, grouped_in)]
    # phase 13 (a)'s four oracle rows, queued behind them
    fig45_oracles = [oracle_pool.apply_async(oracle_of, args)
                     for args in fig45_oracle_inputs()]
    oracle_pool.close()

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
    check(len(flash_report) == 19 and all(flash_report.values()),
          f"ptxas reported {sorted(flash_report)} for flash_attention (16 SIMT and 3 "
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
         for e, n in EXACT_SHAPES + ZERO_SHAPES]
        + [((e_sh, n_sh, "shifted", SHIFTS[:2]), ledger_shifted, False)],
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
    main_in = kernel_inputs(torch, np, *MAIN_SHAPE)
    timing["event_fuse", 1] = time_kernel(
        torch, "event_fuse", event_fuse.event_fuse, event_fuse.event_fuse_plain,
        main_in, draw_bound(*MAIN_SHAPE), "E={} N={}".format(*MAIN_SHAPE), floor_ms, fill)
    clusters["event_fuse", 1] = event_fuse.CLUSTER["event_fuse"]
    # the scalar draw beside the ledger, whose reduction it shares: device
    # time in turns ledger, draw, draw, ledger on the same inputs
    turns = [device_ms(torch, fn, main_in)[0] for fn in (
        event_fuse.event_fuse_ledger, event_fuse.event_fuse,
        event_fuse.event_fuse, event_fuse.event_fuse_ledger)]
    draw_turns = {"event_fuse": (turns[1] + turns[2]) / 2,
                  "event_fuse_ledger": (turns[0] + turns[3]) / 2}
    print(f"phase 3 kernels: event_fuse beside event_fuse_ledger at E={MAIN_SHAPE[0]} "
          f"N={MAIN_SHAPE[1]}, in turns ledger, draw, draw, ledger: draw "
          f"{1e3 * draw_turns['event_fuse']:.3f} us ({1e3 * turns[1]:.3f}, "
          f"{1e3 * turns[2]:.3f}), ledger {1e3 * draw_turns['event_fuse_ledger']:.3f} us "
          f"({1e3 * turns[0]:.3f}, {1e3 * turns[3]:.3f}), both clusters of "
          f"{clusters['event_fuse', 1]} and {event_fuse.CLUSTER['event_fuse_ledger']} "
          f"CTAs; card: {nvidia_smi()}", flush=True)
    for kname in event_fuse.KERNELS:
        max_c, sms = event_fuse.cluster_setup(kname, 0)
        sizes = ", ".join(f"{clusters[kname, e]} CTAs at E={e}"
                          for e in (1, 8, 64) if (kname, e) in clusters)
        print(f"phase 3 kernels: {kname} runs clusters of {sizes} "
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

    def in_turns(args, causal=True):
        """Device ms of the wgmma kernel (the route the table names) and the
        SIMT kernel on the same bf16 inputs, in turns: SIMT, wgmma, wgmma,
        SIMT. Returns (wgmma ms, SIMT ms, the turns)."""
        def flash_wgmma(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal)

        def flash_simt(q, k, v):  # the SIMT kernel, whatever the table routes
            return fa.launch_variant("simt", q, k, v, causal=causal)

        check(fa.variant(args[0].dtype, args[0].shape[3]) == "wgmma",
              f"flash_attention: the table does not name wgmma at {tuple(args[0].shape)}")
        turns = [(route, one_kernel(fn, args, kname)) for route, fn, kname in (
            ("simt", flash_simt, "flash_attention_kernel"),
            ("wgmma", flash_wgmma, "flash_attention_wgmma_kernel"),
            ("wgmma", flash_wgmma, "flash_attention_wgmma_kernel"),
            ("simt", flash_simt, "flash_attention_kernel"))]
        return (statistics.fmean(t[0] for r, t in turns if r == "wgmma"),
                statistics.fmean(t[0] for r, t in turns if r == "simt"), turns)

    # bf16 at the prefill shape, in turns: SIMT, wgmma, wgmma, SIMT
    args = flash_inputs(torch, np, FLASH_MAIN, torch.bfloat16)
    w_ms, s_ms, turns = in_turns(args)
    simt_err = float((fa.launch_variant("simt", *args, causal=True).float()
                      - flash_plain(*args).float()).abs().max())
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

    # the new serve paths' prefill shapes: the variant the table names, the
    # plain version and scaled_dot_product_attention, in bf16, and at hd 80
    # in f32 as well; each with its own mask as it runs (whisper's encoder
    # and cross attention unmasked)
    flash_new = {}
    for label, shape in FLASH_NEW.items():
        causal = shape[-1]

        def new_kernel(q, k, v, causal=causal):
            return fa.flash_attention(q, k, v, causal=causal)

        def new_plain(q, k, v, causal=causal):
            return fa.flash_attention_plain(q, k, v, causal=causal)

        def new_sdpa(q, k, v, causal=causal):  # timed only: the port never calls it
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True).transpose(1, 2)

        for dname in ("bfloat16", "float32") if shape[5] == 80 else ("bfloat16",):
            args = flash_inputs(torch, np, shape, getattr(torch, dname))
            route = fa.variant(args[0].dtype, shape[5])
            kname = ("flash_attention_wgmma_kernel" if route == "wgmma"
                     else "flash_attention_kernel")
            turns_text, extra = "", {}
            if shape == FLASH_HD80 and dname == "bfloat16":  # both kernels, in turns
                k_ms, s_ms, turns = in_turns(args, causal)
                k_seen = min(t[1] for _, t in turns)
                simt_out = fa.launch_variant("simt", *args, causal=causal).float()
                plain_out = new_plain(*args).float()
                s_err = float((simt_out - plain_out).abs().max())
                check(torch.allclose(simt_out, plain_out, atol=FLASH_TOL[dname],
                                     rtol=FLASH_TOL[dname]),
                      f"flash_attention SIMT == plain at {shape} {dname}: max abs err {s_err}")
                extra = {"simt_ms": s_ms, "turns_ms": [[r, t[0]] for r, t in turns],
                         "simt_max_abs_err": s_err}
                turns_text = (" (in turns: " + ", ".join(
                    f"{r} {1e3 * t[0]:.3f} us" for r, t in turns)
                    + f"; SIMT / wgmma {s_ms / k_ms:.1f}x; SIMT on these inputs == plain "
                    f"to {s_err:.3g})")
            else:
                k_ms, k_seen = one_kernel(new_kernel, args, kname)
            p_ms, p_ops, _, p_seen = device_ms(torch, new_plain, args, calls=20)
            l_ms, l_ops, _, l_seen = device_ms(torch, new_sdpa, args, calls=100)
            k_host = host_ms(torch, new_kernel, args)
            b_ms, b_by = flash_bound(*shape, itemsize=args[0].element_size())
            flash_new[f"{label} {dname}"] = {
                "shape": list(shape[:6]), "causal": causal, "variant": route, "ms": k_ms,
                "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                "host_ms": k_host, **extra}
            print(f"phase 3 kernels: flash_attention {label} {dname} (B, Sq, Sk, H, KH, hd) "
                  f"{shape[:6]} {'causal' if causal else 'unmasked'}: device time {route} "
                  f"kernel {1e3 * k_ms:.3f} us{turns_text}, plain "
                  f"{1e3 * p_ms:.3f} us ({p_ops} device ops), scaled_dot_product_attention "
                  f"{1e3 * l_ms:.3f} us ({l_ops} device ops; kernel / SDPA "
                  f"{k_ms / l_ms:.2f}); bound {1e3 * b_ms:.3f} us ({b_by}), kernel at "
                  f"{b_ms / k_ms:.3f} of it; wrapper host time {1e3 * k_host:.2f} us per "
                  f"call; profiler records seen: kernel {k_seen:.3f}, plain {p_seen:.3f}, "
                  f"sdpa {l_seen:.3f}", flush=True)

    # ssd_scan: tolerance, not bits (f32 sums in another order)
    ssd_err, ssd_cases = 0.0, []
    for label, shape, dts, with_h0 in SSD_CHECKS:
        make = mamba_ssd_inputs if shape == SSD_MAMBA else ssd_inputs
        q, k, v, g, h0 = make(torch, np, shape, dts, with_h0)
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
    for shape in (SSD_MAIN, SSD_NORM, SSD_MAMBA):
        mamba = shape == SSD_MAMBA
        args = (mamba_ssd_inputs if mamba else ssd_inputs)(torch, np, shape, _MIXED)
        b, _, h, dk, dv, _ = shape
        args[4] = torch.zeros((b, h, dk, dv), device="cuda")  # the prefill's zero state
        k_ms, k_ops, k_names, k_seen = device_ms(torch, ssd_kernel, args, calls=50)
        check(k_ops == ssd.KERNELS_PER_CALL
              and all(kernel_base(x).startswith("ssd_scan") for x in k_names),
              f"ssd_scan ran {k_ops} device ops a call ({ssd.KERNELS_PER_CALL} "
              f"expected): {list(k_names)}")
        p_ms, p_ops, _, p_seen = device_ms(torch, ssd_plain, args, calls=10)
        k_host = host_ms(torch, ssd_kernel, args)
        b_ms, b_by = ssd_bound(*shape, itemsizes=(2, 4, 2), h0=True,
                               q_heads=1 if mamba else None)
        ssd_time[dv] = (k_ms, p_ms, b_ms, b_by, k_host)
        print(f"phase 3 kernels: ssd_scan (B, S, H, dk, dv, chunk) {shape} q bf16"
              f"{' (Mamba-2: C over the heads, stride 0)' if mamba else ''}, k "
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
    label_runs = []  # (what, platform, workload, config, state): phase 16 (c) reruns them
    for plat, order in ((PlatformSpec(nb_nodes=16), "id"),
                        (mixed_platform_example(16), "cheap")):
        wl = generate_workload(
            GeneratorConfig(n_jobs=LABEL_JOBS, nb_res=16, seed=0, overrun_prob=0.2)
        )
        for label in LABELS:
            base, pol = from_label(label)
            cfg = EngineConfig(base=base, policy=pol, timeout=300,
                               terminate_overrun=True, node_order=order)
            s = engine.simulate(plat, wl, cfg, device="cuda")
            same, rel, _ = held_against_oracle(metrics, np, plat, wl, cfg, s)
            check(same, f"{label} on {order}-ordered platform: schedule")
            check(rel <= 1e-5, f"{label}: energy rel err {rel}")
            n_label_runs += 1
            label_runs.append((f"{label} on {plat.nb_nodes} {order}-ordered nodes", plat, wl,
                               cfg, s))
    print(f"phase 4 labels: {n_label_runs} runs on cuda == oracle "
          f"(schedule exact, energy rel <= 1e-5) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    plat = dvfs_platform_example(16)
    wl = generate_workload(
        GeneratorConfig(n_jobs=LABEL_JOBS, nb_res=16, seed=0, overrun_prob=0.2)
    )
    rule_labels = scheduler_labels(include_dvfs=True, include_forecast=True) + (
        "EASY DVFS+Forecast",)
    worst, residency = 0.0, 0.0
    for label in rule_labels:
        base, pol = from_label(label)
        cfg = EngineConfig(base=base, policy=pol, timeout=300, terminate_overrun=True,
                           node_order="cheap", forecast_horizon=900)
        s = engine.simulate(plat, wl, cfg, device="cuda")
        same, rel, m = held_against_oracle(metrics, np, plat, wl, cfg, s)
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

    t0 = time.perf_counter()
    plat = curie_platform(280)
    wl = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=PHASE4_GROUPED_JOBS)
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
        same, rel, _ = held_against_oracle(metrics, np, plat, wl, cfg, s)
        check(same, f"grouped {label} {opts}: schedule")
        check(rel <= 1e-5, f"grouped {label} {opts}: energy rel err {rel}")
        worst = max(worst, rel)
        if (opts, label) in grouped_runs:
            label_runs.append((f"grouped {label} on curie_platform(280)", plat, wl, cfg, s))
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
            same, rel, _ = held_against_oracle(metrics, np, splat, wl, cfg, s)
            check(same, f"grouped {label}{suffix}: schedule")
            check(rel <= 1e-5, f"grouped {label}{suffix}: energy rel err {rel}")
            worst = max(worst, rel)
    print(f"phase 4 grouped rules 9-10: the {len(LABELS)} labels +Forecast (horizon "
          f"1800) on curie_platform(280) and +DVFS on dvfs_platform_example(280), "
          f"{len(wl)} replayed jobs, on cuda == oracle (schedule exact, energy and "
          f"mode energy rel err <= {worst:.2e}), occupancy kernel launches == "
          f"n_batches, in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. the main path at CEA-Curie scale, dense ----
    plat, wl, cfg = dense_in
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
    oracle = oracles[0].get()
    oracle_wait_s, oracle_s = time.perf_counter() - t0, oracle[2]
    same, rel, m = held_against_oracle(metrics, np, plat, wl, cfg, s, oracle)
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
          f"s in a worker process (waited for {oracle_wait_s:.2f} s); peak device "
          f"memory {peak_mib:.1f} MiB", flush=True)

    # ---- 6. the main path at CEA-Curie scale, grouped ----
    plat, wl, cfg = grouped_in
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
    oracle = oracles[1].get()
    g_oracle_wait_s, g_oracle_s = time.perf_counter() - t0, oracle[2]
    oracle_pool.join()
    same, rel, m = held_against_oracle(metrics, np, plat, wl, cfg, s, oracle)
    check(same, "grouped main path schedule == oracle")
    check(rel <= 1e-5, f"grouped main path energy rel err {rel}")
    t0 = time.perf_counter()
    s2 = engine.simulate(plat, wl, cfg, device="cuda")
    g_wall_s = time.perf_counter() - t0
    check(np.array_equal(metrics.schedule_table(s2), metrics.schedule_table(s)),
          "grouped rerun schedule")
    g_state, g_cfg = s, cfg  # phase 10's reactive base
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
          f"{g_oracle_s:.2f} s in a worker process (waited for {g_oracle_wait_s:.2f} "
          f"s); peak device memory {g_peak_mib:.1f} MiB",
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

    sound, sound_exact = refill_gaps(torch, model, queue, stats["tokens"], REFILLED, 1280)
    fault, fault_exact = refill_gaps(torch, model, queue, shared_stats["tokens"], REFILLED,
                                     1280)
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
    with torch.inference_mode():
        for _ in range(2):
            model.prefill(prompt, cache_len=1280)
        torch.cuda.synchronize()
        def one_prefill():
            t0 = time.perf_counter()
            model.prefill(prompt, cache_len=1280)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        prof, prefill_wall = captured(torch, one_prefill, "phase 8's prefill")
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
            dprof, wall = captured(torch, lambda pos=pos: decode_steps(pos, 1),
                                   "phase 8's decode step")
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
    xl_cut = xl.replace(n_layers=2 * XPAIRS)  # the serve's and the f32 check's depth
    n_pairs = xl_cut.block_program()[0][1]  # one stage of xlstm_pair blocks
    stats = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    event_fuse.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()
    xresult = serve.main(XSERVE_ARGS, stats=stats, config=xl_cut)
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
    print(f"phase 9 serve: {XARCH} full width bf16 on cuda at {n_pairs} of its "
          f"{xl.n_layers // 2} pairs, 16 requests x 1024 "
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
        def one_step():
            t0 = time.perf_counter()
            model.decode_step(step_tok, cache, 1100)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        dprof, decode_wall = captured(torch, one_step, "phase 9's decode step")
    dec_dev = [e.device_time_total / 1e3 for e in dprof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"phase 9 serve: one bf16 decode step (4 slots) profiled: wall "
          f"{1e3 * decode_wall:.2f} ms, {top_level_ops(torch, dprof)} top-level host "
          f"ops, {len(dec_dev)} device ops, device {sum(dec_dev):.3f} ms (busy "
          f"{100 * sum(dec_dev) / (1e3 * decode_wall):.1f} %)", flush=True)
    del model, cache
    torch.cuda.empty_cache()

    # the kernel route against the plain route, full width, f32
    model = build_model(xl_cut.replace(dtype_name="float32"), "cuda").init(
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
    print(f"phase 9 serve: f32 full width at {n_pairs} pairs, 2 x 1024-token prompts, "
          f"prefill by the kernel route ({2 * n_pairs} launches) vs the plain route: last-position "
          f"logits max abs diff {x_diff:.3g} (largest |logit| {x_scale:.3g}, "
          f"tolerance {LOGITS_REL_TOL} of it); greedy first tokens kernel {xtok_k}, "
          f"plain {xtok_p}; phase wall {time.perf_counter() - t9:.1f} s", flush=True)

    # ---- 10. power rules 9-10 at Curie scale, grouped ----
    torch.cuda.empty_cache()
    fc_by_kernel, dv_by_kernel = phase10(torch, np, swf, g_state, g_cfg)

    # ---- 11. the batched sweep at Curie scale ----
    torch.cuda.empty_cache()
    sweep_dense, sweep_e, sweep_f, e8_rows = phase11(torch, np, swf)

    # ---- 12. the RL stack ----
    torch.cuda.empty_cache()
    rl_by_part = phase12(torch, np, swf, tmp)

    # ---- 13. the experiment layer and the service ----
    torch.cuda.empty_cache()
    exp_by_part = phase13(torch, np, tmp, fig45_oracles, e8_rows)

    # ---- 14. the dense, hybrid, MoE, VLM and encoder-decoder archs ----
    torch.cuda.empty_cache()
    lm_by_arch = phase14(torch, np)

    # ---- 15. LM training ----
    torch.cuda.empty_cache()
    train_launches, p15 = phase15(torch, np, tmp)

    # ---- 18. the dry run's count on the card ----
    torch.cuda.empty_cache()
    rl18 = phase18(torch, np, p15)

    # ---- 16. mixed block programs, standalone stages, the legacy loop ----
    torch.cuda.empty_cache()
    warm17 = start_workers(torch)  # phase 17's workers start beside it
    p16 = phase16(torch, np, label_runs, swf)

    # ---- 17. sharded sweeps and rollouts, one worker process per card ----
    torch.cuda.empty_cache()
    p17 = phase17(torch, np, swf, e8_rows, warm17)

    # ---- 19. the pipeline and elastic resharding on phase 17's workers ----
    torch.cuda.empty_cache()
    pipe19, elastic19 = phase19(torch, np, swf)

    # ---- 20. tensor-parallel training and prefill on the same workers ----
    torch.cuda.empty_cache()
    tp20 = phase20(torch, np, p15["losses"])

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
            row["cluster"] = clusters[key]
        if (kname, 8) in clusters:
            row.update(cluster_e8=clusters[kname, 8], ms_e8=timing[kname, 8][0],
                       cluster_e64=clusters[kname, 64], ms_e64=timing[kname, 64][0])
        if kname in draw_turns:
            row["ms_in_turns_with_draw"] = draw_turns[kname]
        row["launches_by_path"] = {
            "phase 5 dense": dense_by_kernel[kname],
            "phase 6 grouped": grouped_by_kernel[kname],
            "phase 10 forecast": fc_by_kernel[kname],
            "phase 10 dvfs": dv_by_kernel[kname],
            "sweep_dense": sweep_dense if kname == "event_fuse_ledger" else 0,
            "phase 11 (e) options grouped": sweep_e.get(kname, 0),
            "phase 11 (f) options dense": sweep_f.get(kname, 0),
            **{f"phase 12 {part}": got[kname] for part, got in rl_by_part.items()},
            **{f"phase 13 {part}": got[kname] for part, got in exp_by_part.items()},
            "phase 16 legacy": p16["legacy"][kname],
            **{f"phase 17 sharded {part}": got[kname] for part, got in p17.items()},
            "phase 18 spars-rl": rl18[kname],
            "phase 19 elastic": elastic19[kname],
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
              note="no engine path calls it; timed at [1, 11200], and in turns "
                   "with the ledger kernel (ms_in_turns_with_draw of both rows)"),
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
            "by_shape": flash_new,
            "launches_by_path": {
                f"phase 8 {ARCH}": flash_launches,
                **{f"phase 14 {a}": got["flash_attention"] for a, got in lm_by_arch.items()},
                "phase 15 train": train_launches["flash_attention"],
                "phase 16 mixed": p16["mixed"]["flash_attention"],
                "phase 16 recurrent stages": p16["recurrent"]["flash_attention"],
                "phase 19 pipeline": pipe19["flash_attention"],
                "phase 20 tp prefill": tp20["flash_attention"],
            },
            "launches_by_path_variant": {
                path: {r: got[f"flash_attention_{r}"] for r in ("wgmma", "simt")}
                for path, got in (
                    (f"phase 8 {ARCH}", flash_routes),
                    *((f"phase 14 {a}", got) for a, got in lm_by_arch.items()),
                    ("phase 16 mixed", p16["mixed"]),
                    ("phase 16 recurrent stages", p16["recurrent"]),
                    ("phase 19 pipeline", pipe19),
                    ("phase 20 tp prefill", tp20))
            },
            "note": "timed at the serve prefill shape (B 1, S 1024, H 16, KH 8, "
                    "hd 128) in bf16, causal: ms is the wgmma kernel (every main-path "
                    "launch), simt_ms the SIMT kernel on the same inputs, ms_f32 the "
                    "SIMT kernel in f32; by_shape: phase 14's prefill shapes on the "
                    "variant the table names (whisper's unmasked; hd 80 bf16 also on "
                    "the SIMT kernel in turns, simt_ms); launches_by_path_variant: "
                    "each path's launches by kernel (phase 15 launches none); library: "
                    "scaled_dot_product_attention(is_causal as the shape's mask, "
                    "enable_gqa)",
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
            "ms_mamba2": ssd_time[64][0], "plain_ms_mamba2": ssd_time[64][1],
            "bound_ms_mamba2": ssd_time[64][2], "bound_by_mamba2": ssd_time[64][3],
            "host_ms_mamba2": ssd_time[64][4],
            "launches_by_path": {
                f"phase 9 {XARCH} at {XPAIRS} pairs": ssd_launches,
                **{f"phase 14 {a}": got["ssd_scan"] for a, got in lm_by_arch.items()},
                "phase 15 train": train_launches["ssd_scan"],
                "phase 16 mixed": p16["mixed"]["ssd_scan"],
                "phase 16 recurrent stages": p16["recurrent"]["ssd_scan"],
            },
            "note": "timed at the xLSTM serve prefill shape (B 1, S 1024, H 4, dk "
                    "512, chunk 128; q bf16, k f32, v bf16, zero h0) at dv 512 "
                    "(ms, plain_ms, bound_ms) and at the normaliser's dv 1 (*_dv1); "
                    "half the main path's calls are each; *_mamba2 at zamba2-2.7b's "
                    "Mamba-2 prefill (B 1, S 1024, H 80, dk = dv = 64, q a stride-0 "
                    "view of C over the heads); launches counts wrapper "
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
