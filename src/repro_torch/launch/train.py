"""End-to-end LM training driver with fault tolerance — the reference's
``launch/train.py`` on PyTorch, with its flags (plus ``--device``: cuda
unless ``cpu`` is asked for) and its printed lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 200 --batch 8 --seq 1024 --ckpt-dir out/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 20 --batch 2 --seq 32 --ckpt-every 5 --ckpt-dir out/ckpt

* restart from the latest checkpoint: re-running the command resumes from
  the newest step (``[train] resumed from step N``), the token stream from
  that step's batch, so a crash and restart consumes the sequence an
  uninterrupted run would have;
* ``save_async`` every ``--ckpt-every`` steps and at the last step, of
  ``{"params": the reference's parameter tree, "opt": its OptState}``
  (``models/convert.py``, ``training/train_step.py``), which the
  reference's ``Checkpointer.restore`` reads, and the other way round;
* the cosine schedule (warm-up 20) and the arch's ``make_optimizer``;
* the straggler watchdog on step wall time;
* ``--compression int8|topk`` and ``--accum`` (gradient accumulation);
* ``--fail-at N``: after step N (and after the outstanding checkpoint
  write) the process exits hard with code 17, the fault-tolerance test's
  simulated failure.

Weights are drawn from ``--seed`` with a ``torch.Generator`` on the device
(not the reference's ``jax.random`` numbers); VLM and audio archs get the
reference's seeded stub image embeds or encoder frames
(:func:`modality_extras`).

``--model-parallel M`` (with ``--devices N`` ranks, default M, so D = N /
M) trains on a ``("data", "model")`` grid of worker ranks
(``training/tensor_parallel.py``: the dense decoders, tensor-parallel over
M, data-parallel over D), one card a rank unless ``--device cpu``;
``--backend`` picks ``gloo`` or ``nccl`` (default: nccl where every rank
has its own card, else gloo) and is printed. Checkpoints hold the
reference's full layout, assembled from the ranks' blocks, so a run at M =
2 resumes at M = 2 and its checkpoint restores at M = 1. Any other arch or
layout under it raises ``NotImplementedError`` naming ROADMAP Queue 1
item 12c.6.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --model-parallel 2 --steps 20 --batch 2 --seq 32 --ckpt-dir out/ckpt_tp
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenStream, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.convert import leaves_to_tree, reference_leaves, tree_values
from repro_torch.core import shard
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.optimizer import Optimizer, cosine_schedule
from repro_torch.training.stragglers import StepWatchdog, WatchdogConfig
from repro_torch.training.tensor_parallel import Grid, check_supported
from repro_torch.training.train_step import (
    TrainStepConfig, init_opt_state, make_optimizer, make_train_step, opt_state_from_tree,
    opt_state_to_tree,
)


def modality_extras(cfg):
    """Stub-frontend tensors for VLM/audio archs (precomputed embeddings)."""

    def fn(batch: Dict[str, np.ndarray], index: int) -> Dict[str, np.ndarray]:
        b = batch["tokens"].shape[0]
        rng = np.random.default_rng(index)
        if cfg.n_image_embeds:
            batch["image_embeds"] = rng.normal(
                size=(b, cfg.n_image_embeds, cfg.d_model)
            ).astype(np.float32)
        if cfg.encoder_layers:
            batch["encoder_frames"] = rng.normal(
                size=(b, cfg.encoder_seq, cfg.d_model)
            ).astype(np.float32)
        return batch

    return fn


def scheduled_optimizer(name: str, lr: float, steps: int, warmup: int = 20) -> Optimizer:
    """The arch's optimizer on the launcher's cosine schedule (warm-up 20);
    a module-level function, so a ``partial`` of it reaches the ranks."""
    return make_optimizer(name, cosine_schedule(lr, warmup_steps=warmup, total_steps=steps))


Step = Callable[[Dict[str, Any]], Tuple[float, float]]


def _one_device(args, cfg, dev, ckpt, make_opt) -> Tuple[int, Step, Callable, Callable]:
    """(start step, a step of a batch -> (loss, grad norm), the checkpoint
    tree, a closer) on one device."""
    model = build_model(cfg, dev)
    leaves = reference_leaves(model)
    opt = make_opt()
    step_fn = make_train_step(
        model, opt, TrainStepConfig(accum_steps=args.accum, compression=args.compression))

    def state_tree(opt_state) -> Dict[str, Any]:
        return {"params": leaves_to_tree(leaves, [leaf.stack() for leaf in leaves]),
                "opt": opt_state_to_tree(opt_state, leaves)}

    start_step = ckpt.latest_step()
    if start_step is None:
        start_step = 0
        model.init(torch.Generator(dev).manual_seed(args.seed))
        opt_state = init_opt_state(model, opt)
        print(f"[train] fresh init: {model.n_params():,} params")
    else:
        _, state = ckpt.restore(state_tree(init_opt_state(model, opt)), step=start_step)
        for leaf, value in zip(leaves, tree_values(leaves, state["params"])):
            leaf.write(torch.as_tensor(value, device=dev))
        opt_state = opt_state_from_tree(state["opt"], leaves, dev)
        print(f"[train] resumed from step {start_step}")
    holder = [opt_state]

    def step(batch):
        holder[0], metrics = step_fn(holder[0], batch)
        return float(metrics["loss"]), float(metrics["grad_norm"])

    return start_step, step, lambda: state_tree(holder[0]), lambda: None


def _grid(args, cfg, dev, ckpt, make_opt) -> Tuple[int, Step, Callable, Callable]:
    """The same on a tensor-parallel grid of worker ranks."""
    step_cfg = TrainStepConfig(accum_steps=args.accum, compression=args.compression)
    check_supported(cfg, args.model_parallel, step_cfg)
    meta = build_model(cfg, "meta")
    leaves = reference_leaves(meta)
    start_step = ckpt.latest_step()
    params = opt_tree = None
    if start_step is not None:
        like = {"params": leaves_to_tree(leaves, [leaf.stack() for leaf in leaves]),
                "opt": opt_state_to_tree(init_opt_state(meta, make_opt()), leaves)}
        _, state = ckpt.restore(like, step=start_step)
        params, opt_tree = state["params"], state["opt"]
    grid = Grid(cfg, args.model_parallel, args.devices or args.model_parallel,
                make_optimizer=make_opt, step_cfg=step_cfg, params=params, opt_state=opt_tree,
                seed=args.seed, device=dev, backend=args.backend)
    mesh = grid.mesh
    print(f"[train] grid data {mesh['data']} x model {mesh['model']} on {dev.type} "
          f"cards {list(grid.workers.cards)}, backend {grid.backend}")
    if start_step is None:
        start_step = 0
        print(f"[train] fresh init: {meta.n_params():,} params")
    else:
        print(f"[train] resumed from step {start_step}")

    def step(batch):
        metrics = grid.step(batch)
        return metrics["loss"], metrics["grad_norm"]

    return start_step, step, grid.state_tree, grid.close


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compression", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the (data, model) grid (default: --model-parallel)")
    ap.add_argument("--backend", default=None, choices=[None, "gloo", "nccl"],
                    help="the grid's collectives (default: nccl with a card a rank, "
                         "else gloo)")
    ap.add_argument("--ckpt-dir", default="out/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    make_opt = functools.partial(scheduled_optimizer, cfg.optimizer, args.lr, args.steps)
    ckpt = Checkpointer(os.path.join(args.ckpt_dir, cfg.name.replace("/", "_")))
    on_grid = args.model_parallel > 1 or (args.devices or 1) > 1
    start_step, step_fn, state_tree, close = (_grid if on_grid else _one_device)(
        args, cfg, dev, ckpt, make_opt)

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    it = make_batch_iterator(stream, start_index=start_step, extra_fn=modality_extras(cfg))
    watchdog = StepWatchdog(
        WatchdogConfig(patience=3, threshold=3.0),
        on_straggler=lambda s, dt, base: print(
            f"[watchdog] step {s}: {dt:.3f}s vs baseline {base:.3f}s — straggler flag"
        ),
    )

    losses = []
    t_start = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = next(it)
            with watchdog:
                loss, gnorm = step_fn(batch)
            losses.append(loss)
            if (step + 1) % args.log_every == 0:
                print(
                    f"[train] step {step+1}/{args.steps} loss={loss:.4f} "
                    f"gnorm={gnorm:.3f} "
                    f"({watchdog.history[-1]*1e3:.0f} ms)"
                )
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                ckpt.save_async(step + 1, state_tree())
            if args.fail_at is not None and step + 1 >= args.fail_at:
                ckpt.wait()
                print(f"[train] simulated failure at step {step+1}; exiting hard", flush=True)
                it.close()
                close()  # a grid's workers would die with this process anyway
                shard.shutdown()
                os._exit(17)
        ckpt.wait()
    finally:
        it.close()
        close()

    wall = time.time() - t_start
    result = {
        "arch": cfg.name,
        "steps_run": args.steps - start_step,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": round(wall, 2),
        "straggler_flags": watchdog.fired,
    }
    print("[train] done:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
