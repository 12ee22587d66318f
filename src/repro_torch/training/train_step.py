"""Train and eval steps — the reference's ``training/train_step.py``:
loss, gradients and the optimizer update, with microbatch gradient
accumulation and optional gradient compression.

``make_train_step(model, optimizer, cfg)`` returns ``train_step(opt_state,
batch) -> (opt_state, metrics)``, which updates ``model``'s parameters in
place (the reference returns new params). A step:

1. runs the forward and backward on the plain routes (``attn_impl =
   "naive"``, ``gla_impl = "plain"``, set here for the step's forward and
   put back after): the CUDA kernels compute forwards only and refuse
   inputs that require grad, and the reference trains through autograd
   over plain XLA code; with ``accum_steps > 1`` the batch is split into
   ``(accum, B / accum)`` microbatches, run one after another, their
   gradients summed in f32 and divided by ``accum``, the loss their mean;
2. stacks the gradients into the reference's leaves
   (``models/convert.py`` ``reference_leaves``), compresses them
   (``compression``), clips them by their global norm and hands them with
   the stacked parameters to the optimizer, whose state is kept in that
   layout (the reference's ``OptState``);
3. writes the updated leaves back into the module's tensors.

Stacking and unstacking every step costs a copy of the parameters and of
the gradients (``PERF.md`` §5 says what it costs on the card). The metrics
are ``loss`` and ``grad_norm`` (before clipping), and with ``accum_steps ==
1`` the loss's ``ce``, ``aux`` and ``tokens``, as in the reference: 0-d
tensors on the model's device, read when the caller reads them.

On a tensor-parallel rank (``model.tp``, ``training/tensor_parallel.py``)
the same step runs on the rank's shards: after the backward, step 2 first
reduces the gradients (summed over the data group; a replicated leaf used
inside a sharded region, also over the model group) and takes the global
norm over the whole, unsharded set; the metrics are summed over the data
group. Compression under it raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 12c.6.

``batch_axes`` and ``grad_specs`` pin shardings of a device mesh; they
raise ``NotImplementedError`` naming item 12c.6: the rank grid of
``training/tensor_parallel.py`` takes their place.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.convert import RefLeaf, leaves_to_tree, reference_leaves, tree_values
from repro_torch.models.transformer import Transformer
from repro_torch.training.compression import COMPRESSORS
from repro_torch.training.optimizer import (
    LearningRate, Optimizer, OptState, adafactor, adamw, apply_updates, clip_by_global_norm,
)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    accum_steps: int = 1
    max_grad_norm: float = 1.0
    compression: Optional[str] = None  # None | "int8" | "topk" (see compression.py)
    # the reference's mesh pins (batch axes of the microbatch split, the
    # gradient accumulator's PartitionSpecs): item 12c.6
    batch_axes: Optional[Tuple[str, ...]] = None
    grad_specs: Optional[Any] = None


def make_optimizer(name: str, lr: LearningRate) -> Optimizer:
    """The reference's: ``adamw(b2=0.95, weight_decay=0.1)`` with bf16
    moments, or ``adafactor``."""
    if name == "adafactor":
        return adafactor(lr=lr)
    if name == "adamw":
        return adamw(lr=lr, b2=0.95, weight_decay=0.1, moment_dtype=torch.bfloat16)
    raise KeyError(name)


@contextlib.contextmanager
def plain_routes(model: Transformer):
    """The model's attention and GLA routes set to the plain ones, and put
    back on exit."""
    routes = model.attn_impl, model.gla_impl
    model.attn_impl, model.gla_impl = "naive", "plain"
    try:
        yield model
    finally:
        model.attn_impl, model.gla_impl = routes


def batch_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on ``device``; tokens int64."""
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def init_opt_state(model: Transformer, optimizer: Optimizer) -> OptState:
    """``optimizer.init`` over the model's parameters in the reference's
    leaves."""
    return optimizer.init([leaf.stack() for leaf in reference_leaves(model)])


def opt_state_to_tree(state, leaves: List[RefLeaf]):
    """An optimizer state whose per-leaf lists become reference parameter
    trees: the reference's ``OptState`` pytree, as a checkpoint holds it."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)._make(opt_state_to_tree(x, leaves) for x in state)
    if isinstance(state, list):
        return leaves_to_tree(leaves, state)
    return state


def opt_state_from_tree(tree, leaves: List[RefLeaf], device):
    """The inverse of :func:`opt_state_to_tree`, every leaf a tensor on
    ``device`` (bf16 leaves come back from a checkpoint as tensors)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(opt_state_from_tree(x, leaves, device) for x in tree)
    if isinstance(tree, dict):
        return [torch.as_tensor(v, device=device) for v in tree_values(leaves, tree)]
    if tree is None:
        return None
    return torch.as_tensor(tree, device=device)


def microbatches(n: int, body: Callable[[int, Any], Any], carry: Any) -> Any:
    """``carry = body(i, carry)`` for each of the ``n`` microbatches, in
    order (the dry run, ``launch/dryrun.py``, counts this loop by its trip
    count)."""
    for i in range(n):
        carry = body(i, carry)
    return carry


def make_train_step(
    model: Transformer,
    optimizer: Optimizer,
    cfg: TrainStepConfig = TrainStepConfig(),
) -> Callable[[OptState, Dict[str, Any]], Tuple[OptState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``; the
    model's parameters are made trainable and updated in place."""
    if cfg.batch_axes is not None or cfg.grad_specs is not None:
        raise NotImplementedError(
            "TrainStepConfig.batch_axes and grad_specs pin shardings of a device mesh; "
            "the PyTorch port shards a model over the rank grid of "
            "training/tensor_parallel.py instead (ROADMAP Queue 1 item 12c.6)"
        )
    tp = model.tp
    if tp is not None and cfg.compression:
        raise NotImplementedError(
            f"compression {cfg.compression!r} on a tensor-parallel rank "
            "(ROADMAP Queue 1 item 12c.6)")
    compress = COMPRESSORS[cfg.compression] if cfg.compression else None
    model.requires_grad_(True)
    leaves = reference_leaves(model)
    params = list(model.parameters())

    def grads_of(batch):
        for p in params:
            p.grad = None
        with plain_routes(model):
            loss, metrics = model.loss(batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def grad_of(t: torch.Tensor) -> torch.Tensor:
        return t.grad if t.grad is not None else torch.zeros_like(t)

    def train_step(opt_state: OptState, batch: Dict[str, Any]):
        batch = batch_tensors(batch, model.device)
        if cfg.accum_steps == 1:
            loss, metrics = grads_of(batch)
            grads = [leaf.stack(grad_of) for leaf in leaves]
        else:
            a = cfg.accum_steps
            micro = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:]) for k, v in batch.items()}
            gsum = {p: torch.zeros(p.shape, dtype=F32, device=p.device) for p in params}

            def accumulate(i, lsum):
                loss, _ = grads_of({k: v[i] for k, v in micro.items()})
                for p, acc in gsum.items():
                    acc.add_(grad_of(p).to(F32))
                return lsum + loss

            lsum = microbatches(a, accumulate, torch.zeros((), dtype=F32, device=model.device))
            grads = [leaf.stack(lambda p: gsum[p] / a) for leaf in leaves]
            loss, metrics = lsum / a, {}
        for p in params:
            p.grad = None
        norm = None
        if tp is not None:
            grads = tp.reduce_grads(grads)
            norm = tp.global_norm(grads)
            loss = tp.data_sum(loss)
            metrics = {k: v if k == "tokens" else tp.data_sum(v) for k, v in metrics.items()}
        if compress is not None:
            grads = compress(grads)
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm, norm)
        stacked = [leaf.stack() for leaf in leaves]
        updates, opt_state = optimizer.update(grads, opt_state, stacked)
        del grads
        for leaf, p in zip(leaves, apply_updates(stacked, updates)):
            leaf.write(p)
        return opt_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def make_eval_step(model: Transformer) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """``eval_step(batch) -> {"loss", "ce", "aux", "tokens"}``, without
    autograd (so the model's own routes, kernels included, serve it)."""

    def eval_step(batch):
        with torch.no_grad():
            loss, metrics = model.loss(batch_tensors(batch, model.device))
        return {"loss": loss, **metrics}

    return eval_step
