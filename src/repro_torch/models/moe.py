"""Mixture-of-Experts FF layer: token-choice top-k routing with per-row
capacity dispatch (dropping), plus optional shared experts (Qwen-MoE style).

The counterpart of the reference's ``models/moe.py``, step for step:

1. router logits ``x.float() @ router`` (the router is always f32), softmax,
   top-k, and the top-k gates renormalised to sum to 1;
2. each batch row's ``S·k`` (token, choice) entries sorted by expert id
   (stable, so within an expert the lowest ``(token, choice)`` index comes
   first) and ranked within their expert; an entry whose rank reaches the
   capacity ``C`` (:func:`capacity`) is dropped to the overflow slot
   ``E·C``;
3. the kept entries' inputs written into a dispatch buffer ``[B, E·C + 1,
   D]`` and the three grouped expert products (SwiGLU) run over every
   expert's ``C`` slots of every row, dense, as the reference's einsums
   ``becd,edf->becf`` and ``becf,efd->becd`` do — at decode too;
4. the combine: each kept entry's output times its gate (cast to the
   activation dtype) added into its token. A token's ``k`` contributions
   are summed in a fixed order, ascending expert id, which is the order in
   which the reference's scatter-add meets them in the sorted dispatch; no
   atomic add, so the bf16 rounding is the same on every run;
5. the shared experts, gated by ``sigmoid(x @ shared_gate)``, and the
   Switch load-balancing aux loss (f32).

The dispatch never crosses batch rows, so a row's output is that row run
alone — at decode (S = 1, capacity 1 an expert) as well.
:func:`moe_reference` is the reference's dense oracle (every expert on
every token, no dropping), for tests; nothing on the serve path calls it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import SwiGLU, dense_init


def capacity(s: int, k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert takes from one batch row of ``s`` tokens: at least 8
    and a multiple of 8 when ``s > 1``; at least 1 at decode."""
    c = int(math.ceil(s * k * capacity_factor / n_experts))
    return max(8, ((c + 7) // 8) * 8) if s > 1 else max(1, c)


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """(probs ``[B, S, E]`` f32, the renormalised top-k gates ``[B, S, k]``
    f32, their expert ids ``[B, S, k]``)."""
    probs = torch.softmax(x.float() @ router, -1)
    gates, expert_ids = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, expert_ids


def dispatch(expert_ids: torch.Tensor, n_experts: int, c: int):
    """Each row's sorted dispatch of its ``N = S·k`` entries: (``order``
    ``[B, N]``, the flat entry at each sorted place; ``keep`` ``[B, N]``,
    whether that entry holds a slot; ``slot`` ``[B, N]``, its slot
    ``expert·C + rank``, or the overflow slot ``E·C``)."""
    b, s, k = expert_ids.shape
    n = s * k
    flat = expert_ids.reshape(b, n)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, -1, order)
    experts = torch.arange(n_experts, device=flat.device, dtype=flat.dtype)
    starts = torch.searchsorted(sorted_e, experts.expand(b, n_experts).contiguous(),
                                side="left")
    rank = torch.arange(n, device=flat.device) - torch.gather(starts, -1, sorted_e)
    keep = rank < c
    slot = torch.where(keep, sorted_e * c + rank, n_experts * c)
    return order, keep, slot


class MoE(nn.Module):
    """Routed experts ``w_gate``/``w_up`` ``[E, D, F]`` and ``w_down`` ``[E,
    F, D]`` in the model dtype, the f32 ``router`` ``[D, E]``, and with
    ``n_shared_experts > 0`` the shared SwiGLU and its ``shared_gate`` ``[D,
    1]`` — the reference's parameters, in its layouts."""

    def __init__(self, d_model: int, n_experts: int, top_k: int, expert_d_ff: int,
                 n_shared_experts: int, shared_d_ff: int, capacity_factor: float, dtype):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        e, d, f = n_experts, d_model, expert_d_ff
        self.router = nn.Parameter(torch.empty((d, e), dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty((e, d, f), dtype=dtype))
        self.w_up = nn.Parameter(torch.empty((e, d, f), dtype=dtype))
        self.w_down = nn.Parameter(torch.empty((e, f, d), dtype=dtype))
        self.shared = self.shared_gate = None
        if n_shared_experts > 0:
            self.shared = SwiGLU(d_model, shared_d_ff, dtype)
            self.shared_gate = nn.Parameter(torch.empty((d, 1), dtype=dtype))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init`` distributions, each expert tensor
        drawn in f32 and cast on its own (a layer at a time, never the
        model's experts at once)."""
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        self.router.copy_(dense_init(generator, d, self.n_experts, torch.float32))
        for w, scale in ((self.w_gate, 1.0 / math.sqrt(d)), (self.w_up, 1.0 / math.sqrt(d)),
                         (self.w_down, 1.0 / math.sqrt(f))):
            draw = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            w.copy_(draw.mul_(scale))
        if self.shared is not None:
            self.shared.init(generator)
            self.shared_gate.copy_(dense_init(generator, d, 1, self.shared_gate.dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x ``[B, S, D]`` -> (y ``[B, S, D]`` in x's dtype, the aux loss, a
        f32 scalar)."""
        b, s, d = x.shape
        e, k = self.n_experts, self.top_k
        n = s * k
        c = capacity(s, k, e, self.capacity_factor)
        probs, gates, expert_ids = route(self.router, x, k)
        order, keep, slot = dispatch(expert_ids, e, c)
        rows = torch.arange(b, device=x.device)[:, None]

        # the kept entries' inputs into their slots; every dropped entry
        # writes zeros into the overflow slot
        buf = x.new_zeros((b, e * c + 1, d))
        buf[rows, slot] = torch.where(keep[..., None], x[rows, order // k], 0)
        xe = buf[:, :e * c].reshape(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)

        # the grouped expert products over every expert's C slots
        h = F.silu(torch.bmm(xe, self.w_gate)) * torch.bmm(xe, self.w_up)
        ye = torch.bmm(h, self.w_down).reshape(e, b, c, d).transpose(0, 1)
        ye = torch.cat([ye.reshape(b, e * c, d), ye.new_zeros((b, 1, d))], 1)

        # the combine, entry by entry in (token, choice) order; each token's
        # k contributions summed in ascending expert id
        slot_of = torch.empty_like(slot).scatter_(-1, order, slot)
        keep_of = torch.empty_like(keep).scatter_(-1, order, keep)
        w = (gates.reshape(b, n) * keep_of).to(ye.dtype)
        contrib = (ye[rows, slot_of] * w[..., None]).reshape(b, s, k, d)
        # spars-lint: ignore[PL005] a token's top-k expert ids are distinct: no ties
        by_expert = torch.argsort(expert_ids, dim=-1)
        contrib = torch.gather(contrib, 2, by_expert[..., None].expand(b, s, k, d))
        y = contrib[:, :, 0]
        for j in range(1, k):
            y = y + contrib[:, :, j]

        if self.shared is not None:
            y = y + self.shared(x) * torch.sigmoid(x @ self.shared_gate)
        frac_tokens = F.one_hot(expert_ids, e).float().mean((0, 1, 2))
        aux = (frac_tokens * probs.mean((0, 1))).sum() * e
        return y.to(x.dtype), aux


def moe_reference(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``moe_apply_reference``: every expert on every token,
    a masked combine in f32, no capacity dropping. The dispatch route must
    match it when the capacity is ample. For tests."""
    b, s, _ = x.shape
    e = moe.n_experts
    _, gates, expert_ids = route(moe.router, x, moe.top_k)
    h = F.silu(torch.einsum("bsd,edf->besf", x, moe.w_gate)) * torch.einsum(
        "bsd,edf->besf", x, moe.w_up)
    ye = torch.einsum("besf,efd->besd", h, moe.w_down)
    weight = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    for kk in range(moe.top_k):
        weight = weight + F.one_hot(expert_ids[..., kk], e) * gates[..., kk:kk + 1]
    y = torch.einsum("besd,bse->bsd", ye.float(), weight).to(x.dtype)
    if moe.shared is not None:
        y = y + moe.shared(x) * torch.sigmoid(x @ moe.shared_gate)
    return y
