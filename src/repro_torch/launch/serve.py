"""Batched LM serving on PyTorch: prefill + decode with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --requests 16 --slots 4 --prompt-len 1024 --max-new 32 --cache-len 1280
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --reduced --device cpu --prompt-len 16 --per-slot-positions
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --reduced --device cpu --prompt-len 16 --per-slot-positions

``--arch`` takes every architecture the reference registers: the dense
``internlm2-1.8b``, ``glm4-9b``, ``stablelm-3b`` and ``qwen3-14b``, the
MoE ``qwen2-moe-a2.7b`` and ``grok-1-314b`` (at ``--reduced`` only: its
full weights are 628 GB), the hybrid ``zamba2-2.7b``, ``xlstm-350m``, the
VLM ``internvl2-26b`` and the encoder-decoder ``whisper-tiny``. As the
reference's loop does, each prefill gets zero front-end inputs: ``[1,
n_image_embeds, D]`` image embeds, ``[1, encoder_seq, D]`` encoder frames.

The counterpart of the reference's ``launch/serve.py``, with the same flags
(plus ``--device``: cuda unless ``cpu`` is asked for), the same loop and the
same result keys and ``[serve] done:`` line:

* slot-based continuous batching over a fixed decode batch of ``--slots``
  sequences; a finished sequence frees its slot and the next queued request
  is prefilled into it;
* one shared position counter for the batch (prompts have one length), and
  the reference's drain when ``pos + 1`` reaches the cache length;
* greedy tokens (``argmax``, the first maximum on ties);
* zero image embeds or encoder frames at each prefill, for the archs that
  take them (:func:`front_end_inputs`).

The shared counter is the reference's, and it is wrong for a refilled slot:
the new request decodes at the batch's position instead of its own prompt
length, so RoPE takes the wrong angle and attention reads the zero keys in
between (ROADMAP Queue 3). ``--per-slot-positions`` fixes that: each slot
keeps its own position in a ``[slots]`` device tensor, set to the prompt
length when the slot is filled and advanced by one every step, which
``decode_step`` reads per row. The shared counter's drain does not apply:
a request decodes at positions below ``prompt-len + max-new``, inside the
cache by the start-up check, so each slot ends with its request; an idle
slot's position is held at the cache's last entry. The tokens are then each
request's own greedy prefill + decode. The flag is off by default, so the
loop stays the reference's unless asked. The xLSTM has no positions: the
flag does not change its tokens. zamba2's Mamba-2 layers have none either,
but its shared attention does.

Two differences, both deliberate. The slot's cache insert writes **every
layer** of every field of the stacked cache (the ``[L, B, S, KH, hd]`` keys
and values, zamba2's Mamba-2 states and shared-attention keys and values,
the xLSTM's recurrent states, or whisper's self and cross keys and
values), of every stage of a mixed block program (``main(config=...)``
serves a config whose ``stages`` mix block types); the reference writes only
layer 0 (its insert updates index ``slot`` of axis 1 with ``s[0]``, which is
layer 0's slice of each field; see ROADMAP Queue 3), so its later layers
keep zeros or the slot's previous request. And the cache is preallocated
and written in place, which stands in for the reference's buffer donation.

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on the
device; prompts are drawn from ``numpy.random.default_rng(seed)`` exactly
as the reference draws them.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import Cache


def front_end_inputs(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    """The reference serve loop's prefill extras: zero ``image_embeds``
    ``[batch, n_image_embeds, D]`` and zero ``encoder_frames`` ``[batch,
    encoder_seq, D]`` in the model dtype, for the archs that take them."""
    out = {}
    if cfg.n_image_embeds:
        out["image_embeds"] = torch.zeros((batch, cfg.n_image_embeds, cfg.d_model),
                                          dtype=cfg.dtype, device=device)
    if cfg.encoder_layers:
        out["encoder_frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                            dtype=cfg.dtype, device=device)
    return out


def insert_cache(big: Cache, small: Cache, slot: int) -> None:
    """Write a single-sequence cache into batch slot ``slot``: every field
    (``[L, B, ...]``), every layer, of every stage's cache (a program of
    more than one stage has a tuple of them; an ``enc`` stage's is None)."""
    if torch.is_tensor(big):
        big[:, slot].copy_(small[:, 0])
    elif big is not None:
        for dst, src in zip(big, small):
            insert_cache(dst, src, slot)


def main(argv=None, stats: Optional[Dict[str, Any]] = None,
         config: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Serve ``--requests`` random prompts; print and return the result.

    If ``stats`` is a dict, it also receives ``tokens`` (request id -> its
    generated tokens), ``prefill_s`` (host seconds of each request's prefill
    up to its first token on the host) and ``decode_s`` (host seconds of each
    decode step up to its tokens on the host). ``config`` serves that
    configuration in place of the one ``--arch`` and ``--reduced`` name (a
    caller's cut of the depth, say).
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card, pass cpu")
    ap.add_argument("--per-slot-positions", action="store_true",
                    help="decode each slot at its own position (off: the "
                         "reference's shared counter)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config or get_arch(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, dev).init(gen)
    extras = front_end_inputs(cfg, 1, dev)
    rng = np.random.default_rng(args.seed)

    n_slots = args.slots
    if args.prompt_len + args.max_new > args.cache_len:
        raise ValueError(
            f"--prompt-len {args.prompt_len} + --max-new {args.max_new} exceeds "
            f"--cache-len {args.cache_len}"
        )

    queue = [
        rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ]
    t_submit = {i: time.time() for i in range(len(queue))}

    cache = model.init_cache(n_slots, args.cache_len)
    slot_req = [-1] * n_slots  # request id per slot
    slot_remaining = [0] * n_slots
    cur_tokens = torch.zeros((n_slots, 1), dtype=torch.int64, device=dev)
    pos = args.prompt_len  # uniform prompt length => shared position counter
    per_slot = args.per_slot_positions
    if per_slot:  # each slot's own position, read by decode_step
        slot_pos = torch.full((n_slots,), args.prompt_len, dtype=torch.int64, device=dev)
    ttft: Dict[int, float] = {}
    done_tokens: Dict[int, List[int]] = {}
    prefill_s: List[float] = []
    decode_s: List[float] = []
    next_req = 0
    completed = 0
    decode_steps = 0

    def fill_slot(slot: int) -> None:
        nonlocal next_req
        rid = next_req
        next_req += 1
        t0 = time.perf_counter()
        prompt = torch.from_numpy(queue[rid][None, :]).to(dev)
        logits, small = model.prefill(prompt, cache_len=args.cache_len, **extras)
        tok = int(torch.argmax(logits[0, -1]))
        prefill_s.append(time.perf_counter() - t0)
        ttft[rid] = time.time() - t_submit[rid]
        done_tokens[rid] = [tok]
        slot_req[slot] = rid
        slot_remaining[slot] = args.max_new - 1
        insert_cache(cache, small, slot)
        cur_tokens[slot, 0] = tok
        if per_slot:
            slot_pos[slot] = args.prompt_len

    t0 = time.time()
    with torch.inference_mode():
        for s in range(n_slots):  # initial fill
            if next_req < len(queue):
                fill_slot(s)

        while completed < len(queue):
            t_step = time.perf_counter()
            logits, cache = model.decode_step(cur_tokens, cache,
                                              slot_pos if per_slot else pos)
            decode_steps += 1
            pos += 1
            if per_slot:  # an idle slot's position is held inside the cache
                slot_pos.add_(1).clamp_(max=args.cache_len - 1)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            cur_tokens = nxt[:, None].clone()
            nxt_host = nxt.tolist()
            decode_s.append(time.perf_counter() - t_step)
            for s in range(n_slots):
                rid = slot_req[s]
                if rid < 0:
                    continue
                done_tokens[rid].append(nxt_host[s])
                slot_remaining[s] -= 1
                if slot_remaining[s] <= 0:
                    completed += 1
                    slot_req[s] = -1
                    if next_req < len(queue):
                        fill_slot(s)
            if not per_slot and pos + 1 >= args.cache_len:  # out of cache: drain remaining
                for s in range(n_slots):
                    if slot_req[s] >= 0:
                        completed += 1
                        slot_req[s] = -1
                break

    wall = time.time() - t0
    total_tokens = sum(len(v) for v in done_tokens.values())
    result = {
        "arch": cfg.name,
        "requests": len(queue),
        "decode_steps": decode_steps,
        "total_tokens": total_tokens,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(total_tokens / wall, 1),
        "mean_ttft_s": round(float(np.mean(list(ttft.values()))), 4),
    }
    if stats is not None:
        stats.update(tokens=done_tokens, prefill_s=prefill_s, decode_s=decode_s)
    print("[serve] done:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
