"""Deterministic, restart-safe LM data pipeline — a copy of the reference's
``data/pipeline.py`` (numpy only; the port imports nothing of ``repro``), so
batch ``i`` is byte for byte the reference's.

The corpus is synthetic, made from a seed, but the pipeline has the
production properties that matter for the framework:

* **Deterministic addressing**: batch ``i`` is a pure function of
  (seed, i), so a restarted run consumes the exact same stream — the
  checkpoint's ``step`` is the only data-pipeline state (no iterator
  pickling, no skew between hosts).
* **Host-sharded**: each data-parallel host materializes only its slice
  (``host_id/num_hosts``) of the global batch — no host ever holds the
  global batch.
* **Async prefetch**: a double-buffered background thread overlaps host
  batch synthesis with device compute.

The synthetic distribution is a Zipfian unigram mix with Markov bigram
structure (so losses are non-degenerate and compressible — useful for the
train-for-a-few-hundred-steps example to show a real learning curve).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2
    markov_period: int = 16

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """The host's shard of global batch ``index`` (pure function)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, self.host_id])
        )
        b, s, v = self.host_batch, self.seq_len, self.vocab_size
        # Zipf unigram over the vocab, clipped into range
        base = rng.zipf(self.zipf_a, size=(b, s)).astype(np.int64)
        tokens = (base - 1) % v
        # Markov structure: every markov_period-th token repeats its
        # predecessor's bucket, giving bigram signal a model can learn
        rep = (np.arange(s) % self.markov_period) == (self.markov_period - 1)
        tokens[:, 1:][:, rep[1:]] = tokens[:, :-1][:, rep[1:]]
        return {"tokens": tokens.astype(np.int32)}


def make_batch_iterator(
    stream: TokenStream,
    start_index: int = 0,
    prefetch: int = 2,
    extra_fn=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Background-threaded prefetching iterator starting at ``start_index``.

    ``extra_fn(batch, index)`` can append modality-stub tensors
    (image_embeds / encoder_frames) for the VLM/audio archs.
    """
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        i = start_index
        while not stop.is_set():
            b = stream.batch_at(i)
            if extra_fn is not None:
                b = extra_fn(b, i)
            q.put(b)
            i += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()
            try:
                q.get_nowait()  # unblock the producer
            except queue.Empty:
                pass

    return _Iter()
