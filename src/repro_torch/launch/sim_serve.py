"""Simulation-as-a-service on PyTorch: a persistent grid-study server —
the counterpart of the reference's ``launch/sim_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.sim_serve --requests req/ --once
    PYTHONPATH=src python -m repro_torch.launch.sim_serve --requests req/   # watch
    echo spec.json | PYTHONPATH=src python -m repro_torch.launch.sim_serve --stdin
    PYTHONPATH=src python -m repro_torch.launch.sim_serve --smoke   # self-test

Requests are :mod:`repro_torch.experiments` spec JSON files dropped into a
request directory (or streamed as paths / inline JSON lines on stdin), each
answered with a response JSON reporting rows, per-request wall time, and
whether the request's grid reused an already-seen grid structure from the
sweep's LRU of static keys (``sweep.cache_stats()``: the key is the
reference's static trace structure plus the grid width and device count).
The port compiles nothing, so a hit saves no compile; the counters keep the
reference's response keys and its serving contract (a user re-running a
study, or a second user sweeping a same-shaped grid, is all hits).

Many users' grids run *interleaved*: each request becomes a
``run(..., stream=True)`` :class:`~repro_torch.experiments.StreamingRun`
and the service round-robins one completed chunk per active request per
turn, so a short grid is never stuck behind a long one. Every grid runs on
``--device`` (default ``cuda``; ``cpu`` on a machine without a card);
``--devices`` follows the sweep's contract (None, an int D or ``"all"``):
every launch shards its scenario axis over D worker processes, one per
card, bit for bit the unsharded launch, and the response's ``"devices"``
reports the resolved D. The workers start with the first sharded launch
and serve every later one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.core import sweep
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments import Experiment, StreamingRun
from repro_torch.experiments import run as run_experiment


@dataclasses.dataclass
class _Request:
    """One in-flight spec: its streaming run plus the response accounting."""

    name: str
    experiment: Experiment
    stream: StreamingRun
    t_submit: float
    rows_done: int = 0
    chunks_done: int = 0
    cache_hits: int = 0
    cache_misses: int = 0


class SimService:
    """The serving core, usable in-process (the smoke test drives it
    directly) or through the CLI loop below.

    ``submit`` turns a spec into a streaming run; ``step`` advances every
    active request by one completed chunk (round-robin — the interleave)
    and returns the responses of requests that finished this turn. Cache
    reuse is attributed per request by snapshotting ``sweep.cache_stats()``
    around each chunk: all of a request's ``sweep_async`` calls happen
    inside its own ``next()`` calls, so the hit/miss delta belongs to the
    request being advanced.
    """

    def __init__(
        self,
        out_root: str,
        devices: Optional[Any] = None,
        chunk_scenarios: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.out_root = out_root
        self.devices = devices
        self.chunk_scenarios = chunk_scenarios
        self.device = resolve_device(device)
        self.active: List[_Request] = []
        self.responses: Dict[str, dict] = {}

    def submit(self, name: str, spec: Any) -> None:
        """Queue one request. ``spec`` is an :class:`Experiment`, a parsed
        spec mapping, or spec JSON text; a spec without ``out`` lands in
        ``<out_root>/<name>/`` (metrics.json + rows.csv, written
        incrementally by the streaming runner)."""
        if isinstance(spec, Experiment):
            exp = spec
        elif isinstance(spec, str):
            exp = Experiment.from_json(spec)
        else:
            exp = Experiment(**dict(spec))
        if exp.out is None:
            exp = dataclasses.replace(
                exp, out=os.path.join(self.out_root, name)
            )
        stream = run_experiment(
            exp,
            stream=True,
            devices=self.devices,
            chunk_scenarios=self.chunk_scenarios,
            device=self.device,
        )
        self.active.append(_Request(name, exp, stream, time.perf_counter()))

    def step(self) -> List[dict]:
        """One round-robin turn: advance each active request by one chunk;
        returns (and records) the response dicts of requests that completed
        or failed this turn."""
        finished: List[dict] = []
        still: List[_Request] = []
        for req in self.active:
            before = sweep.cache_stats()
            try:
                chunk_rows = next(req.stream)
            except StopIteration:
                finished.append(self._finish(req, error=None))
                continue
            except Exception as e:  # a bad spec must not kill the service
                finished.append(self._finish(req, error=f"{type(e).__name__}: {e}"))
                continue
            after = sweep.cache_stats()
            req.cache_hits += after["sweep_hits"] - before["sweep_hits"]
            req.cache_misses += after["sweep_misses"] - before["sweep_misses"]
            req.rows_done += len(chunk_rows)
            req.chunks_done += 1
            still.append(req)
        self.active = still
        return finished

    def drain(self) -> List[dict]:
        """Run every queued request to completion; returns all responses."""
        out: List[dict] = []
        while self.active:
            out.extend(self.step())
        return out

    def _finish(self, req: _Request, error: Optional[str]) -> dict:
        result = req.stream.result
        response = {
            "request": req.name,
            "status": "error" if error else "done",
            "wall_s": round(time.perf_counter() - req.t_submit, 4),
            "rows": req.rows_done,
            "chunks": req.chunks_done,
            # grid-structure reuse against the persistent LRU of sweep keys
            "compile_cache": {
                "hits": req.cache_hits, "misses": req.cache_misses,
            },
            "devices": sweep._resolve_devices(
                self.devices, req.experiment.engine_config(), self.device
            ),
            "out": req.experiment.out,
        }
        if error:
            response["error"] = error
        elif result is not None:
            response["n_compiles"] = result.n_compiles
        self.responses[req.name] = response
        return response


def _write_response(responses_dir: str, response: dict) -> None:
    os.makedirs(responses_dir, exist_ok=True)
    path = os.path.join(responses_dir, f"{response['request']}.response.json")
    with open(path, "w") as f:
        json.dump(response, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps(response, sort_keys=True))


def serve(
    requests_dir: Optional[str],
    responses_dir: str,
    use_stdin: bool = False,
    once: bool = False,
    poll_s: float = 0.5,
    devices: Optional[Any] = None,
    chunk_scenarios: Optional[int] = None,
    device: DeviceLike = None,
) -> List[dict]:
    """The CLI loop: poll ``requests_dir`` for new ``*.json`` specs (and/or
    read stdin lines: a spec path, or inline spec JSON), interleave all
    active grids, write one response JSON per request. ``once`` exits when
    the queue is empty (after ingesting whatever is already there)."""
    service = SimService(
        out_root=os.path.join(responses_dir, "out"),
        devices=devices,
        chunk_scenarios=chunk_scenarios,
        device=device,
    )
    seen = set()
    n_stdin = 0
    all_responses: List[dict] = []
    stdin_open = use_stdin

    def ingest_dir():
        if not requests_dir or not os.path.isdir(requests_dir):
            return
        for fname in sorted(os.listdir(requests_dir)):
            if not fname.endswith(".json") or fname in seen:
                continue
            seen.add(fname)
            with open(os.path.join(requests_dir, fname)) as f:
                text = f.read()
            _submit(fname[: -len(".json")], text)

    def _submit(name, text):
        try:
            service.submit(name, text)
        except Exception as e:  # malformed spec -> error response, keep serving
            resp = {
                "request": name, "status": "error",
                "error": f"{type(e).__name__}: {e}",
            }
            service.responses[name] = resp
            all_responses.append(resp)
            _write_response(responses_dir, resp)

    def ingest_stdin():
        nonlocal stdin_open, n_stdin
        if not stdin_open:
            return
        line = sys.stdin.readline()
        if not line:  # EOF: no more stdin requests
            stdin_open = False
            return
        line = line.strip()
        if not line:
            return
        if line.startswith("{"):
            _submit(f"stdin-{n_stdin}", line)
            n_stdin += 1
        else:
            with open(line) as f:
                text = f.read()
            _submit(os.path.splitext(os.path.basename(line))[0], text)

    while True:
        ingest_dir()
        ingest_stdin()
        for response in service.step():
            all_responses.append(response)
            _write_response(responses_dir, response)
        if not service.active:
            if once and not stdin_open:
                break
            if not stdin_open:  # with stdin open, readline is the idle wait
                time.sleep(poll_s)
    return all_responses


def _smoke(devices: Optional[Any], device: DeviceLike = None) -> List[dict]:
    """Self-test: two queued same-shaped grids — the second request's sweep
    MUST hit the first's grid key (hits >= 1, misses == 0) because only
    per-row values (timeouts) differ between the specs."""
    import tempfile

    # start from a cold LRU so the first request's miss is observable even
    # when an earlier sweep in this process ran the same grid shape
    sweep.clear_cache()
    with tempfile.TemporaryDirectory() as td:
        req = os.path.join(td, "req")
        os.makedirs(req)
        base = dict(
            workload={"preset": "fig3_small", "n_jobs": 30},
            platform=16,
            schedulers=["EASY PSUS", "FCFS PSAS"],
        )
        Experiment(name="user-a", timeouts=(60, 600), **base).save(
            os.path.join(req, "user-a.json")
        )
        Experiment(name="user-b", timeouts=(120, 1200), **base).save(
            os.path.join(req, "user-b.json")
        )
        responses = serve(
            req, os.path.join(td, "resp"), once=True, devices=devices,
            device=device,
        )
        by_name = {r["request"]: r for r in responses}
        assert set(by_name) == {"user-a", "user-b"}, sorted(by_name)
        for r in responses:
            assert r["status"] == "done", r
            assert r["rows"] == 4, r
        a, b = by_name["user-a"], by_name["user-b"]
        assert a["compile_cache"]["misses"] >= 1, a
        assert b["compile_cache"] == {"hits": b["chunks"], "misses": 0}, (
            "second request's same-shaped grid did not reuse the grid "
            f"key: {b}"
        )
        print("serve-smoke OK: second request hit the grid cache "
              f"({b['compile_cache']['hits']} hit(s), 0 misses)")
    return responses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", default=None, metavar="DIR",
                    help="directory polled for Experiment spec *.json files")
    ap.add_argument("--responses", default="out/sim_serve", metavar="DIR",
                    help="response JSONs (+ default per-request out dirs)")
    ap.add_argument("--stdin", action="store_true",
                    help="also read requests from stdin (one spec path or "
                         "inline spec JSON per line)")
    ap.add_argument("--once", action="store_true",
                    help="drain the queue and exit instead of watching")
    ap.add_argument("--poll", type=float, default=0.5, metavar="S",
                    help="request-directory poll interval when idle")
    ap.add_argument("--devices", default=None,
                    help='shard each launch across worker processes, one '
                         'per card: an int or "all" (default: unsharded)')
    ap.add_argument("--chunk", type=int, default=None, metavar="K",
                    help="scenarios per streamed launch (default: whole grid)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the two-request cache self-test and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    devices = (
        None if args.devices is None
        else args.devices if args.devices == "all"
        else int(args.devices)
    )
    if args.smoke:
        return _smoke(devices, device=args.device)
    if not args.requests and not args.stdin:
        ap.error("need --requests DIR and/or --stdin (or --smoke)")
    return serve(
        args.requests,
        args.responses,
        use_stdin=args.stdin,
        once=args.once,
        poll_s=args.poll,
        devices=devices,
        chunk_scenarios=args.chunk,
        device=args.device,
    )


if __name__ == "__main__":
    main()
