"""The PyTorch port's simulation service (``repro_torch.launch.sim_serve``)
on the CPU: the reference's two-request cache self-test, the round-robin
interleave (a short grid finishes before a long one submitted first), error
responses for a malformed spec and for a file that is not JSON while the
service keeps serving, the reference's response keys, and ``--stdin`` with
a path line and an inline JSON line.
"""
import io
import json
import os

import pytest

from repro.core import engine as jengine
from repro.launch import sim_serve as jserve
from repro_torch.core import sweep
from repro_torch.experiments import Experiment
from repro_torch.launch import sim_serve

CPU = "cpu"


def _spec(name, timeouts=(60, 600), schedulers=("EASY PSUS", "FCFS PSAS"), **kw):
    return Experiment(name=name, workload={"preset": "fig3_small", "n_jobs": 30},
                      platform=16, schedulers=schedulers, timeouts=timeouts, **kw)


def test_second_same_shaped_request_is_all_cache_hits(capsys):
    responses = sim_serve._smoke(None, device=CPU)
    assert [r["status"] for r in responses] == ["done", "done"]
    assert "serve-smoke OK" in capsys.readouterr().out
    assert sim_serve.main(["--smoke", "--device", "cpu"])[1]["compile_cache"] == {
        "hits": 1, "misses": 0}


def test_round_robin_lets_a_short_grid_finish_first(tmp_path):
    service = sim_serve.SimService(str(tmp_path), chunk_scenarios=1, device=CPU)
    service.submit("long", _spec("long", timeouts=(60, 300, 900)))
    service.submit("short", _spec("short", schedulers=("EASY PSUS",), timeouts=(60,)))
    before = sweep.cache_stats()
    done = service.drain()
    assert [r["request"] for r in done] == ["short", "long"]
    long, short = service.responses["long"], service.responses["short"]
    assert (long["rows"], long["chunks"]) == (6, 6)
    assert (short["rows"], short["chunks"]) == (1, 1)
    # the one-point grid runs alone (no sweep); the long grid's 6 chunks
    # are sweeps of one row, of one grid key
    after = sweep.cache_stats()
    assert (after["sweep_hits"] - before["sweep_hits"]
            + after["sweep_misses"] - before["sweep_misses"]) == 6
    assert short["compile_cache"] == {"hits": 0, "misses": 0}
    for name in ("long", "short"):
        with open(os.path.join(tmp_path, name, "metrics.json")) as f:
            assert len(json.load(f)["rows"]) == service.responses[name]["rows"]


@pytest.fixture(scope="module")
def responses(tmp_path_factory):
    """The port's and the reference's ``serve`` on the same request
    directory: a good spec, a spec missing its workload and a file that is
    not JSON."""
    root = tmp_path_factory.mktemp("serve")
    req = root / "req"
    req.mkdir()
    _spec("good").save(str(req / "good.json"))
    (req / "broken.json").write_text('{"name": "broken"}')
    (req / "garbled.json").write_text("this is not json")
    # a cold LRU on both sides, as a fresh process has: an earlier test file
    # in the same worker may have compiled this grid key for the reference
    sweep.clear_cache()
    jengine._SWEEP_FNS.clear()
    port = sim_serve.serve(str(req), str(root / "port"), once=True, device=CPU)
    ref = jserve.serve(str(req), str(root / "ref"), once=True)
    return root, port, ref


def test_malformed_requests_get_error_responses_and_serving_goes_on(responses):
    root, port, _ = responses
    by = {r["request"]: r for r in port}
    assert by["broken"]["status"] == "error" and "TypeError" in by["broken"]["error"]
    assert by["garbled"]["status"] == "error"
    assert "JSONDecodeError" in by["garbled"]["error"]
    assert by["good"]["status"] == "done" and by["good"]["rows"] == 4
    for name in ("good", "broken", "garbled"):
        with open(root / "port" / f"{name}.response.json") as f:
            assert json.load(f) == by[name]


def test_responses_have_the_reference_keys(responses):
    _, port, ref = responses
    by_port = {r["request"]: r for r in port}
    by_ref = {r["request"]: r for r in ref}
    assert sorted(by_port) == sorted(by_ref)
    for name, r in by_ref.items():
        assert sorted(by_port[name]) == sorted(r), name
        assert by_port[name]["status"] == r["status"], name
    good, ref_good = by_port["good"], by_ref["good"]
    for k in ("rows", "chunks", "compile_cache", "devices"):
        assert good[k] == ref_good[k], k
    assert good["n_compiles"] is None


def test_stdin_takes_a_path_line_and_an_inline_json_line(tmp_path, monkeypatch, capsys):
    _spec("from-file").save(str(tmp_path / "from-file.json"))
    inline = json.dumps(json.loads(_spec("inline", timeouts=(120,)).to_json()))
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"{tmp_path / 'from-file.json'}\n\n{inline}\n"))
    out = sim_serve.main(["--stdin", "--once", "--responses", str(tmp_path / "resp"),
                          "--device", "cpu"])
    by = {r["request"]: r for r in out}
    assert sorted(by) == ["from-file", "stdin-0"]
    assert by["from-file"]["rows"] == 4 and by["stdin-0"]["rows"] == 2
    assert all(r["status"] == "done" for r in out)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == out


def test_cli_needs_a_source_and_the_service_needs_cuda_unless_asked():
    import torch

    with pytest.raises(SystemExit):
        sim_serve.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sim_serve.SimService("unused")
