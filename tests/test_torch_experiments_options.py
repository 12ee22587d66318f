"""The port's experiment layer and service on grids that ask for
``node_order="pack"``, ``allocation="partition"`` or ``merge_bursts``.

A multi-point grid under each option (and all three together), on the
16-node mixed platform written as a platform JSON, runs through
``experiments.run`` blocking and streamed: ``rows.csv`` is the JAX runner's
bytes, and ``metrics.json`` is too, but for ``n_compiles`` (``null`` in the
port, which compiles nothing; 1 in the reference). A one-point grid of each
option takes the single run. A ``SimService`` request with
``allocation="partition"`` comes back with rows, not an error.
"""
import dataclasses
import json
import os

import pytest

from repro import experiments as jexp
from repro_torch import experiments as texp
from repro_torch.launch import sim_serve
from repro_torch.workloads.platform import mixed_platform_example

CPU = "cpu"
FILES = ("metrics.json", "rows.csv")
# jobs no wider than the widest group, wider than most: partition heads that
# fit the unreserved count can find no group
WORKLOAD = {"n_jobs": 30, "nb_res": 16, "max_res": 6, "mean_interarrival": 60.0, "seed": 4}
OPTIONS = {
    "pack": dict(node_order="pack"),
    "partition": dict(allocation="partition", grouped_tables=True),
    "merge": dict(merge_bursts=True, window=3),
    "all": dict(node_order="pack", allocation="partition", merge_bursts=True, window=4,
                grouped_tables=True),
}


@pytest.fixture(scope="module")
def platform_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plat") / "mixed16.json")
    mixed_platform_example(16).save(path)
    return path


def _spec(platform_file, out, **kw):
    return dict(name="options", workload=WORKLOAD, platform=platform_file,
                schedulers=("FCFS PSUS", "EASY PSAS+IPM", "EASY PSUS"),
                timeouts=(120, 900), terminate_overrun=True, out=out, **kw)


def _files(out):
    return {n: open(os.path.join(out, n), "rb").read() for n in FILES}


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_option_grids_write_the_reference_runners_bytes(platform_file, tmp_path, opt):
    out = str(tmp_path / "out")
    spec = _spec(platform_file, out, **OPTIONS[opt])
    ref = jexp.run(jexp.Experiment(**spec))
    want = _files(out)
    want["metrics.json"] = want["metrics.json"].replace(
        b'"n_compiles": 1,', b'"n_compiles": null,')
    port = texp.run(texp.Experiment(**spec), device=CPU)
    assert len(port.rows) == len(ref.rows) == 6
    assert _files(out) == want
    sr = texp.run(texp.Experiment(**spec), stream=True, chunk_scenarios=4, device=CPU)
    assert [len(c) for c in sr] == [4, 2]
    assert sr.result.rows == port.rows
    assert _files(out) == want


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_a_one_point_grid_of_each_option_runs_alone(platform_file, opt):
    """The one-point check of the grids that used to be refused: a single
    scheduler and timeout take the single run, and give the grid's row."""
    spec = _spec(platform_file, None, **OPTIONS[opt])
    grid = texp.run(texp.Experiment(**spec), device=CPU)
    one = dataclasses.replace(texp.Experiment(**spec), schedulers=("EASY PSUS",),
                              timeouts=(900,))
    row, = texp.run(one, device=CPU).rows
    assert row["n_jobs"] == 30 and not row.get("truncated")
    assert row == grid.rows[-1]


def test_a_partition_request_is_served_with_rows(platform_file, tmp_path):
    service = sim_serve.SimService(str(tmp_path), chunk_scenarios=4, device=CPU)
    spec = _spec(platform_file, None, **OPTIONS["partition"])
    service.submit("partition", spec)
    done = service.drain()
    assert [r["request"] for r in done] == ["partition"]
    resp = service.responses["partition"]
    assert resp["status"] == "done" and resp["rows"] == 6 and resp["chunks"] == 2, resp
    grid = texp.run(texp.Experiment(**dict(spec, out=str(tmp_path / "blocking"))),
                    device=CPU)
    served = _files(os.path.join(tmp_path, "partition"))
    assert served["rows.csv"] == _files(grid.experiment.out)["rows.csv"]
    assert json.loads(served["metrics.json"])["rows"] == list(grid.rows)
