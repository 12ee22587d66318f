"""The PyTorch port's copy of the SWF trace replay (``workloads/traces.py``)
against the JAX reference's: on the ragged warts fixture of
``tests/test_traces.py`` the readers, the adaptations and the replay give
the same jobs, the synthesized Curie trace is the same trace, and the
``swf:`` workload specs resolve to the same workloads. Equality is exact:
these are integer job tables.
"""
import dataclasses

import pytest

from repro.experiments import resolve_workload as j_resolve
from repro.workloads import traces as jtr
from repro.workloads.generator import GeneratorConfig, generate_workload
from repro_torch.experiments import resolve_workload as t_resolve
from repro_torch.workloads import traces as ttr
from repro_torch.workloads.generator import GeneratorConfig as t_GeneratorConfig
from repro_torch.workloads.generator import generate_workload as t_generate

from test_traces import _ragged_swf


def _jobs(wl):
    """The modeled fields of every job, in order, and the node count."""
    return wl.nb_res, [dataclasses.astuple(j) for j in wl.jobs]


@pytest.fixture
def warts(tmp_path):
    path = str(tmp_path / "warts.swf")
    _ragged_swf(path)
    return path


@pytest.mark.parametrize("chunk_jobs", [7, 512, 100_000])
def test_read_swf_matches_reference(warts, chunk_jobs):
    assert _jobs(ttr.read_swf(warts, chunk_jobs=chunk_jobs)) == _jobs(
        jtr.read_swf(warts, chunk_jobs=chunk_jobs)
    )
    assert _jobs(ttr.read_swf(warts, max_jobs=100)) == _jobs(
        jtr.read_swf(warts, max_jobs=100)
    )


def test_iter_swf_chunks_match_reference(warts):
    got = list(ttr.iter_swf_chunks(warts, chunk_jobs=64))
    want = list(jtr.iter_swf_chunks(warts, chunk_jobs=64))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] == b[k]).all() if hasattr(a[k], "shape") else a[k] == b[k]


@pytest.mark.parametrize(
    "kw",
    [
        dict(nb_nodes=16, oversize="clamp", max_jobs=40),
        dict(nb_nodes=64, oversize="drop"),
        dict(procs_per_node=4),
        dict(nb_nodes=320, rebase=False),
    ],
)
def test_replay_workload_matches_reference(warts, kw):
    assert _jobs(ttr.replay_workload(warts, **kw)) == _jobs(
        jtr.replay_workload(warts, **kw)
    )


def test_oversize_error_is_raised_alike(warts):
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match="oversize='clamp' or 'drop'"):
            mod.replay_workload(warts, nb_nodes=16, oversize="error")


def test_synthesized_curie_trace_matches_reference(tmp_path):
    p_t = ttr.synthesize_curie_swf(str(tmp_path / "t.swf"), n_jobs=300)
    p_j = jtr.synthesize_curie_swf(str(tmp_path / "j.swf"), n_jobs=300)
    for kw in (dict(nb_nodes=11_200, oversize="clamp", max_jobs=200),
               dict(nb_nodes=280, oversize="clamp")):
        got = ttr.replay_workload(p_t, **kw)
        assert _jobs(got) == _jobs(jtr.replay_workload(p_j, **kw))
    assert len(got) == 300 and got.nb_res == 280


def test_write_swf_matches_reference(tmp_path):
    """The same workload written by both packages: the same records (the
    header comment names the writer), read back alike by either reader."""
    cfg = dict(n_jobs=120, nb_res=64, seed=13)
    p_t, p_j = str(tmp_path / "t.swf"), str(tmp_path / "j.swf")
    ttr.write_swf(t_generate(t_GeneratorConfig(**cfg)), p_t)
    jtr.write_swf(generate_workload(GeneratorConfig(**cfg)), p_j)
    with open(p_t) as f_t, open(p_j) as f_j:
        assert f_t.read().splitlines()[1:] == f_j.read().splitlines()[1:]
    assert _jobs(ttr.read_swf(p_j)) == _jobs(jtr.read_swf(p_t))


def test_swf_specs_resolve_like_the_reference(warts):
    for spec in (
        f"swf:{warts}",
        {"swf": warts, "nb_nodes": 32, "oversize": "clamp", "max_jobs": 50},
    ):
        assert _jobs(t_resolve(spec)) == _jobs(j_resolve(spec))


def test_bad_swf_specs_are_refused(warts):
    with pytest.raises(ValueError, match="did you mean 'max_jobs'"):
        t_resolve({"swf": warts, "max_job": 5})
    with pytest.raises(ValueError, match="trace replay"):
        t_resolve(f"swf:{warts}", replication=1)
    with pytest.raises(ValueError, match="trace replay"):
        t_resolve({"swf": warts}, replication=2)
