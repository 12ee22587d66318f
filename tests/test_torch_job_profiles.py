"""The PyTorch port's ``profiles`` workload and its architecture numbers,
against the JAX reference: ``profile_workload()`` is the reference's job
for job (default and other arguments), the profiles are the reference's,
the numbers of all ten architectures are the reference's ``ArchConfig``
fields, and ``"profiles"`` resolves in the experiment spec and in
``launch/sim``.
"""
import dataclasses

import pytest

from repro.configs import get_arch as ref_arch
from repro.configs import list_archs as ref_list
from repro.configs import job_profiles as jprof
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import job_profiles as tprof
from repro_torch.experiments import resolve_workload
from repro_torch.launch import sim as tsim

def test_ten_archs_are_the_references():
    assert list_archs() == ref_list() and len(list_archs()) == 10


@pytest.mark.parametrize("name", sorted(ref_list()))
def test_config_numbers_equal_the_reference_fields(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(ref_arch(name))


def test_profiles_are_the_references():
    def key(ps):
        return [(p.name, p.nodes, p.runtime_s, p.kind) for p in ps]

    assert key(tprof.build_profiles()) == key(jprof.build_profiles())
    assert key(tprof.build_profiles(chips=64, steps_per_job=50)) == key(
        jprof.build_profiles(chips=64, steps_per_job=50))
    assert tprof.PEAK_FLOPS_BF16 == 197e12  # the reference's modelled constant


@pytest.mark.parametrize("kw", [{}, dict(n_jobs=300, nb_nodes=64, seed=3,
                                         mean_interarrival=600.0, overreq_factor=2.0)])
def test_profile_workload_is_the_reference_job_for_job(kw):
    port, ref = tprof.profile_workload(**kw), jprof.profile_workload(**kw)
    assert port.nb_res == ref.nb_res and len(port) == len(ref)
    assert [dataclasses.astuple(j) for j in port.jobs] == [
        dataclasses.astuple(j) for j in ref.jobs]


def test_profiles_resolve_in_the_spec_and_the_driver(tmp_path):
    wl = resolve_workload("profiles")
    assert [dataclasses.astuple(j) for j in wl.jobs] == [
        dataclasses.astuple(j) for j in jprof.profile_workload().jobs]
    row = tsim.run({"workload": "profiles", "platform": 128, "timeout": 900,
                    "gantt": False, "out": str(tmp_path)}, device="cpu")
    assert row["n_jobs"] == 200 and not row.get("truncated")
