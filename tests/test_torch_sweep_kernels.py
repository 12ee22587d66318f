"""The event kernels' per-row tables, which the batched sweep hands them
(``core/sweep.py``): ``event_fuse_ledger`` with ``power`` of ``[E, 5]`` and
``event_fuse_occ`` with ``group_id`` of ``[E, N]``, one table a row.

The plain versions are held against a per-row call of the shared form and
against the JAX reference's jnp twins (``repro/kernels/ref.py``) row by row;
the wrappers' checks take both forms and name them when they refuse one; on
a machine with an NVIDIA GPU each kernel is held against its plain version,
bit for bit, in both forms. Inputs come from numpy with a fixed seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro_torch.kernels import event_fuse

SHAPES = [(1, 16), (5, 131), (8, 1000), (3, 4097)]
OCC_SHAPES = [(1, 16, 1), (5, 131, 3), (8, 1000, 3), (3, 4097, 64)]


def _inputs(e, n, seed=0):
    """States 0..4, ``until`` straddling ``t``, integer watts a row and
    sorted group ids a row (as platforms lay groups out)."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    power = rng.integers(1, 400, (e, 5)).astype(np.float32)
    return state, until, t, power


def _group_ids(e, n, g, seed=0):
    rng = np.random.default_rng(seed + 7 * n + g)
    return np.sort(rng.integers(0, g, (e, n)), axis=1).astype(np.int32)


def _t(*xs, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in xs]


@pytest.mark.parametrize("e,n", SHAPES)
def test_ledger_per_row_power_is_each_row_on_its_own(e, n):
    state, until, t, power = _inputs(e, n)
    s, u, tt, pw = _t(state, until, t, power)
    sums, nxt = event_fuse.event_fuse_ledger(s, u, tt, pw)
    assert sums.shape == (e, 8) and nxt.shape == (e,)
    for i in range(e):
        one = event_fuse.event_fuse_ledger(s[i:i + 1], u[i:i + 1], tt[i:i + 1], pw[i])
        assert torch.equal(sums[i:i + 1], one[0]) and torch.equal(nxt[i:i + 1], one[1])
        r_sums, r_nxt = ref.event_fuse_ledger_reference(
            jnp.asarray(state[i:i + 1]), jnp.asarray(until[i:i + 1]),
            jnp.asarray(t[i:i + 1]), jnp.asarray(power[i]))
        np.testing.assert_array_equal(nxt[i:i + 1].numpy(), np.asarray(r_nxt))
        # integer watts: the reference's node-by-node f32 sum is exact too
        np.testing.assert_array_equal(sums[i:i + 1].numpy(), np.asarray(r_sums))
    # the shared form is the per-row form with every row's table equal
    same = event_fuse.event_fuse_ledger(s, u, tt, pw[:1].expand(e, 5).contiguous())
    shared = event_fuse.event_fuse_ledger(s, u, tt, pw[0])
    for a, b in zip(same, shared):
        assert torch.equal(a, b)


@pytest.mark.parametrize("e,n,g", OCC_SHAPES)
def test_occ_per_row_group_ids_are_each_row_on_its_own(e, n, g):
    state, until, t, _ = _inputs(e, n)
    gid = _group_ids(e, n, g)
    s, u, tt, gi = _t(state, until, t, gid)
    occ, nxt = event_fuse.event_fuse_occ(s, u, tt, gi, g)
    assert occ.shape == (e, g, 8) and nxt.shape == (e,)
    for i in range(e):
        one = event_fuse.event_fuse_occ(s[i:i + 1], u[i:i + 1], tt[i:i + 1], gi[i], g)
        assert torch.equal(occ[i:i + 1], one[0]) and torch.equal(nxt[i:i + 1], one[1])
        r_occ, r_nxt = ref.event_fuse_occ_reference(
            jnp.asarray(state[i:i + 1]), jnp.asarray(until[i:i + 1]),
            jnp.asarray(t[i:i + 1]), jnp.asarray(gid[i]), g)
        np.testing.assert_array_equal(occ[i:i + 1].numpy(), np.asarray(r_occ))
        np.testing.assert_array_equal(nxt[i:i + 1].numpy(), np.asarray(r_nxt))
    assert occ.sum(dim=(1, 2)).tolist() == [float(n)] * e


@pytest.mark.parametrize("bad,msg", [
    ("rows", r"power must be \[5\], got \(2, 5\) or \[3, 5\] \(one table a row\)"),
    ("width", r"power must be \[5\], got \(3, 4\) or \[3, 5\]"),
    ("rank", r"power must be \[5\], got \(1, 3, 5\)"),
])
def test_ledger_names_both_table_forms_when_it_refuses_one(bad, msg):
    state, until, t, power = _inputs(3, 16)
    p = {"rows": power[:2], "width": power[:, :4], "rank": power[None]}[bad]
    with pytest.raises(ValueError, match=msg):
        event_fuse.event_fuse_ledger(*_t(state, until, t, p))


@pytest.mark.parametrize("bad,msg", [
    ("rows", r"group_id must be \[16\], got \(2, 16\) or \[3, 16\] \(one table a row\)"),
    ("width", r"group_id must be \[16\], got \(3, 8\) or \[3, 16\]"),
])
def test_occ_names_both_table_forms_when_it_refuses_one(bad, msg):
    state, until, t, _ = _inputs(3, 16)
    gid = _group_ids(3, 16, 3)
    gid = {"rows": gid[:2], "width": gid[:, :8]}[bad]
    with pytest.raises(ValueError, match=msg):
        event_fuse.event_fuse_occ(*_t(state, until, t, gid), 3)


def test_draw_kernel_keeps_its_one_shared_table():
    """``event_fuse`` (no engine caller) takes no per-row table."""
    state, until, t, power = _inputs(3, 16)
    with pytest.raises(ValueError, match=r"power must be \[5\], got \(3, 5\)$"):
        event_fuse.event_fuse(*_t(state, until, t, power))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels); none is present")


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", [(8, 11200), (64, 11200), (3, 11201), (5, 131)])
def test_cuda_ledger_per_row_power_matches_plain_bit_for_bit(e, n):
    _need_card()
    state, until, t, power = _inputs(e, n)
    for pw in (power, power[0]):
        args = _t(state, until, t, pw, device="cuda")
        before = event_fuse.LAUNCHES["event_fuse_ledger"]
        got = event_fuse.event_fuse_ledger(*args)
        want = event_fuse.event_fuse_ledger_plain(*args)
        torch.cuda.synchronize()
        assert event_fuse.LAUNCHES["event_fuse_ledger"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,g", [(8, 11200, 3), (64, 11200, 3), (3, 11201, 64),
                                   (5, 131, 3)])
def test_cuda_occ_per_row_group_ids_match_plain_bit_for_bit(e, n, g):
    _need_card()
    state, until, t, _ = _inputs(e, n)
    gid = _group_ids(e, n, g)
    for gi in (gid, gid[0]):
        args = _t(state, until, t, gi, device="cuda")
        before = event_fuse.LAUNCHES["event_fuse_occ"]
        got = event_fuse.event_fuse_occ(*args, g)
        want = event_fuse.event_fuse_occ_plain(*args, g)
        torch.cuda.synchronize()
        assert event_fuse.LAUNCHES["event_fuse_occ"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
