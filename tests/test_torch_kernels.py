"""The PyTorch port's event-pass kernels (event_fuse_ledger, event_fuse_occ,
event_fuse): their plain versions against the JAX reference's Pallas kernels
(interpret mode) and jnp oracles, the wrappers' routing and input checks,
and — on a machine with an NVIDIA GPU — each CUDA kernel against its plain
version, bit for bit.

Inputs come from numpy with a fixed seed and go to both packages. ``next``
and the occupancy counts must match exactly; the watts-weighted sums and
draws to rtol 1e-6 (the reference sums f32 watts node by node, the port
multiplies exact counts once per state).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro_torch.core.types import IDLE, INF_TIME, SWITCHING_OFF, SWITCHING_ON
from repro_torch.kernels import _build, event_fuse

POWER = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
SHAPES = [(1, 16), (1, 131), (13, 131), (1, 11200)]


def _inputs(e, n, seed=0):
    """States drawn from 0..4, ``until`` straddling ``t``."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    return state, until, t


def _port(fn, state, until, t, power=POWER, device="cpu"):
    sums, nxt = fn(
        torch.from_numpy(state).to(device), torch.from_numpy(until).to(device),
        torch.from_numpy(t).to(device), torch.from_numpy(power).to(device),
    )
    return sums.cpu().numpy(), nxt.cpu().numpy()


@pytest.mark.parametrize("e,n", SHAPES)
def test_plain_matches_pallas_and_reference(e, n):
    state, until, t = _inputs(e, n)
    sums, nxt = _port(event_fuse.event_fuse_ledger_plain, state, until, t)
    args = (jnp.asarray(state), jnp.asarray(until), jnp.asarray(t),
            jnp.asarray(POWER))
    k_sums, k_nxt = ops.event_fuse_ledger(*args, interpret=True)
    r_sums, r_nxt = ref.event_fuse_ledger_reference(*args)
    assert sums.shape == (e, 8) and sums.dtype == np.float32
    assert nxt.shape == (e,) and nxt.dtype == np.int32
    for other_sums, other_nxt in ((k_sums, k_nxt), (r_sums, r_nxt)):
        np.testing.assert_array_equal(nxt, np.asarray(other_nxt))
        np.testing.assert_allclose(sums, np.asarray(other_sums), rtol=1e-6)
    np.testing.assert_array_equal(sums[:, 5:], 0.0)
    # until straddles t: some switching nodes are in the past, some future
    switching = (state == SWITCHING_ON) | (state == SWITCHING_OFF)
    assert (switching & (until <= t[:, None])).any()
    assert (nxt < int(INF_TIME)).all()


def test_counts_are_exact_for_integer_watts():
    """With integer watts the sums are the exact counts times the watts."""
    state, until, t = _inputs(13, 131, seed=5)
    sums, _ = _port(event_fuse.event_fuse_ledger_plain, state, until, t)
    counts = np.stack([(state == s).sum(axis=1) for s in range(5)], axis=1)
    np.testing.assert_array_equal(sums[:, :5], counts * POWER)


def test_no_switching_node_is_inf():
    e, n = 5, 131
    state = np.full((e, n), IDLE, np.int32)
    _, until, t = _inputs(e, n)
    sums, nxt = _port(event_fuse.event_fuse_ledger, state, until, t)
    np.testing.assert_array_equal(nxt, int(INF_TIME))
    np.testing.assert_array_equal(sums[:, IDLE], n * POWER[IDLE])
    args = (jnp.asarray(state), jnp.asarray(until), jnp.asarray(t),
            jnp.asarray(POWER))
    _, k_nxt = ops.event_fuse_ledger(*args, interpret=True)
    np.testing.assert_array_equal(nxt, np.asarray(k_nxt))


@pytest.mark.parametrize("e,n", [(0, 16), (4, 0), (0, 0)])
def test_zero_size_short_circuits(e, n):
    state = np.zeros((e, n), np.int32)
    t = np.zeros((e,), np.int32)
    sums, nxt = _port(event_fuse.event_fuse_ledger, state, state, t)
    assert sums.shape == (e, 8) and nxt.shape == (e,)
    np.testing.assert_array_equal(sums, 0.0)
    np.testing.assert_array_equal(nxt, int(INF_TIME))
    k_sums, k_nxt = ops.event_fuse_ledger(
        jnp.asarray(state), jnp.asarray(state), jnp.asarray(t),
        jnp.asarray(POWER), interpret=True,
    )
    np.testing.assert_array_equal(sums, np.asarray(k_sums))
    np.testing.assert_array_equal(nxt, np.asarray(k_nxt))


def test_cpu_tensors_take_the_plain_version_without_counting():
    state, until, t = _inputs(13, 131)
    before = dict(event_fuse.LAUNCHES)
    got = _port(event_fuse.event_fuse_ledger, state, until, t)
    want = _port(event_fuse.event_fuse_ledger_plain, state, until, t)
    assert event_fuse.LAUNCHES == before
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "bad",
    ["state_dtype", "until_shape", "t_shape", "power_shape", "power_dtype",
     "device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    state, until, t = (torch.from_numpy(x) for x in _inputs(2, 16))
    power = torch.from_numpy(POWER)
    if bad == "state_dtype":
        state = state.long()
    elif bad == "until_shape":
        until = until[:, :8]
    elif bad == "t_shape":
        t = t[:1]
    elif bad == "power_shape":
        power = power[:4]
    elif bad == "power_dtype":
        power = power.double()
    else:  # neither CPU nor CUDA: launches nothing, falls back to nothing
        state, until, t, power = (
            x.to("meta") for x in (state, until, t, power)
        )
    with pytest.raises((TypeError, ValueError)):
        event_fuse.event_fuse_ledger(state, until, t, power)


def test_build_target_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The library name carries a hash of the source, so an edited kernel
    is rebuilt and never shadowed by a stale library; nothing is built or
    written by asking for the name."""
    name = _build.target("event_fuse")
    assert name.parent == _build.build_dir()
    assert name.suffix == ".so" and name.name.startswith("event_fuse-")
    src = tmp_path / "event_fuse.cu"
    src.write_text((_build.CSRC / "event_fuse.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.target("event_fuse").name != name.name


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", SHAPES + [(64, 11200)])
def test_cuda_kernel_matches_plain_bit_for_bit(e, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state, until, t = _inputs(e, n)
    before = event_fuse.LAUNCHES["event_fuse_ledger"]
    got = _port(event_fuse.event_fuse_ledger, state, until, t, device="cuda")
    torch.cuda.synchronize()
    assert event_fuse.LAUNCHES["event_fuse_ledger"] == before + 1
    want = _port(
        event_fuse.event_fuse_ledger_plain, state, until, t, device="cuda"
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# event_fuse_occ (the grouped path) and event_fuse (the scalar draw)
# --------------------------------------------------------------------------

# (E, N, G): one group; pad-poisoning sizes (E and N off the TPU tiles); the
# engine's Curie shape; eight groups
OCC_SHAPES = [(1, 16, 1), (13, 131, 3), (1, 11200, 3), (2, 131, 8)]


def _group_id(n, g, seed=0):
    """Sorted group ids (contiguous groups, as platforms lay them out)."""
    rng = np.random.default_rng(seed + 7 * n + g)
    return np.sort(rng.integers(0, g, n)).astype(np.int32)


def _port_occ(fn, state, until, t, gid, g, device="cpu"):
    occ, nxt = fn(
        torch.from_numpy(state).to(device), torch.from_numpy(until).to(device),
        torch.from_numpy(t).to(device), torch.from_numpy(gid).to(device), g,
    )
    return occ.cpu().numpy(), nxt.cpu().numpy()


@pytest.mark.parametrize("e,n,g", OCC_SHAPES)
def test_occ_plain_matches_pallas_and_reference(e, n, g):
    state, until, t = _inputs(e, n)
    gid = _group_id(n, g)
    occ, nxt = _port_occ(event_fuse.event_fuse_occ_plain, state, until, t, gid, g)
    args = (jnp.asarray(state), jnp.asarray(until), jnp.asarray(t),
            jnp.asarray(gid))
    k_occ, k_nxt = ops.event_fuse_occ(*args, g, interpret=True)
    r_occ, r_nxt = ref.event_fuse_occ_reference(*args, g)
    assert occ.shape == (e, g, 8) and occ.dtype == np.float32
    assert nxt.shape == (e,) and nxt.dtype == np.int32
    for other_occ, other_nxt in ((k_occ, k_nxt), (r_occ, r_nxt)):
        np.testing.assert_array_equal(occ, np.asarray(other_occ))
        np.testing.assert_array_equal(nxt, np.asarray(other_nxt))
    np.testing.assert_array_equal(occ[:, :, 5:], 0.0)
    # every node counted once, in its own group
    np.testing.assert_array_equal(occ.sum(axis=2), np.broadcast_to(
        np.bincount(gid, minlength=g), (e, g)))


@pytest.mark.parametrize("e,n", SHAPES)
def test_draw_plain_matches_pallas_and_reference(e, n):
    state, until, t = _inputs(e, n)
    draw, nxt = _port(event_fuse.event_fuse_plain, state, until, t)
    args = (jnp.asarray(state), jnp.asarray(until), jnp.asarray(t),
            jnp.asarray(POWER))
    k_draw, k_nxt = ops.event_fuse(*args, interpret=True)
    r_draw, r_nxt = ref.event_fuse_reference(*args)
    assert draw.shape == (e,) and draw.dtype == np.float32
    for other_draw, other_nxt in ((k_draw, k_nxt), (r_draw, r_nxt)):
        np.testing.assert_array_equal(nxt, np.asarray(other_nxt))
        np.testing.assert_allclose(draw, np.asarray(other_draw), rtol=1e-6)
    counts = np.stack([(state == s).sum(axis=1) for s in range(5)], axis=1)
    np.testing.assert_array_equal(draw, (counts * POWER).sum(axis=1))


def _dead_lanes(state, gid, g):
    """Poison every fifth state with 7 and the first and last group ids with
    -1 and G: nodes the occupancy counts must skip."""
    state, gid = state.copy(), gid.copy()
    state[:, ::5] = 7
    gid[0], gid[-1] = -1, g
    return state, gid


def test_occ_counts_only_live_states_and_groups():
    """States outside 0..4 and group ids outside 0..G-1 count nowhere."""
    state, until, t = _inputs(3, 40)
    gid = _group_id(40, 2)
    gid[3] = 2
    state, gid = _dead_lanes(state, gid, 2)
    occ, _ = _port_occ(event_fuse.event_fuse_occ, state, until, t, gid, 2)
    live = (state < 5) & (gid >= 0) & (gid < 2)
    np.testing.assert_array_equal(occ.sum(axis=(1, 2)), live.sum(axis=1))


@pytest.mark.parametrize("e,n", [(0, 16), (4, 0), (0, 0)])
def test_occ_and_draw_zero_sizes_short_circuit(e, n):
    state = np.zeros((e, n), np.int32)
    t = np.zeros((e,), np.int32)
    gid = np.zeros((n,), np.int32)
    occ, nxt = _port_occ(event_fuse.event_fuse_occ, state, state, t, gid, 3)
    assert occ.shape == (e, 3, 8) and nxt.shape == (e,)
    np.testing.assert_array_equal(occ, 0.0)
    np.testing.assert_array_equal(nxt, int(INF_TIME))
    k_occ, k_nxt = ops.event_fuse_occ(
        jnp.asarray(state), jnp.asarray(state), jnp.asarray(t),
        jnp.asarray(gid), 3, interpret=True,
    )
    np.testing.assert_array_equal(occ, np.asarray(k_occ))
    np.testing.assert_array_equal(nxt, np.asarray(k_nxt))
    draw, nxt = _port(event_fuse.event_fuse, state, state, t)
    assert draw.shape == (e,)
    np.testing.assert_array_equal(draw, 0.0)
    np.testing.assert_array_equal(nxt, int(INF_TIME))


def test_occ_and_draw_cpu_tensors_take_the_plain_versions():
    state, until, t = _inputs(13, 131)
    gid = _group_id(131, 3)
    before = dict(event_fuse.LAUNCHES)
    got = _port_occ(event_fuse.event_fuse_occ, state, until, t, gid, 3)
    want = _port_occ(event_fuse.event_fuse_occ_plain, state, until, t, gid, 3)
    got_d = _port(event_fuse.event_fuse, state, until, t)
    want_d = _port(event_fuse.event_fuse_plain, state, until, t)
    assert event_fuse.LAUNCHES == before
    for a, b in zip(got + got_d, want + want_d):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "bad", ["gid_dtype", "gid_shape", "no_groups", "too_many_groups", "device"]
)
def test_occ_wrapper_rejects_what_the_kernel_does_not_take(bad):
    state, until, t = (torch.from_numpy(x) for x in _inputs(2, 16))
    gid = torch.from_numpy(_group_id(16, 3))
    g = 3
    if bad == "gid_dtype":
        gid = gid.long()
    elif bad == "gid_shape":
        gid = gid[:8]
    elif bad == "no_groups":
        g = 0
    elif bad == "too_many_groups":
        g = event_fuse.MAX_GROUPS + 1
    else:
        state, until, t, gid = (x.to("meta") for x in (state, until, t, gid))
    with pytest.raises((TypeError, ValueError)):
        event_fuse.event_fuse_occ(state, until, t, gid, g)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "e,n,g", OCC_SHAPES + [(64, 11200, 3), (1, 11200, 64)]
)
def test_cuda_occ_kernel_matches_plain_bit_for_bit(e, n, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state, until, t = _inputs(e, n)
    gid = _group_id(n, g)
    before = event_fuse.LAUNCHES["event_fuse_occ"]
    got = _port_occ(event_fuse.event_fuse_occ, state, until, t, gid, g, "cuda")
    torch.cuda.synchronize()
    assert event_fuse.LAUNCHES["event_fuse_occ"] == before + 1
    want = _port_occ(
        event_fuse.event_fuse_occ_plain, state, until, t, gid, g, "cuda"
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,g", [(13, 131, 3), (1, 11200, 3)])
def test_cuda_occ_kernel_skips_dead_lanes_as_plain_does(e, n, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state, until, t = _inputs(e, n)
    state, gid = _dead_lanes(state, _group_id(n, g), g)
    got = _port_occ(event_fuse.event_fuse_occ, state, until, t, gid, g, "cuda")
    want = _port_occ(
        event_fuse.event_fuse_occ_plain, state, until, t, gid, g, "cuda"
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", SHAPES + [(64, 11200)])
def test_cuda_draw_kernel_matches_plain_bit_for_bit(e, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    state, until, t = _inputs(e, n)
    before = event_fuse.LAUNCHES["event_fuse"]
    got = _port(event_fuse.event_fuse, state, until, t, device="cuda")
    torch.cuda.synchronize()
    assert event_fuse.LAUNCHES["event_fuse"] == before + 1
    want = _port(event_fuse.event_fuse_plain, state, until, t, device="cuda")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
