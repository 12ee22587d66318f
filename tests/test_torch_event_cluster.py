"""The cluster-split event kernels (``event_fuse_ledger``, ``event_fuse_occ``)
and their lean wrappers.

On the CPU: the cluster size each ``[E, N]`` call takes, the one allocation
that holds both outputs, the plain route at unaligned row lengths, and every
rejection the wrappers make, with its message. On the card (``cuda``
marker; skipped without one): each kernel against its plain version bit for
bit at rows that start off a 16-byte boundary, at G = 64 and G =
``MAX_GROUPS``, with dead lanes and with arrays at different alignments,
one launch a call at the cluster size :func:`event_fuse.cluster_size`
names. Inputs are drawn with numpy from a seed. The module imports no jax,
so the card's tests also run where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import event_fuse

POWER = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
H100_SMS = 132


def _inputs(e, n, seed=0):
    """(state, until, t): states 0..4, ``until`` straddling ``t``."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    return state, until, t


def _group_id(n, g, seed=0):
    """Sorted group ids: contiguous groups, as platforms lay them out."""
    rng = np.random.default_rng(seed + 7 * n + g)
    return np.sort(rng.integers(0, g, n)).astype(np.int32)


def _dead_lanes(state, gid, g):
    """Every fifth state 7, and group ids -1 and G at the ends: nodes that
    count in no cell."""
    state, gid = state.copy(), gid.copy()
    state[:, ::5] = 7
    gid[0], gid[-1] = -1, g
    return state, gid


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


# ---------------------------------------------------------------------------
# CPU: the Python side of the redesign
# ---------------------------------------------------------------------------

OCC, LEDGER = "event_fuse_occ", "event_fuse_ledger"


@pytest.mark.parametrize("name,e,n,max_c,want", [
    (OCC, 1, 11200, 16, 16),     # the engine's grouped call: one row over 16 CTAs
    (LEDGER, 1, 11200, 16, 4),   # the dense call: the ledger's CTAs keep 2048 nodes
    (OCC, 1, 11200, 8, 8),       # a card that holds clusters of 8 at most
    (OCC, 3, 11199, 16, 16),
    (LEDGER, 3, 11199, 16, 4),
    (OCC, 64, 11200, 16, 4),     # 256 CTAs: two per SM
    (LEDGER, 64, 11200, 16, 4),
    (OCC, 132, 11200, 16, 2),
    (OCC, 264, 11200, 16, 1),
    (OCC, 1, 2048, 16, 4),       # at least 512 nodes a CTA
    (LEDGER, 1, 4096, 16, 2),
    (OCC, 1, 1023, 16, 1),       # a row under 1024 nodes stays on one CTA
    (LEDGER, 1, 1023, 16, 1),
    (OCC, 1, 16, 16, 1),
    (OCC, 13, 131, 16, 1),
])
def test_cluster_size_fills_the_card_and_keeps_work_per_cta(name, e, n, max_c, want):
    min_nodes = event_fuse.MIN_CTA_NODES[name]
    c = event_fuse.cluster_size(e, n, H100_SMS, max_c, min_nodes)
    assert c == want
    assert c & (c - 1) == 0 and 1 <= c <= max_c
    assert c == 1 or n // c >= min_nodes


@pytest.mark.parametrize("shape", [(1, 8), (64, 8), (1, 3, 8), (2, 64, 8), (3, 1536, 8)])
def test_both_outputs_are_disjoint_views_of_one_allocation(shape):
    e = shape[0]
    like = torch.zeros((e, 4), dtype=torch.int32)
    vals, nxt = event_fuse._outputs(like, shape, e)
    assert vals.shape == shape and vals.dtype == torch.float32
    assert nxt.shape == (e,) and nxt.dtype == torch.int32
    assert vals.is_contiguous() and nxt.is_contiguous()
    assert vals.untyped_storage().data_ptr() == nxt.untyped_storage().data_ptr()
    # the kernels write next right after the values: at element E * cells
    start = vals.data_ptr()
    assert nxt.data_ptr() == start + 4 * vals.numel()
    vals.fill_(1.5)
    nxt.fill_(-7)
    assert bool((vals == 1.5).all()) and bool((nxt == -7).all())


@pytest.mark.parametrize("e,n,g", [(3, 11199, 3), (2, 11201, 3), (2, 1001, 64)])
def test_cpu_route_at_unaligned_rows_is_the_plain_version(e, n, g):
    state, until, t = _inputs(e, n)
    gid = _group_id(n, g)
    before = dict(event_fuse.LAUNCHES), dict(event_fuse.CLUSTER)
    s, u, tt, pw, gi = _on("cpu", state, until, t, POWER, gid)
    for got, want in (
        (event_fuse.event_fuse_ledger(s, u, tt, pw),
         event_fuse.event_fuse_ledger_plain(s, u, tt, pw)),
        (event_fuse.event_fuse_occ(s, u, tt, gi, g),
         event_fuse.event_fuse_occ_plain(s, u, tt, gi, g)),
    ):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (dict(event_fuse.LAUNCHES), dict(event_fuse.CLUSTER)) == before


def _ledger_args(bad):
    s, u, t, p = _on("cpu", *_inputs(2, 16), POWER)
    if bad == "state_dtype":
        s = s.long()
    elif bad == "state_1d":
        s, u = s[0], u[0]
    elif bad == "until_shape":
        u = u[:, :8]
    elif bad == "t_shape":
        t = t[:1]
    elif bad == "t_dtype":
        t = t.long()
    elif bad == "power_shape":
        p = p[:4]
    elif bad == "power_dtype":
        p = p.double()
    elif bad == "mixed_devices":
        u = u.to("meta")
    elif bad == "meta":
        s, u, t, p = (x.to("meta") for x in (s, u, t, p))
    return s, u, t, p


LEDGER_REJECTIONS = [
    ("state_dtype", TypeError, "node_state must be torch.int32, got torch.int64"),
    ("state_1d", ValueError, r"node_state and node_until must be \[E, N\] of one shape"),
    ("until_shape", ValueError, r"node_state and node_until must be \[E, N\] of one shape"),
    ("t_shape", ValueError, r"t must be \[2\], got \(1,\)"),
    ("t_dtype", TypeError, "t must be torch.int32, got torch.int64"),
    ("power_shape", ValueError, r"power must be \[5\], got \(4,\)"),
    ("power_dtype", TypeError, "power must be torch.float32, got torch.float64"),
    ("mixed_devices", ValueError, "node_until is on meta, node_state on cpu"),
    ("meta", ValueError, "runs on cuda or cpu, not meta"),
]


@pytest.mark.parametrize("name", ["event_fuse_ledger", "event_fuse"])
@pytest.mark.parametrize("bad,exc,msg", LEDGER_REJECTIONS)
def test_ledger_and_draw_wrappers_keep_every_rejection(name, bad, exc, msg):
    with pytest.raises(exc, match=f"{name}: {msg}" if bad != "meta" else f"{name} {msg}"):
        getattr(event_fuse, name)(*_ledger_args(bad))


OCC_REJECTIONS = [
    ("no_groups", ValueError, "n_groups must be in 1..1536, got 0"),
    ("too_many_groups", ValueError, "n_groups must be in 1..1536, got 1537"),
    ("gid_dtype", TypeError, "group_id must be torch.int32, got torch.int64"),
    ("gid_shape", ValueError, r"group_id must be \[16\], got \(8,\)"),
    ("gid_device", ValueError, "group_id is on meta, node_state on cpu"),
    ("state_dtype", TypeError, "node_state must be torch.int32, got torch.int64"),
    ("until_shape", ValueError, "node_state and node_until must be"),
    ("meta", ValueError, "event_fuse_occ runs on cuda or cpu, not meta"),
]


@pytest.mark.parametrize("bad,exc,msg", OCC_REJECTIONS)
def test_occ_wrapper_keeps_every_rejection(bad, exc, msg):
    s, u, t, gid = _on("cpu", *_inputs(2, 16), _group_id(16, 3))
    g = 3
    if bad == "no_groups":
        g = 0
    elif bad == "too_many_groups":
        g = event_fuse.MAX_GROUPS + 1
    elif bad == "gid_dtype":
        gid = gid.long()
    elif bad == "gid_shape":
        gid = gid[:8]
    elif bad == "gid_device":
        gid = gid.to("meta")
    elif bad == "state_dtype":
        s = s.long()
    elif bad == "until_shape":
        u = u[:, :8]
    elif bad == "meta":
        s, u, t, gid = (x.to("meta") for x in (s, u, t, gid))
    with pytest.raises(exc, match=msg):
        event_fuse.event_fuse_occ(s, u, t, gid, g)


def test_check_names_the_cpu_device_of_a_call_it_accepts():
    """The one check returns the device the wrappers route on: a CPU call,
    contiguous or not, goes to the plain version."""
    s, u, t, p = _on("cpu", *_inputs(2, 16), POWER)
    for args in ((s, u, t, p), (s.t().contiguous().t(), u, t, p)):
        dev = event_fuse._check("event_fuse_ledger", *args[:3], "power", args[3],
                                (5,), torch.float32)
        assert dev == torch.device("cpu")


# ---------------------------------------------------------------------------
# the card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _poison():
    """Leave NaN bytes in the allocator's free blocks, so an output element
    the kernel does not write cannot pass for a zero."""
    junk = [torch.full((1 << k,), float("nan"), device="cuda") for k in range(4, 18)]
    del junk


def _hold(name, fn, plain, args, e, n):
    """One launch at the cluster size the wrapper names; bit for bit."""
    _poison()
    before = event_fuse.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert event_fuse.LAUNCHES[name] == before + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_c, _ = event_fuse.cluster_setup(name, args[0].get_device())
    assert max_c in (8, 16)
    assert event_fuse.CLUSTER[name] == event_fuse.cluster_size(
        e, n, sms, max_c, event_fuse.MIN_CTA_NODES[name])
    want = plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert got[0].untyped_storage().data_ptr() == got[1].untyped_storage().data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", [(1, 11200), (3, 11199), (2, 11201), (64, 11200),
                                 (1, 16), (1, 1023), (5, 4097), (7, 3)])
def test_cuda_ledger_kernel_matches_plain_bit_for_bit(e, n):
    _need_card()
    args = _on("cuda", *_inputs(e, n), POWER)
    _hold("event_fuse_ledger", event_fuse.event_fuse_ledger,
          event_fuse.event_fuse_ledger_plain, args, e, n)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,g,dead", [
    (1, 11200, 3, False), (3, 11199, 3, False), (2, 11201, 3, False),
    (64, 11200, 3, False), (1, 11200, 64, False), (2, 11201, 64, False),
    (1, 11200, event_fuse.MAX_GROUPS, False), (3, 5003, event_fuse.MAX_GROUPS, False),
    (1, 11200, 3, True), (2, 11201, 3, True), (13, 131, 3, True),
])
def test_cuda_occ_kernel_matches_plain_bit_for_bit(e, n, g, dead):
    _need_card()
    state, until, t = _inputs(e, n)
    gid = _group_id(n, g)
    if dead:
        state, gid = _dead_lanes(state, gid, g)
    s, u, tt, gi = _on("cuda", state, until, t, gid)
    _hold("event_fuse_occ", event_fuse.event_fuse_occ, event_fuse.event_fuse_occ_plain,
          (s, u, tt, gi, g), e, n)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(1, 0, 0), (0, 3, 2), (2, 1, 3)])
def test_cuda_kernels_take_arrays_at_different_alignments(shift):
    """State, until and group ids that start 4, 8 or 12 bytes past a 16-byte
    boundary, each its own: the kernels fall back to scalar loads for an
    array whose quads are not aligned with the state row's."""
    _need_card()
    e, n, g = 2, 11201, 3
    state, until, t = _inputs(e, n)
    gid = _group_id(n, g)

    def offset(a, k):
        buf = torch.zeros(a.size + 4, dtype=torch.int32, device="cuda")
        view = buf[k:k + a.size].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    s, u, gi = offset(state, shift[0]), offset(until, shift[1]), offset(gid, shift[2])
    tt, pw = _on("cuda", t, POWER)
    _hold("event_fuse_ledger", event_fuse.event_fuse_ledger,
          event_fuse.event_fuse_ledger_plain, (s, u, tt, pw), e, n)
    _hold("event_fuse_occ", event_fuse.event_fuse_occ, event_fuse.event_fuse_occ_plain,
          (s, u, tt, gi, g), e, n)


@pytest.mark.cuda
def test_cuda_zero_sizes_launch_nothing():
    _need_card()
    before = dict(event_fuse.LAUNCHES)
    for e, n in ((0, 16), (4, 0)):
        s, u, t, pw = _on("cuda", *_inputs(e, n), POWER)
        gi = torch.zeros((n,), dtype=torch.int32, device="cuda")
        sums, nxt = event_fuse.event_fuse_ledger(s, u, t, pw)
        occ, nxt2 = event_fuse.event_fuse_occ(s, u, t, gi, 3)
        assert sums.shape == (e, 8) and occ.shape == (e, 3, 8)
        assert not sums.any() and not occ.any()
        assert bool((nxt == 2**30).all()) and bool((nxt2 == 2**30).all())
    assert dict(event_fuse.LAUNCHES) == before
