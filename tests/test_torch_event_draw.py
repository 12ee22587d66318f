"""The scalar draw ``event_fuse`` on the cluster design: the ledger kernel's
reduction with a scalar epilogue.

On the CPU: the cluster size each ``[E, N]`` call takes (the ledger's), the
plain draw's fixed order (the five products added s = 0..4, in f32), and
the CPU route at unaligned rows. On the card (``cuda`` marker; skipped
without one): the draw bit for bit and the min equal to the plain
version's at rows that start off a 16-byte boundary and at arrays at
different alignments, one launch a call at the cluster size
:func:`event_fuse.cluster_size` names, both outputs in one allocation, no
launch at zero sizes, and a refusal of watts that require grad. Inputs are
drawn with numpy from a seed. The module imports no jax, so the card's
tests also run where only the port is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import event_fuse

POWER = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
# watts whose sums round in f32: the order of the adds shows in the bits
ODD_POWER = np.asarray([9.1, 190.3, 187.7, 193.9, 8.3], np.float32)
H100_SMS = 132
DRAW, LEDGER = "event_fuse", "event_fuse_ledger"


def _inputs(e, n, seed=0):
    """(state, until, t): states 0..4, ``until`` straddling ``t``."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    return state, until, t


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,n,max_c,want", [
    (1, 11200, 16, 4), (3, 11199, 16, 4), (64, 11200, 16, 4), (1, 4096, 16, 2),
    (1, 4095, 16, 1), (1, 16, 16, 1), (132, 11200, 8, 2), (264, 11200, 16, 1),
])
def test_draw_takes_the_ledgers_cluster_size(e, n, max_c, want):
    """The same reduction, so the same CTAs a row as the ledger."""
    assert event_fuse.MIN_CTA_NODES[DRAW] == event_fuse.MIN_CTA_NODES[LEDGER]
    c = event_fuse.cluster_size(e, n, H100_SMS, max_c, event_fuse.MIN_CTA_NODES[DRAW])
    assert c == want
    assert DRAW in event_fuse.KERNELS and event_fuse.KERNELS.index(DRAW) == 2


@pytest.mark.parametrize("e,n", [(1, 131), (13, 131), (3, 11199), (2, 11201)])
def test_plain_draw_adds_the_five_products_in_order(e, n):
    state, until, t = _inputs(e, n)
    draw, nxt = event_fuse.event_fuse_plain(*_on("cpu", state, until, t, ODD_POWER))
    counts = np.stack([(state == s).sum(axis=1) for s in range(5)], axis=1)
    prod = counts.astype(np.float32) * ODD_POWER
    want = prod[:, 0]
    for s in range(1, 5):
        want = (want + prod[:, s]).astype(np.float32)
    assert draw.dtype == torch.float32 and nxt.dtype == torch.int32
    np.testing.assert_array_equal(draw.numpy().view(np.int32), want.view(np.int32))
    _, ledger_nxt = event_fuse.event_fuse_ledger_plain(*_on("cpu", state, until, t, ODD_POWER))
    assert torch.equal(nxt, ledger_nxt)


def test_cpu_route_at_unaligned_rows_is_the_plain_version():
    state, until, t = _inputs(3, 11199)
    args = _on("cpu", state, until, t, POWER)
    before = dict(event_fuse.LAUNCHES), dict(event_fuse.CLUSTER)
    got = event_fuse.event_fuse(*args)
    want = event_fuse.event_fuse_plain(*args)
    assert (dict(event_fuse.LAUNCHES), dict(event_fuse.CLUSTER)) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _poison():
    """Leave NaN bytes in the allocator's free blocks, so an output element
    the kernel does not write cannot pass for a zero."""
    junk = [torch.full((1 << k,), float("nan"), device="cuda") for k in range(4, 18)]
    del junk


def _hold(args, e, n):
    """One launch at the cluster size the wrapper names; the draw's bits and
    the min equal to the plain version's; one allocation for both."""
    _poison()
    before = event_fuse.LAUNCHES[DRAW]
    draw, nxt = event_fuse.event_fuse(*args)
    torch.cuda.synchronize()
    assert event_fuse.LAUNCHES[DRAW] == before + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_c, _ = event_fuse.cluster_setup(DRAW, args[0].get_device())
    assert event_fuse.CLUSTER[DRAW] == event_fuse.cluster_size(
        e, n, sms, max_c, event_fuse.MIN_CTA_NODES[DRAW])
    want_draw, want_nxt = event_fuse.event_fuse_plain(*args)
    assert draw.shape == (e,) and draw.dtype == torch.float32
    assert torch.equal(draw.view(torch.int32), want_draw.view(torch.int32))
    assert torch.equal(nxt, want_nxt)
    assert draw.untyped_storage().data_ptr() == nxt.untyped_storage().data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", [(1, 11200), (3, 11199), (2, 11201), (64, 11200),
                                 (1, 16), (1, 4096), (5, 4097), (7, 3), (256, 64)])
@pytest.mark.parametrize("power", [POWER, ODD_POWER], ids=["integer", "odd"])
def test_cuda_draw_matches_plain_bit_for_bit(e, n, power):
    _need_card()
    _hold(_on("cuda", *_inputs(e, n), power), e, n)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(1, 0), (0, 3), (2, 1)])
def test_cuda_draw_takes_arrays_at_different_alignments(shift):
    _need_card()
    e, n = 2, 11201
    state, until, t = _inputs(e, n)

    def offset(a, k):
        buf = torch.zeros(a.size + 4, dtype=torch.int32, device="cuda")
        view = buf[k:k + a.size].view(a.shape)
        view.copy_(torch.from_numpy(a))
        return view

    tt, pw = _on("cuda", t, ODD_POWER)
    _hold((offset(state, shift[0]), offset(until, shift[1]), tt, pw), e, n)


@pytest.mark.cuda
def test_cuda_draw_zero_sizes_launch_nothing():
    _need_card()
    before = dict(event_fuse.LAUNCHES)
    for e, n in ((0, 16), (4, 0)):
        draw, nxt = event_fuse.event_fuse(*_on("cuda", *_inputs(e, n), POWER))
        assert draw.shape == (e,) and not draw.any()
        assert bool((nxt == 2**30).all())
    assert dict(event_fuse.LAUNCHES) == before


@pytest.mark.cuda
def test_cuda_draw_refuses_watts_that_require_grad():
    _need_card()
    s, u, t, pw = _on("cuda", *_inputs(1, 131), POWER)
    pw.requires_grad_(True)
    before = dict(event_fuse.LAUNCHES)
    for fn in (event_fuse.event_fuse, event_fuse.event_fuse_ledger):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(s, u, t, pw)
    assert dict(event_fuse.LAUNCHES) == before
    with torch.no_grad():
        _hold((s, u, t, pw), 1, 131)
