"""A worker's large result crosses through a ``repro_torch_shard_*`` file
that only its reader removes (``core/shard.py``). When one worker of a
call raises, the other workers' results are still read or discarded
(``shard.gather``), so no such file stays under ``TMPDIR``: through
``Resident.call``, ``Resident.call_each`` and ``shard.gather`` of bare
calls, as the sharded sweep gathers its blocks, whichever worker raises.
The workers here start under a ``TMPDIR`` of the test's own."""
import glob
import tempfile
import time

import pytest
import torch

from repro_torch.core import shard

CPU = torch.device("cpu")
BIG = 2 << 20  # bytes: past shard.SPILL_BYTES, so the result spills to a file


def _fail_or_big(failing: int, who: int):
    """Worker ``failing`` raises at once; the others return 2 MiB a little
    later, so their results arrive after the error."""
    if who == failing:
        raise ArithmeticError(f"worker {who} failed")
    time.sleep(0.3)
    return torch.full((BIG // 4,), float(who))


def _state_fail_or_big(state: int, failing: int):
    return _fail_or_big(failing, state)


@pytest.fixture(scope="module")
def own_tmpdir(tmp_path_factory):
    """Workers started afresh under a directory of the module's own as their
    ``TMPDIR`` (and this process's), stopped after."""
    path = tmp_path_factory.mktemp("spill")
    shard.shutdown()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(path))
        mp.setattr(tempfile, "tempdir", None)
        yield path
        shard.shutdown()


def _left(path):
    return glob.glob(str(path / "repro_torch_shard_*"))


@pytest.mark.parametrize("failing", [0, 2])
def test_a_raising_worker_leaves_no_spill_file(own_tmpdir, failing):
    mesh = shard.mesh(3, CPU)
    res = mesh.resident(int, [(d,) for d in range(3)])
    try:
        with pytest.raises(ArithmeticError, match=f"worker {failing} failed"):
            res.call(_state_fail_or_big, failing)
        assert _left(own_tmpdir) == []
        with pytest.raises(ArithmeticError, match=f"worker {failing} failed"):
            res.call_each(_state_fail_or_big, [(failing,)] * 3)
        assert _left(own_tmpdir) == []
        # the workers still answer, and a large result still arrives whole
        got = res.call_each(_state_fail_or_big, [None, (0,), None])
        assert got[0] is None and got[2] is None and torch.equal(
            got[1], torch.full((BIG // 4,), 1.0))
    finally:
        res.close()
    calls = [mesh.submit(d, _fail_or_big, failing, d) for d in range(3)]
    with pytest.raises(ArithmeticError, match=f"worker {failing} failed"):
        shard.gather(calls)
    assert _left(own_tmpdir) == []
