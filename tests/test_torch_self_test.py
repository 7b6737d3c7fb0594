"""The port's self_test (``nvbio_tpu_torch/tools/self_test.py``) against
the reference's: ``--quick --device cpu`` prints the reference's
``--quick --cpu`` check names in the same order, with the same verdicts,
and exits 0; and the port's ``align_oracle`` copy gives the reference's
scores, end cells, starts and CIGARs on seeded cases."""

import re

import numpy as np
import pytest
import torch

from nvbio_tpu.alignment import oracle as ref_oracle
from nvbio_tpu_torch.alignment import oracle as port_oracle


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests (the plain DP's
    small per-row ops slow down when the workers' pools fight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checks(err):
    """(name, verdict) of every check line of a self_test run's stderr."""
    return [(m.group(1).strip(), m.group(2)) for m in re.finditer(
        r"^\[self_test\] (.{34}) (ok|FAIL)  ", err, re.M)]


def test_self_test_quick_matches_reference(capsys):
    from nvbio_tpu.tools import self_test as ref
    from nvbio_tpu_torch.tools import self_test as port

    assert port.main(["--quick", "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert ref.main(["--quick", "--cpu"]) == 0
    want = capsys.readouterr()
    assert _checks(got.err) == _checks(want.err)
    assert [v for _, v in _checks(got.err)] == ["ok"] * 5
    assert got.out == want.out == "self_test: all checks passed\n"


TYPES = ["GLOBAL", "SEMI_GLOBAL", "LOCAL"]


@pytest.mark.parametrize("atype", TYPES)
def test_align_oracle_copy_matches_reference(atype):
    from nvbio_tpu.alignment.types import AlignmentType as RefType
    from nvbio_tpu.alignment.types import GotohScheme as RefScheme
    from nvbio_tpu_torch.alignment.types import AlignmentType, GotohScheme

    rng = np.random.default_rng(TYPES.index(atype))
    for case in range(6):
        lp = int(rng.integers(10, 60))
        pat = rng.integers(0, 4, lp).astype(np.int8)
        text = rng.integers(0, 4, lp + 20).astype(np.int8)
        text[5:5 + lp] = pat
        text[rng.integers(5, 5 + lp)] = 4  # an N
        quals = rng.integers(5, 41, lp).astype(np.int32)
        band = None if case % 2 else 12
        kw = dict(match=2 if atype == "LOCAL" else 0)
        got = port_oracle.align_oracle(
            pat, text, GotohScheme(**kw), AlignmentType[atype], band=band,
            quals=quals)
        want = ref_oracle.align_oracle(
            pat, text, RefScheme(**kw), RefType[atype], band=band,
            quals=quals)
        assert (got.score, got.p_end, got.t_end, got.p_start, got.t_start,
                got.cigar) == (want.score, want.p_end, want.t_end,
                               want.p_start, want.t_start, want.cigar)
