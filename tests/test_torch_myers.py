"""K6 in the port (``ops/myers.py`` on CPU tensors, i.e. its plain
version ``alignment/myers.py``) against the JAX package's Myers twin
(``myers_edit_distance_batch``) and its Pallas kernel (``myers_pallas``
in interpret mode, ``tile=128``), at tests/test_myers.py's sizes, and
against the scalar Levenshtein oracle.  Tolerance: exact (integers).
The CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment.myers import (
    myers_edit_distance_batch as jax_myers)
from nvbio_tpu.alignment.types import AlignmentType as JAType
from nvbio_tpu.ops.myers_pallas import myers_pallas
from nvbio_tpu_torch.alignment.myers import (edit_distance_oracle,
                                             myers_edit_distance_batch)
from nvbio_tpu_torch.alignment.types import AlignmentType
from nvbio_tpu_torch.ops import myers as k6

MODES = [AlignmentType.SEMI_GLOBAL, AlignmentType.GLOBAL]
IDS = ["semi_global", "global"]


def _both(arrays, atype, pallas=True):
    """(port, JAX twin, JAX Pallas) results as numpy pairs."""
    jp = [jnp.asarray(a) for a in arrays]
    ja = JAType[atype.name]
    got = k6.myers(*[torch.from_numpy(a) for a in arrays], atype=atype)
    want = [jax_myers(*jp, atype=ja)]
    if pallas:
        want.append(myers_pallas(*jp, atype=ja, interpret=True, tile=128))
    return [g.numpy() for g in got], [[np.asarray(x) for x in w]
                                      for w in want]


@pytest.mark.parametrize("LP,LT", [(20, 40), (32, 50), (33, 60), (128, 150)])
@pytest.mark.parametrize("atype", MODES, ids=IDS)
def test_myers_plain_matches_jax_and_oracle(LP, LT, atype):
    """tests/test_myers.py's oracle case: planted near-matches, ragged
    lengths, one to four words."""
    rng = np.random.default_rng(LP * 1000 + LT)
    N = 24
    plens = rng.integers(1, LP + 1, N).astype(np.int32)
    tlens = rng.integers(1, LT + 1, N).astype(np.int32)
    pats = rng.integers(0, 4, (N, LP)).astype(np.int32)
    texts = rng.integers(0, 4, (N, LT)).astype(np.int32)
    for i in range(0, N, 2):
        pl = plens[i]
        tl = max(tlens[i], pl)
        tlens[i] = tl
        s = rng.integers(0, tl - pl + 1)
        texts[i, s:s + pl] = pats[i, :pl]
    got, wants = _both((pats, plens, texts, tlens), atype)
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for i in range(N):
        assert got[0][i] == edit_distance_oracle(
            pats[i, :plens[i]], texts[i, :tlens[i]], atype)


def test_myers_plain_matches_pallas_interpret():
    """tests/test_myers.py's Pallas case: ragged lengths, word-boundary
    lengths, N symbols."""
    rng = np.random.default_rng(5)
    NB, LP, LT = 48, 100, 140
    plens = rng.integers(1, LP + 1, NB).astype(np.int32)
    plens[:3] = (LP, 32, 64)
    pats = rng.integers(0, 5, (NB, LP)).astype(np.int32)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int32)
    for b in range(NB):
        L = plens[b]
        t = pats[b, :L].copy()
        for _ in range(5):
            t[rng.integers(0, L)] = rng.integers(0, 4)
        texts[b, :min(L, LT)] = t[:LT]
    tlens = rng.integers(10, LT + 1, NB).astype(np.int32)
    for atype in MODES:
        got, wants = _both((pats, plens, texts, tlens), atype)
        for want in wants:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_myers_plain_matches_jax_long_patterns():
    """tests/test_myers.py's multi-word case: 1 kb patterns, 32 words
    (the kernel's scratch path), against the twin."""
    rng = np.random.default_rng(9)
    NB, LP = 4, 1000
    LT = LP + 60
    plens = np.array([LP, 257, 512, 769], np.int32)
    pats = rng.integers(0, 4, (NB, LP)).astype(np.int32)
    texts = rng.integers(0, 4, (NB, LT)).astype(np.int32)
    for b in range(NB):
        L = plens[b]
        t = pats[b, :L].copy()
        for _ in range(30):
            t[rng.integers(0, L)] = rng.integers(0, 4)
        texts[b, 13:13 + L] = t
    tlens = np.full(NB, LT, np.int32)
    for atype in MODES:
        got, (want,) = _both((pats, plens, texts, tlens), atype,
                             pallas=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_myers_guards_like_jax():
    """LOCAL and patterns beyond the JAX kernel's VMEM guard raise;
    the plain version is the wrapper's CPU path."""
    z = torch.zeros((1, 4), dtype=torch.int32)
    n = torch.full((1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="GLOBAL/SEMI_GLOBAL"):
        k6.myers(z, n, z, n, atype=AlignmentType.LOCAL)
    with pytest.raises(ValueError, match="GLOBAL/SEMI_GLOBAL"):
        myers_edit_distance_batch(z, n, z, n, atype=AlignmentType.LOCAL)
    k6.check_myers(32_000, AlignmentType.SEMI_GLOBAL)
    with pytest.raises(ValueError, match="working set"):
        k6.check_myers(160_000, AlignmentType.SEMI_GLOBAL)
    with pytest.raises(ValueError):
        myers_pallas(jnp.zeros((1, 160_000), jnp.int32), jnp.ones(1, jnp.int32),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones(1, jnp.int32),
                     interpret=True)
