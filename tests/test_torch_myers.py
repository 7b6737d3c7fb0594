"""K6 in the port (``ops/myers.py`` on CPU tensors, i.e. its plain
version ``alignment/myers.py``) against the JAX package's Myers twin
(``myers_edit_distance_batch``) and its Pallas kernel (``myers_pallas``
in interpret mode, ``tile=128``), at tests/test_myers.py's sizes and at
the warp tier's edges, and against the scalar Levenshtein oracle (a
column-vectorised one past the twin's compile reach); the warp tier's
ballot carry lookahead as a numpy model against both packages' adds with
carry and Python ints; the tier plan.  Tolerance: exact (integers).
The CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alignment import myers as jax_myers_mod
from nvbio_tpu.alignment.myers import (
    myers_edit_distance_batch as jax_myers)
from nvbio_tpu.alignment.types import AlignmentType as JAType
from nvbio_tpu.ops.myers_pallas import myers_pallas
from nvbio_tpu_torch.alignment import myers as plain_myers
from nvbio_tpu_torch.alignment.myers import (edit_distance_oracle,
                                             myers_edit_distance_batch)
from nvbio_tpu_torch.alignment.types import AlignmentType
from nvbio_tpu_torch.ops import myers as k6

M32 = 0xFFFFFFFF

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
    (the kernel's warp tier, one warp an alignment), against the twin."""
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


def _edge_inputs(lp, plens, lt=600, seed=0):
    """4 lanes at Lp: plens on the warp tier's word, lane and strip edges,
    random texts of Lt columns with the pattern's head planted at 40
    (3 % substitutions, N symbols), ragged tlens, and on lanes 0 and 2 a
    poly-A run from symbol 20 the text never matches."""
    rng = np.random.default_rng(seed + lp)
    nb = len(plens)
    pats = rng.integers(0, 5, (nb, lp)).astype(np.int32)
    texts = rng.integers(0, 4, (nb, lt)).astype(np.int32)
    n = min(lp, lt - 40)
    head = pats[:, :n].copy()
    mut = rng.random(head.shape) < 0.03
    head[mut] = rng.integers(0, 5, int(mut.sum()))
    texts[:, 40:40 + n] = np.where(head < 4, head, 1)
    for b in (0, 2):
        pats[b, 20:min(lp, 20 + 3 * 64 + 5)] = 0
        texts[b] = np.where(texts[b] == 0, 3, texts[b])
    tlens = np.array([lt, lt - 1, lt // 2, 33], np.int32)[:nb]
    return pats, np.asarray(plens, np.int32), texts, tlens


# Lp with 4 plens each: the thread tier's last word + 1 (W 9, one warp an
# alignment), one warp at 2 words a lane (W 33), and 2 strips of 2 words a
# lane (W 65; a strip is 64 words, 2 048 symbols): full, on and either
# side of word (32), lane (64) and strip (2 048) edges
EDGE_CASES = [(257, (257, 256, 33, 32)), (1025, (1025, 1024, 65, 64)),
              (2049, (2049, 2048, 2047, 65))]


@pytest.mark.parametrize("lp,plens", EDGE_CASES, ids=[str(c[0]) for c in
                                                      EDGE_CASES])
def test_myers_plain_matches_jax_at_warp_tier_edges(lp, plens):
    """The plain version (the wrapper's CPU path) against the JAX twin on
    4 lanes at the warp tier's edges, both modes (Lt 600: the carry still
    crosses every word)."""
    arrays = _edge_inputs(lp, plens)
    for atype in MODES:
        got, (want,) = _both(arrays, atype, pallas=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _levenshtein_columns(pat, text, atype):
    """(distance, t_end) as myers_edit_distance_batch gives them for one
    lane with plen >= 1: the edit-distance DP a text column at a time,
    the column's vertical chain as a running minimum (numpy)."""
    m = len(pat)
    ar = np.arange(m + 1)
    d = ar.copy()  # column 0
    last = []  # row m at columns 1..n
    for j, c in enumerate(text, start=1):
        x = np.empty(m + 1, np.int64)
        x[0] = j if atype == AlignmentType.GLOBAL else 0
        sub = ((pat == c) & (pat < 4)).astype(np.int64) ^ 1
        x[1:] = np.minimum(d[:-1] + sub, d[1:] + 1)
        d = np.minimum.accumulate(x - ar) + ar
        last.append(int(d[m]))
    if atype == AlignmentType.GLOBAL:
        return (last[-1] if last else m), len(text)
    if not last:
        return m, 0
    j = int(np.argmin(last))
    return min(last[j], m), j + 1


def test_myers_plain_matches_oracle_at_strips_of_the_long_tier():
    """Lp 8 193 (W 257: 5 strips of 2 words a lane), past the JAX twin's
    compile reach (~55 s a mode at 257 unrolled words): the plain version
    against a column-vectorised Levenshtein DP on 4 lanes with plens on
    strip and lane edges, both modes."""
    lp = 8193
    pats, plens, texts, tlens = _edge_inputs(lp, (8193, 4097, 2048, 65))
    for atype in MODES:
        got = myers_edit_distance_batch(
            *[torch.from_numpy(a) for a in (pats, plens, texts, tlens)],
            atype=atype)
        for b in range(len(plens)):
            want = _levenshtein_columns(pats[b, :plens[b]],
                                        texts[b, :tlens[b]], atype)
            assert (int(got[0][b]), int(got[1][b])) == want, (atype, b)


def _ballot_add(a, b, k):
    """The warp tier's add with carry (csrc/myers.cu k6_warp_kernel) in
    numpy over one alignment's words a, b (uint64 values < 2^32): lanes
    of k words, strips of 32 lanes; each lane adds its words with
    carry-in 0 (g its carry out, p its sum all ones), the ballots G and P
    give T = (G | P) + G + c, lane l's carry-in is bit l of T ^ P, the
    strip's carry-out bit 32 of T."""
    w = len(a)
    span = 32 * k
    strips = -(-w // span)
    pad = strips * span - w
    a = np.concatenate([a, np.zeros(pad, np.uint64)]).reshape(strips, 32, k)
    b = np.concatenate([b, np.zeros(pad, np.uint64)]).reshape(strips, 32, k)
    out = np.zeros_like(a)
    c = 0
    for s in range(strips):
        g = np.zeros(32, np.uint64)
        for i in range(k):
            t = a[s, :, i] + b[s, :, i] + g
            out[s, :, i] = t & np.uint64(M32)
            g = t >> np.uint64(32)
        p = np.all(out[s] == M32, axis=1)
        assert not np.any(g.astype(bool) & p)  # never both
        G = sum(int(g[lane]) << lane for lane in range(32))
        P = sum(int(p[lane]) << lane for lane in range(32))
        T = (G | P) + G + c
        carry = np.array([((T ^ P) >> lane) & 1 for lane in range(32)],
                         np.uint64)
        for i in range(k):
            t = out[s, :, i] + carry
            out[s, :, i] = t & np.uint64(M32)
            carry = t >> np.uint64(32)
        c = T >> 32
    return out.reshape(-1)[:w]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ballot_carry_lookahead_matches_add_with_carry(k):
    """The numpy model of the warp tier's lookahead against Python ints
    and both packages' ``_add_with_carry`` (the port's lookahead, the
    JAX twin's ripple), over 3 strips of k words a lane (ragged W) with
    all-ones sums (b = ~a) planted across lane and strip edges, a carry
    generated below each run, and runs with no carry."""
    rng = np.random.default_rng(k)
    span = 32 * k
    w = 3 * span - 5
    rows = []
    for trial in range(6):
        a = rng.integers(0, 1 << 32, w, dtype=np.uint64)
        b = rng.integers(0, 1 << 32, w, dtype=np.uint64)
        for lo, hi in ((k - 1, 3 * k + 1), (span - 2 * k - 1, span + k + 1),
                       (2 * span - 1, 2 * span + 3 * k)):
            hi = min(hi + trial, w)
            b[lo:hi] = ~a[lo:hi] & np.uint64(M32)  # all ones, no carry
            if trial % 2 == 0 and lo > 0:
                a[lo - 1] = b[lo - 1] = np.uint64(M32)  # generate below
        rows.append((a, b))
    for a, b in rows:
        got = _ballot_add(a, b, k)
        want = (sum(int(x) << (32 * i) for i, x in enumerate(a))
                + sum(int(x) << (32 * i) for i, x in enumerate(b)))
        want = [(want >> (32 * i)) & M32 for i in range(w)]
        assert [int(x) for x in got] == want
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[1] for r in rows])
    port = plain_myers._add_with_carry(torch.from_numpy(a.astype(np.int64)),
                                       torch.from_numpy(b.astype(np.int64)))
    twin = jax_myers_mod._add_with_carry(jnp.asarray(a.astype(np.uint32)),
                                         jnp.asarray(b.astype(np.uint32)))
    model = np.stack([_ballot_add(x, y, k) for x, y in rows])
    np.testing.assert_array_equal(port.numpy(), model.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(twin), model.astype(np.uint32))


def test_myers_plan_covers_every_width():
    """myers_plan (the C entry k6_plan's mirror) at every W to the JAX
    guard's 4 520 words: the thread tier to 8 words, else the warp tier
    at the smallest K of 1, 2, 8 whose S = ceil(W / 32 K) fits its
    strips, with 32 K S >= W and S <= 32."""
    assert k6.myers_plan(32 * 4521 - 31)[0] == k6.WARP  # the plan reaches on
    for words in range(1, 4521):
        for lp in (32 * words - 31, 32 * words):
            tier, k, s = k6.myers_plan(lp)
            if words <= 8:
                assert (tier, k, s) == (k6.THREAD, 0, 0)
                continue
            assert tier == k6.WARP and k in (1, 2, 8), (lp, k)
            assert 32 * k * s >= words and s == -(-words // (32 * k))
            assert s <= min(32, k6.WARP_STRIPS[k]), (lp, k, s)
            assert all(-(-words // (32 * kk)) > k6.WARP_STRIPS[kk]
                       for kk in (1, 2, 8) if kk < k), (lp, k)
    with pytest.raises(ValueError, match="reach"):
        k6.myers_plan(32 * (32 * 8 * 18) + 1)
