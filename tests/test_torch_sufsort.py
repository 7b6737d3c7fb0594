"""The port's suffix sorts, set-BWT and device occ tables against the JAX
package on the CPU, bit for bit: ``suffix_array_device`` (random texts
and a tandem + homopolymer text), ``suffix_array_bucketed`` (the
reference tests' adversarial cases at chunk_cap 4096, and a 1 Mbp
repeat-structured genome through the compacted doubling against SA-IS),
one refinement and one doubling round on padded inputs (pads at
INT32_MAX, seconds of -1 and INT32_MAX), ``set_bwt_device`` (random
sets, reads of length 1, duplicate reads) against the JAX function and
the oracle, and ``occ_tables_device`` across chunk boundaries against
the JAX function and the host tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import build as jax_build
from nvbio_tpu.sufsort import bucketed as jax_bucketed
from nvbio_tpu.sufsort import device as jax_device
from nvbio_tpu.utils.simulate import repeat_structured_genome
from nvbio_tpu_torch.fmindex import build
from nvbio_tpu_torch.sufsort import bucketed, device
from nvbio_tpu_torch.sufsort.sa import suffix_array

INT_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_text(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, int(rng.integers(2, 6000))).astype(np.uint8)


def _tandem_text():
    """~50 kb: a 7-mer tandem array, a homopolymer run, random sequence
    and the reversed unit's array (ranks stay tied for many rounds)."""
    rng = np.random.default_rng(44)
    unit = rng.integers(0, 4, 7).astype(np.uint8)
    return np.concatenate([np.tile(unit, 4000), np.zeros(5000, np.uint8),
                           rng.integers(0, 4, 10_000).astype(np.uint8),
                           np.tile(unit[::-1], 1000)])


@pytest.mark.parametrize("case", [*range(8), "tandem"])
def test_suffix_array_device_matches_jax(case):
    t = _tandem_text() if case == "tandem" else _random_text(100 + case)
    got = device.suffix_array_device(t, device="cpu")
    want = jax_device.suffix_array_device(t)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def _adversarial(i):
    """tests/test_sufsort.py's bucketed cases: random, homopolymer,
    tandems of period 7 and 100, homopolymers around random sequence,
    binary alphabet, and a text below 4096 (the host doubling)."""
    rng = np.random.default_rng(11)
    unit7 = rng.integers(0, 4, 7).astype(np.uint8)
    unit100 = rng.integers(0, 4, 100).astype(np.uint8)
    cases = [
        rng.integers(0, 4, 5000).astype(np.uint8),
        np.zeros(6000, np.uint8),
        np.tile(unit7, 1200),
        np.tile(unit100, 90),
        np.concatenate([np.zeros(5000, np.uint8),
                        rng.integers(0, 4, 5000).astype(np.uint8),
                        np.zeros(5000, np.uint8)]),
        rng.integers(0, 2, 9000).astype(np.uint8),
        rng.integers(0, 4, 100).astype(np.uint8),
    ]
    return cases[i]


@pytest.mark.parametrize("i", range(7), ids=[
    "random", "homopolymer", "tandem7", "tandem100", "homo-random-homo",
    "binary", "short"])
def test_suffix_array_bucketed_adversarial_matches_jax(i):
    t = _adversarial(i)
    got = bucketed.suffix_array_bucketed(t, chunk_cap=4096, device="cpu")
    np.testing.assert_array_equal(
        got, jax_bucketed.suffix_array_bucketed(t, chunk_cap=4096))
    np.testing.assert_array_equal(got, suffix_array(t))


def test_suffix_array_bucketed_repeat_structured(capsys):
    """Repeat classes (ALUs, segdups, tandems) drive every phase:
    oversized buckets, the 64-symbol refinement ceiling, and doubling
    rounds (their log lines must appear)."""
    t = repeat_structured_genome(1_000_000, seed=7)[0]
    got = bucketed.suffix_array_bucketed(t, chunk_cap=1 << 18, verbose=True,
                                         device="cpu")
    np.testing.assert_array_equal(got, suffix_array(t))
    out = capsys.readouterr().out
    assert out.count("[sufsort] chunk") >= 4
    assert "[sufsort] doubling k=64" in out


def test_bucketed_host_helpers_match():
    t = _random_text(7)
    for pad in (0, 20):
        np.testing.assert_array_equal(bucketed._pack_nibbles(t, pad),
                                      jax_bucketed._pack_nibbles(t, pad))
    np.testing.assert_array_equal(bucketed._host_bucket_keys(t),
                                  jax_bucketed._host_bucket_keys(t))


def _round_inputs(seed, m=4096, live=3000, n=20_000):
    """Padded chunk operands as the reference builds them: ``live``
    suffixes in groups of a few ranks (many ties), pads at INT32_MAX
    with positions n + 8."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n).astype(np.uint8)
    text[5000:9000] = np.tile(text[:8], 500)  # long ties in the window
    rank = np.full(m, INT_MAX, np.int32)
    pos = np.full(m, n + 8, np.int32)
    rank[:live] = np.sort(rng.choice(np.arange(0, n, 50), live))
    pos[:live] = rng.permutation(n)[:live]
    pos[:200] = np.arange(5000, 5200)  # same ranks below, tied windows
    rank[:200] = 0
    return text, rank, pos


@pytest.mark.parametrize("off_words", [1, 3, 7])
def test_refine_round_matches_jax(off_words):
    text, rank, pos = _round_inputs(off_words)
    packed = bucketed._pack_nibbles(text, (64 + 80) // 8 + 2)
    jr, jp, jt = jax_bucketed._refine_round(
        jnp.asarray(packed), jnp.asarray(rank), jnp.asarray(pos), off_words)
    tr, tp, tt = bucketed._refine_round(
        torch.from_numpy(packed.view(np.int32)),
        torch.from_numpy(rank).long(), torch.from_numpy(pos).long(),
        off_words)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tt) == int(jt) > 0


def test_double_round_matches_jax():
    _, rank, pos = _round_inputs(5)
    rng = np.random.default_rng(6)
    second = rng.integers(-1, 40, rank.shape[0]).astype(np.int32)
    second[rank == INT_MAX] = INT_MAX
    second[:50] = -1  # past the end
    jr, jp, jt = jax_bucketed._double_round(
        jnp.asarray(rank), jnp.asarray(second), jnp.asarray(pos))
    tr, tp, tt = bucketed._double_round(
        torch.from_numpy(rank).long(), torch.from_numpy(second).long(),
        torch.from_numpy(pos).long())
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert np.asarray(jt).any()


def _read_set(case):
    rng = np.random.default_rng(40 + (case if isinstance(case, int) else 9))
    if case == "len1":
        reads = rng.integers(0, 4, (30, 6)).astype(np.uint8)
        lens = np.ones(30, np.int32)
        lens[::3] = rng.integers(1, 7, 10)
        return reads, lens
    if case == "duplicates":  # sentinel order follows read id
        return (np.tile(np.array([[0, 1, 2, 3]], np.uint8), (5, 1)),
                np.full(5, 4, np.int32))
    R = int(rng.integers(1, 50))
    L = int(rng.integers(4, 40))
    return (rng.integers(0, 4, (R, L)).astype(np.uint8),
            rng.integers(1, L + 1, R).astype(np.int32))


@pytest.mark.parametrize("case", [*range(6), "len1", "duplicates"])
def test_set_bwt_device_matches_jax_and_oracle(case):
    reads, lens = _read_set(case)
    got = device.set_bwt_device(reads, lens, device="cpu")
    assert got.dtype == np.uint8 and len(got) == lens.sum() + len(lens)
    np.testing.assert_array_equal(got, jax_device.set_bwt_device(reads,
                                                                 lens))
    np.testing.assert_array_equal(got, device.set_bwt_oracle(reads, lens))
    np.testing.assert_array_equal(got, jax_device.set_bwt_oracle(reads,
                                                                 lens))


def test_occ_tables_device_matches_jax_and_host(monkeypatch):
    """~1 Mbp with 4 096-block chunks in both packages: the running
    carry crosses ~2 chunk boundaries."""
    monkeypatch.setattr(build, "OCC_CHUNK_BLOCKS", 1 << 12)
    monkeypatch.setattr(jax_build, "OCC_CHUNK_BLOCKS", 1 << 12)
    g = np.random.default_rng(71).integers(0, 4, 1_000_000).astype(np.uint8)
    bwt, _ = build.bwt_from_sa(g, suffix_array(g))
    m = len(g) + 1
    n_blocks = (m + build.BLOCK - 1) // build.BLOCK + 1
    bwt_pad = np.zeros(n_blocks * build.BLOCK, np.uint8)
    bwt_pad[:m] = bwt
    words = build.pack_2bit(bwt_pad).reshape(n_blocks, build.WORDS)
    got = build.occ_tables_device(words, device="cpu")
    want = jax_build.occ_tables_device(words)
    host = build._occ_tables_host(bwt_pad, n_blocks)
    for g_, w_, h_ in zip(got, want, host):
        assert g_.dtype == w_.dtype == h_.dtype
        np.testing.assert_array_equal(g_, w_)
        np.testing.assert_array_equal(g_, h_)


@pytest.mark.parametrize("bi", [True, False], ids=["bi", "mono"])
def test_build_fm_arrays_device_occ_matches_jax(bi):
    g = np.random.default_rng(72).integers(0, 4, 50_000).astype(np.uint8)
    got = build.build_fm_arrays(g, sa_sample=4, bi_sample=bi,
                                occ_device=True, device="cpu")
    want = jax_build.build_fm_arrays(g, sa_sample=4, bi_sample=bi,
                                     occ_device=True)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
