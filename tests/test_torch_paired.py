"""The port's paired-end path against the JAX package on the CPU, exact
equality throughout (every output is an integer or a byte): the golden
PE SAM through the CLI, pe_map_batch field by field on a batch whose
mate-2 seeds are broken so that rescue runs, the SAM of every policy
flag set of tests/test_pe_policy.py, and the chunked window rescue on
ragged windows clipped at the genome end."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.fmindex import build_fm_index
from nvbio_tpu.models import paired as jax_paired
from nvbio_tpu.models.params import MapperParams as JaxParams
from nvbio_tpu.utils.simulate import random_genome, simulate_pairs
from nvbio_tpu_torch.io.index_file import index_from_numpy
from nvbio_tpu_torch.models import paired
from nvbio_tpu_torch.models.params import MapperParams

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mappers(g, sa_sample, **kw):
    """The JAX PairedMapper (XLA twin path, as --cpu) and the port's, on
    one index built by the JAX package."""
    fm, ssa = build_fm_index(g, sa_sample=sa_sample, bi_sample=True)
    jm = jax_paired.PairedMapper(fm, ssa, g, params=JaxParams(
        sa_sample=sa_sample, **kw), use_pallas=False)
    tfm, tssa, tg, _ = index_from_numpy(
        [np.asarray(x) for x in fm[:6]], [np.asarray(x) for x in ssa], g)
    tm = paired.PairedMapper(tfm, tssa, tg, params=MapperParams(
        sa_sample=sa_sample, **kw))
    return jm, tm


def test_golden_pe_sam_on_cpu(tmp_path):
    """map_reads -1/-2 --device cpu reproduces golden_pe.sam.gz (made as
    tests/test_golden.py:42 makes it), ignoring @PG."""
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    g = random_genome(150_000, seed=777)
    write_fasta(str(tmp_path / "g.fa"), [("golden_pe_ref", g)])
    sim = simulate_pairs(g, 120, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=778)
    for m in (1, 2):
        write_fastq(str(tmp_path / f"r{m}.fq"),
                    [(f"p{i}", sim[f"seqs{m}"][i].astype(np.uint8),
                      sim[f"quals{m}"][i]) for i in range(120)])
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")]) == 0
    assert mapr(["-x", str(tmp_path / "g.npz"), "-1",
                 str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq"),
                 "-S", str(tmp_path / "out.sam"), "--device", "cpu",
                 "--batch", "128"]) == 0
    got = [ln for ln in open(tmp_path / "out.sam")
           if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(DATA, "golden_pe.sam.gz"), "rt"))
    assert got == want


def test_pe_map_batch_matches_jax_with_rescue():
    """Every per-mate and pair-info field of pe_map_batch equals the JAX
    function's; every 12th base of half the mate-2 reads is flipped
    (tests/test_paired.py:179) so that rescue places them."""
    R, L = 64, 80
    g = random_genome(80_000, seed=17)
    kw = dict(batch_size=R, max_candidates=8, minins=0, maxins=400)
    jm, tm = _mappers(g, 16, **kw)
    sim = simulate_pairs(g, R, L, insert_mean=200, insert_sd=10,
                         error_rate=0.0, seed=8)
    s2 = sim["seqs2"].copy()
    for k in range(4, L, 12):
        s2[::2, k] = (s2[::2, k] + 1) % 4
    s1 = sim["seqs1"].copy()
    s1[5] = np.random.default_rng(1).integers(0, 4, L)  # an unplaceable mate
    lens = np.full(R, L, np.int32)
    lens[7] = 60  # a ragged pair
    p = tm._chunk_params(L, 60)
    args = (s1, lens, sim["quals1"], s2, lens, sim["quals2"])

    _, _, jargs = jm._stage_pair_batch(*args)
    want = jax_paired.pe_map_batch(
        jm.fm, jm.ssa, jm.genome, *jargs, params=jm._chunk_params(L, 60),
        use_pallas=False, lut=jm.lut, gwords=jm.gwords, fm2=jm.fm2,
        bi=jm.bi)
    _, tensors = tm._stage_pair_batch(*args)
    got = paired.pe_map_batch(tm.fm, tm.ssa, tm.gwords, tm.genome,
                              *tensors[0], *tensors[1], params=p, lut=tm.lut)
    for w, gt in zip(want, got):
        assert set(gt) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(w[k]),
                                          err_msg=k)
    rescued = int(np.asarray(want[0]["resc"] | want[1]["resc"]).sum())
    assert rescued > 0
    assert np.asarray(want[2]["proper"]).mean() > 0.8


def _rc(x):
    return np.where(x < 4, 3 - x, x)[::-1].astype(np.uint8)


def _policy_pairs(g):
    """The planted pairs of tests/test_pe_policy.py, one batch: FR, RF,
    FF (both fragment strands), FF with mate 2's seeds broken,
    dovetailing, containment, overlap, a garbage mate, a discordant
    pair."""
    L = 100

    def frag(s, insert):
        return g[s:s + L].copy(), g[s + insert - L:s + insert].copy()

    up, dn = frag(21_000, 300)
    pairs = [(up, _rc(dn))]
    up, dn = frag(22_000, 300)
    pairs.append((_rc(up), dn))
    up, dn = frag(23_000, 300)
    pairs += [(up, dn), (_rc(dn), _rc(up))]
    up, dn = frag(24_000, 300)
    dn[::7] = (dn[::7] + 1) % 4
    pairs.append((up, dn))
    pairs.append((g[25_000:25_100].copy(), _rc(g[24_960:25_060])))
    pairs.append((g[26_000:26_100].copy(), _rc(g[26_020:26_080])))
    pairs.append((g[27_000:27_100].copy(), _rc(g[27_050:27_150])))
    pairs.append((g[28_000:28_100].copy(), np.random.default_rng(9).integers(
        0, 4, L).astype(np.uint8)))
    pairs.append((g[30_000:30_100].copy(), _rc(g[34_901:35_001])))
    R = len(pairs)
    s = np.full((2, R, L), 7, np.uint8)
    lens = np.zeros((2, R), np.int32)
    for i, pair in enumerate(pairs):
        for m, x in enumerate(pair):
            s[m, i, :len(x)] = x
            lens[m, i] = len(x)
    q = np.where(np.arange(L) < lens[..., None], 35, 0).astype(np.uint8)
    return s, lens, q


POLICIES = [{}, {"pe_orient": "rf"}, {"pe_orient": "ff"},
            {"pe_orient": "ff", "score_min_a": -120.0},
            {"pe_dovetail": True}, {"pe_no_contain": True},
            {"pe_no_overlap": True}, {"no_mixed": True},
            {"no_discordant": True},
            {"no_discordant": True, "no_mixed": True}]


@pytest.fixture(scope="module")
def policy_index():
    rng = np.random.default_rng(505)
    return rng.integers(0, 4, 60_000, dtype=np.uint8).astype(np.uint8)


@pytest.mark.parametrize("over", POLICIES, ids=[
    "-".join(f"{k}={v}" for k, v in p.items()) or "default"
    for p in POLICIES])
def test_policy_flag_sets_give_the_jax_sam(policy_index, over):
    g = policy_index
    jm, tm = _mappers(g, 8, batch_size=16, **over)
    s, lens, q = _policy_pairs(g)
    names = [f"p{i}" for i in range(s.shape[1])]
    sams = []
    for m in (jm, tm):
        res1, res2, info = m.map_pairs(s[0], lens[0], q[0], s[1], lens[1],
                                       q[1])
        sams.append([r.to_line() for r in m.to_sam_records_pe(
            names, s[0], lens[0], q[0], s[1], lens[1], q[1], res1, res2,
            info)])
        sams[-1].append([(i["proper"], i["discordant"]) for i in info])
    assert sams[1] == sams[0]


def test_chunked_window_score_matches_jax():
    """_chunked_window_score over ragged windows, some clipped at the
    genome end, equals the JAX function on its XLA twin engine."""
    from nvbio_tpu.models.paired import _chunked_window_score as jax_cws

    rng = np.random.default_rng(21)
    R, L, W = 24, 64, 15
    params = MapperParams(maxins=200, band_w=W)
    LT = L + 2 * (params.maxins + 2 * W)
    plan = paired._chunk_plan(L, LT, params)
    assert plan == jax_paired._chunk_plan(L, LT, JaxParams(maxins=200,
                                                           band_w=W))
    texts = rng.integers(0, 4, (R, LT)).astype(np.int8)
    pats = np.full((R, L), 7, np.int8)
    lens = rng.integers(40, L + 1, R).astype(np.int32)
    for r in range(R):
        off = int(rng.integers(0, LT - L))
        pats[r, :lens[r]] = texts[r, off:off + lens[r]]
        pats[r, rng.integers(0, lens[r], 3)] = rng.integers(0, 4)
    # ragged window ends: some lanes clipped at the genome end (tlen
    # short of the window), one with an empty window
    tlens = np.full(R, LT, np.int32)
    tlens[::3] = rng.integers(L, LT, len(tlens[::3]))
    tlens[1] = 30
    tlens[2] = 0
    quals = rng.integers(2, 41, (R, L)).astype(np.uint8)
    jp = JaxParams(maxins=200, band_w=W)
    want = jax_cws(*(jnp.asarray(a) for a in (pats, lens, texts, tlens,
                                              quals)), jp, plan,
                   use_pallas=False)
    got = paired._chunked_window_score(
        *(torch.from_numpy(a) for a in (pats, lens, texts, tlens, quals)),
        params, plan)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert (np.asarray(want["score"]) > -(1 << 29)).sum() > R // 2
