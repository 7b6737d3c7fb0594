"""The port's Python CIGAR/MD fallback (``Mapper._finish_python``, over the
``alignment/cigar.py`` copy), taken where the native builder cannot be
built, as the reference's ``Mapper._finish`` does without g++: with the
port's ``ops_batch_native`` patched to return None, SE and PE MapResults
equal the native path's field for field (GLOBAL's leading-D branch too),
and the CLI's SAM equals the reference's ``map_reads --cpu`` SAM (the
golden fixtures, which ``tests/test_golden.py`` holds the reference to)."""

import dataclasses
import gzip
import os
import re

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.alignment.types import AlignmentType
from nvbio_tpu_torch.fmindex.build import build_fm_arrays
from nvbio_tpu_torch.io.index_file import index_from_numpy
from nvbio_tpu_torch.models import mapper as M
from nvbio_tpu_torch.models.paired import PairedMapper
from nvbio_tpu_torch.models.params import MapperParams
from nvbio_tpu_torch.utils.simulate import (random_genome, simulate_pairs,
                                            simulate_reads)

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


@pytest.fixture(scope="module")
def index():
    g = random_genome(60_000, seed=41)
    fm, ssa = build_fm_arrays(g, sa_sample=8)
    return g, index_from_numpy(fm, (*ssa, 8), g)


def no_native(monkeypatch):
    monkeypatch.setattr(M, "ops_batch_native", lambda *a, **k: None)


def _fields(results):
    return [dataclasses.asdict(r) for r in results]


def test_se_fallback_equals_native(index, monkeypatch):
    g, (fm, ssa, gi, _) = index
    sim = simulate_reads(g, 100, 100, seed=42, error_rate=0.02,
                         indel_rate=0.01)
    args = (sim["seqs"].astype(np.uint8), np.full(100, 100, np.int32),
            sim["quals"])
    m = M.Mapper(fm, ssa, gi, params=MapperParams(batch_size=128,
                                                  sa_sample=8))
    want = m.map_reads(*args)
    no_native(monkeypatch)
    got = m.map_reads(*args)
    assert _fields(got) == _fields(want)
    assert sum(r.aligned for r in got) >= 85
    assert any("D" in r.cigar or "I" in r.cigar for r in got)


def test_pe_fallback_equals_native(index, monkeypatch):
    g, (fm, ssa, gi, _) = index
    sim = simulate_pairs(g, 48, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=43)
    lens = np.full(48, 100, np.int32)
    args = (sim["seqs1"].astype(np.uint8), lens, sim["quals1"],
            sim["seqs2"].astype(np.uint8), lens, sim["quals2"])
    m = PairedMapper(fm, ssa, gi, params=MapperParams(batch_size=64,
                                                      sa_sample=8))
    want = m.map_pairs(*args)
    no_native(monkeypatch)
    got = m.map_pairs(*args)
    assert _fields(got[0]) == _fields(want[0])
    assert _fields(got[1]) == _fields(want[1])
    assert got[2] == want[2]
    assert sum(i["proper"] for i in got[2]) >= 44


@dataclasses.dataclass(frozen=True)
class _GlobalParams(MapperParams):
    """Params whose finish takes GLOBAL's branch (no mapper path runs
    GLOBAL: the CLI's types are SEMI_GLOBAL and LOCAL)."""

    @property
    def atype(self):
        return AlignmentType.GLOBAL


def test_global_leading_deletions_equal_native(index, monkeypatch):
    """GLOBAL's finish prepends the window's leading D run (t_start > 0
    for every read placed inside its window): on one SE batch's walks,
    the fallback's MapResults equal the native builder's."""
    g, (fm, ssa, gi, _) = index
    sim = simulate_reads(g, 64, 100, seed=44, error_rate=0.02,
                         indel_rate=0.01)
    p = MapperParams(batch_size=64, sa_sample=8)
    m = M.Mapper(fm, ssa, gi, params=p)
    seqs, lens, quals, fwd, res, walk, R = m._dispatch_chunk(
        sim["seqs"].astype(np.uint8), np.full(64, 100, np.int32),
        sim["quals"])
    m.params = _GlobalParams(**{f.name: getattr(p, f.name)
                                for f in dataclasses.fields(p)})
    want = m._finish(seqs, lens, quals, fwd, res, walk)
    no_native(monkeypatch)
    got = m._finish(seqs, lens, quals, fwd, res, walk)
    assert _fields(got) == _fields(want)
    n_lead = sum(bool(re.match(r"\d+D", r.cigar)) for r in got)
    assert n_lead >= 10


def _golden_se(tmp_path):
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq

    g = random_genome(200_000, seed=12345)
    write_fasta(str(tmp_path / "g.fa"), [("golden_ref", g)])
    sim = simulate_reads(g, 300, 100, seed=54321, error_rate=0.02,
                         indel_rate=0.005)
    write_fastq(str(tmp_path / "r.fq"), [
        (f"gr{i}", sim["seqs"][i].astype(np.uint8), sim["quals"][i])
        for i in range(300)])
    return ["-U", str(tmp_path / "r.fq")], "golden_se.sam.gz"


def _golden_pe(tmp_path):
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq

    g = random_genome(150_000, seed=777)
    write_fasta(str(tmp_path / "g.fa"), [("golden_pe_ref", g)])
    sim = simulate_pairs(g, 120, 100, insert_mean=280, insert_sd=25,
                         error_rate=0.02, seed=778)
    for m in (1, 2):
        write_fastq(str(tmp_path / f"r{m}.fq"),
                    [(f"p{i}", sim[f"seqs{m}"][i].astype(np.uint8),
                      sim[f"quals{m}"][i]) for i in range(120)])
    return (["-1", str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq")],
            "golden_pe.sam.gz")


@pytest.mark.parametrize("make", [_golden_se, _golden_pe], ids=["se", "pe"])
def test_fallback_sam_equals_reference(tmp_path, monkeypatch, make):
    """map_reads --device cpu without the native builder writes the
    reference's map_reads --cpu SAM, @PG masked."""
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    reads, fixture = make(tmp_path)
    assert build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz")]) == 0
    no_native(monkeypatch)
    assert mapr(["-x", str(tmp_path / "g.npz"), *reads, "-S",
                 str(tmp_path / "out.sam"), "--device", "cpu", "--batch",
                 "128"]) == 0
    got = [ln for ln in open(tmp_path / "out.sam")
           if not ln.startswith("@PG")]
    want = list(gzip.open(os.path.join(DATA, fixture), "rt"))
    assert got == want
