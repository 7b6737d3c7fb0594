"""BWA index interop in the port (``nvbio_tpu_torch.io.bwa_files``,
``tools/bwa_export.py``, ``tools/bwa_import.py``) against the JAX
package's tools on the same index: the exported files byte for byte
(forward and ``--reverse``), the imported ``.npz`` arrays, and the
refusal of a corrupt ``.bwt`` with the reference's message.  The genome
is ``tests/test_bwa_interop.py``'s: two contigs with N runs."""

import shutil

import numpy as np
import pytest

from nvbio_tpu.io.fasta import write_fasta
from nvbio_tpu.utils.simulate import random_genome

EXTS = (".pac", ".bwt", ".sa", ".ann", ".amb", ".rpac", ".rbwt", ".rsa")


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One index (the port's build_index), exported by both packages'
    bwa_export --reverse, and by the port's CLI."""
    from nvbio_tpu.tools.bwa_export import export as ref_export
    from nvbio_tpu_torch.tools.bwa_export import main as port_export_cli
    from nvbio_tpu_torch.tools.build_index import main as build

    d = tmp_path_factory.mktemp("torch_bwa")
    c1 = random_genome(20_000, seed=31)
    c2 = random_genome(9_000, seed=32)
    c1[4000:4007] = 4  # N run
    c2[100:103] = 4
    write_fasta(d / "g.fa", [("chrA", c1), ("chrB", c2)])
    assert build([str(d / "g.fa"), str(d / "g.npz"), "--sa-sample", "8",
                  "--lut-k", "8"]) == 0
    ref_export(str(d / "g.npz"), str(d / "ref"), sa_intv=16, reverse=True)
    assert port_export_cli([str(d / "g.npz"), str(d / "port"), "--sa-intv",
                            "16", "--reverse"]) == 0
    return d


@pytest.mark.parametrize("ext", EXTS)
def test_export_files_byte_equal(exported, ext):
    d = exported
    assert (d / f"port{ext}").read_bytes() == (d / f"ref{ext}").read_bytes()


def test_bwt_from_index_same_either_way(exported):
    """The loaded index and the build's arrays give one BWA string."""
    from nvbio_tpu_torch.fmindex.build import build_fm_arrays
    from nvbio_tpu_torch.io.bwa_files import bwt_from_index, read_bwt
    from nvbio_tpu_torch.io.index_file import index_from_numpy, load_index

    fm, _, genome, _ = load_index(exported / "g.npz")
    syms = np.asarray(genome).astype(np.uint8) & 3
    fields = build_fm_arrays(syms, sa_sample=8)
    built = index_from_numpy(*fields, syms)[0]
    want, primary, _ = read_bwt(exported / "ref.bwt")
    for idx in (fm, built):
        np.testing.assert_array_equal(bwt_from_index(idx), want)
        assert idx.primary == primary


@pytest.mark.parametrize("bi_sample", [True, False], ids=["bi", "mono"])
def test_import_arrays_equal_reference(exported, tmp_path, bi_sample):
    from nvbio_tpu.tools.bwa_import import import_index as ref_import
    from nvbio_tpu_torch.tools.bwa_import import import_index

    d = exported
    want = ref_import(str(d / "ref"), str(tmp_path / "ref.npz"),
                      sa_sample=8, lut_k=8, bi_sample=bi_sample)
    got = import_index(str(d / "port"), str(tmp_path / "port.npz"),
                       sa_sample=8, lut_k=8, bi_sample=bi_sample)
    assert got == want == {"bwt_checked": True}
    with np.load(tmp_path / "ref.npz") as zr, \
            np.load(tmp_path / "port.npz") as zp:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            if k == "meta":
                continue
            assert zp[k].dtype == zr[k].dtype, k
            np.testing.assert_array_equal(zp[k], zr[k], err_msg=k)
    import json
    meta = {k: json.loads(bytes(np.load(tmp_path / f"{k}.npz")["meta"])
                          .decode()) for k in ("ref", "port")}
    assert meta["port"] == meta["ref"]


def test_import_cli_round_trip_equals_direct_build(exported, tmp_path):
    """build_index -> bwa_export -> bwa_import gives the direct build's
    arrays (the import rebuilds at the same sampling, both bi-sampled
    by default)."""
    from nvbio_tpu_torch.tools.bwa_import import main as port_import_cli

    d = exported
    assert port_import_cli([str(d / "port"), str(tmp_path / "rt.npz"),
                            "--sa-sample", "8", "--lut-k", "8"]) == 0
    with np.load(d / "g.npz") as za, np.load(tmp_path / "rt.npz") as zb:
        for k in za.files:
            if k != "meta":
                np.testing.assert_array_equal(zb[k], za[k], err_msg=k)


def _corrupt(d, tmp_path, what):
    for ext in (".pac", ".bwt", ".sa", ".ann", ".amb"):
        shutil.copy(str(d / ("ref" + ext)), str(tmp_path / ("x" + ext)))
    raw = bytearray(open(tmp_path / "x.bwt", "rb").read())
    if what == "row":
        raw[48] ^= 0xFF  # flip bases inside the packed BWT
    else:
        raw[0] ^= 0x01  # the primary's low byte
    open(tmp_path / "x.bwt", "wb").write(bytes(raw))
    return str(tmp_path / "x")


@pytest.mark.parametrize("what", ["row", "primary"])
def test_corrupt_bwt_refused_with_reference_message(exported, tmp_path,
                                                    what):
    from nvbio_tpu.tools.bwa_import import import_index as ref_import
    from nvbio_tpu_torch.tools.bwa_import import import_index

    prefix = _corrupt(exported, tmp_path, what)
    with pytest.raises(ValueError) as want:
        ref_import(prefix, str(tmp_path / "r.npz"))
    with pytest.raises(ValueError) as got:
        import_index(prefix, str(tmp_path / "p.npz"))
    assert str(got.value) == str(want.value)
    assert ("differs from rebuilt BWT at row" if what == "row"
            else "primary") in str(got.value)
