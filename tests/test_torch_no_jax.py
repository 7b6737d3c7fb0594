"""The port must run where JAX is not installed (the GPU machine has
none) and keeps its own copies of the host code it needs: in a
subprocess whose import system refuses ``jax`` and every ``nvbio_tpu``
module, import every ``nvbio_tpu_torch`` module, build an index and map
a tiny single-end dataset (with --un, --al, --rg-id, --stats and --html)
and a tiny paired-end dataset on the CPU, the single-end reads through
mem_map and qmap, build the index again with the device suffix sort and
occ tables (--device cpu), and the reads' set-BWT; export that index
to BWA files and import them back, score proteins with protein_sw,
correct the reads with correct_reads, map the sharded index over the
shard-per-device mesh (--mesh on) and serve the index with fm_server
(one torch thread, as the other port tests).  Also: the CLIs' device errors, and no flag of the
reference's map_reads refused as unported."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED = textwrap.dedent("""
    import importlib, pkgutil, sys

    class BlockJaxAndReference:
        def find_spec(self, name, path=None, target=None):
            if (name in ("jax", "nvbio_tpu")
                    or name.startswith(("jax.", "jaxlib", "nvbio_tpu."))):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, BlockJaxAndReference())
    import torch
    torch.set_num_threads(1)  # beside the test workers, as the port tests
    import nvbio_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        nvbio_tpu_torch.__path__, "nvbio_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    print("imported", len(mods))

    import numpy as np
    from nvbio_tpu_torch.io.fasta import write_fasta
    from nvbio_tpu_torch.io.fastq import write_fastq
    from nvbio_tpu_torch.utils.simulate import random_genome, simulate_reads
    from nvbio_tpu_torch.tools.build_index import main as build
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    out = sys.argv[1]
    g = random_genome(30_000, seed=1)
    write_fasta(f"{out}/g.fa", [("c1", g[:12_000]), ("c2", g[12_000:])])
    sim = simulate_reads(g, 40, 80, seed=2)
    write_fastq(f"{out}/r.fq", [(f"r{i}", sim["seqs"][i].astype(np.uint8),
                                 sim["quals"][i]) for i in range(40)])
    assert build([f"{out}/g.fa", f"{out}/g.npz", "--lut-k", "8"]) == 0
    assert mapr(["-x", f"{out}/g.npz", "-U", f"{out}/r.fq", "-S",
                 f"{out}/o.sam", "--device", "cpu", "--batch", "32",
                 "--un", f"{out}/un.fq.gz", "--al", f"{out}/al.fq",
                 "--rg-id", "g", "--stats", f"{out}/s.json", "--html",
                 f"{out}/r.html"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    recs = [l for l in open(f"{out}/o.sam") if not l.startswith("@")]
    print("records", len(recs),
          "aligned", sum(l.split("\\t")[1] != "4" for l in recs))
    import json
    assert json.load(open(f"{out}/s.json"))["reads"] == 40
    assert len(open(f"{out}/al.fq").read().split("\\n")) // 4 == sum(
        l.split("\\t")[1] != "4" for l in recs)
    assert all(l.endswith("\\tRG:Z:g\\n") for l in recs)

    from nvbio_tpu_torch.utils.simulate import simulate_pairs
    pe = simulate_pairs(g, 20, 80, insert_mean=250, insert_sd=20, seed=4)
    for m in (1, 2):
        write_fastq(f"{out}/p{m}.fq", [
            (f"p{i}", pe[f"seqs{m}"][i].astype(np.uint8), pe[f"quals{m}"][i])
            for i in range(20)])
    assert mapr(["-x", f"{out}/g.npz", "-1", f"{out}/p1.fq", "-2",
                 f"{out}/p2.fq", "-S", f"{out}/pe.sam", "--device", "cpu",
                 "--batch", "32"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    recs = [l for l in open(f"{out}/pe.sam") if not l.startswith("@")]
    print("pe_records", len(recs),
          "proper", sum(int(l.split("\\t")[1]) & 2 > 0 for l in recs))

    # a sharded index: two build workers, then SE and PE on its manifest
    assert build([f"{out}/g.fa", f"{out}/sh", "--lut-k", "8", "--shard-bp",
                  "12000", "--shard-overlap", "1024", "--procs", "2"]) == 0
    for name, reads in (("sh", ["-U", f"{out}/r.fq"]),
                        ("shpe", ["-1", f"{out}/p1.fq", "-2",
                                  f"{out}/p2.fq"])):
        assert mapr(["-x", f"{out}/sh.manifest.json", *reads, "-S",
                     f"{out}/{name}.sam", "--device", "cpu", "--batch",
                     "32"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    def records(name):
        return [l.replace("\\tRG:Z:g", "") for l in open(f"{out}/{name}")
                if not l.startswith("@")]

    print("sharded", records("sh.sam") == records("o.sam"),
          records("shpe.sam") == records("pe.sam"))

    # the MEM and q-gram mappers' CLIs on the same reads
    from nvbio_tpu_torch.tools.mem_map import main as mem_map
    from nvbio_tpu_torch.tools.qmap import main as qmap
    n_al = []
    for name, tool in (("mem", mem_map), ("qmap", qmap)):
        assert tool(["-x", f"{out}/g.npz", "-U", f"{out}/r.fq", "-S",
                     f"{out}/{name}.sam", "--device", "cpu", "--batch",
                     "32"]) == 0
        n_al.append(sum(l.split("\t")[1] != "4" for l in records(
            f"{name}.sam")))
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    print("seed_mappers", *n_al)

    # the device index build (sort and occ) and the read-set BWT, on the CPU
    from nvbio_tpu_torch.tools.set_bwt import main as set_bwt
    assert build([f"{out}/g.fa", f"{out}/gd.npz", "--lut-k", "8",
                  "--algorithm", "device", "--device-occ", "--device",
                  "cpu"]) == 0
    assert set_bwt([f"{out}/r.fq", f"{out}/b.txt", "--device", "cpu"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    with np.load(f"{out}/g.npz") as za, np.load(f"{out}/gd.npz") as zb:
        same = za.files == zb.files and all(
            np.array_equal(za[k], zb[k]) for k in za.files)
    print("device_build", same, open(f"{out}/b.txt").read().count("$"))

    # BWA interop, protein SW and the read corrector, on the CPU
    from nvbio_tpu_torch.tools.bwa_export import main as bwa_export
    from nvbio_tpu_torch.tools.bwa_import import main as bwa_import
    from nvbio_tpu_torch.tools.correct_reads import main as correct_reads
    from nvbio_tpu_torch.tools.protein_sw import main as protein_sw
    assert bwa_export([f"{out}/g.npz", f"{out}/bw", "--reverse"]) == 0
    assert bwa_import([f"{out}/bw", f"{out}/gi.npz", "--lut-k", "8"]) == 0
    open(f"{out}/q.fa", "w").write(">q1\\nMKVLAARND\\n")
    open(f"{out}/t.fa", "w").write(">t1\\nGGMKVLAARNDGG\\n>t2\\nWWWWWWWWW\\n")
    assert protein_sw([f"{out}/q.fa", f"{out}/t.fa", "-o", f"{out}/p.tsv",
                       "--device", "cpu"]) == 0
    assert correct_reads([f"{out}/r.fq", f"{out}/c.fq", "--log2-slots",
                          "16", "--device", "cpu"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    with np.load(f"{out}/g.npz") as za, np.load(f"{out}/gi.npz") as zb:
        same = all(np.array_equal(za[k], zb[k]) for k in za.files
                   if k != "meta")
    tsv = open(f"{out}/p.tsv").read().split()
    print("interop", same, tsv[5], tsv[-1],
          len(open(f"{out}/c.fq").read().splitlines()) // 4)

    # the shard-per-device mesh on [cpu] * 3, and fm_server
    import os, tempfile, threading, time
    from nvbio_tpu_torch.tools import fm_server
    assert mapr(["-x", f"{out}/sh.manifest.json", "-U", f"{out}/r.fq", "-S",
                 f"{out}/mesh.sam", "--device", "cpu", "--batch", "48",
                 "--mesh", "on"]) == 0
    sock = os.path.join(tempfile.mkdtemp(), "fm.sock")  # AF_UNIX: <108 B
    t = threading.Thread(target=fm_server.serve, args=(f"{out}/g.npz", sock),
                         kwargs=dict(batch=32, device="cpu", once=True))
    t.start()
    while not os.path.exists(sock):
        assert t.is_alive(), "fm_server stopped before serving"
        time.sleep(0.1)
    r = fm_server.request(sock, {"cmd": "map", "u": f"{out}/r.fq",
                                 "sam": f"{out}/srv.sam"})
    t.join()
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    print("mesh_server", records("mesh.sam") == records("o.sam"),
          r["status"], r["reads"])
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", GUARDED, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.split("\n")
    assert int(lines[0].split()[1]) >= 20  # every module imported
    _, n_rec, _, n_al = lines[1].split()
    assert int(n_rec) == 40 and int(n_al) >= 36
    _, n_rec, _, n_proper = lines[2].split()
    assert int(n_rec) == 40 and int(n_proper) >= 36
    assert lines[3] == "sharded True True"  # the same SAM as unsharded
    _, n_mem, n_qmap = lines[4].split()
    assert int(n_mem) >= 36 and int(n_qmap) >= 36
    assert lines[5] == "device_build True 40"  # the same .npz; 40 reads
    # imported = built; q1 against t1 (its copy: BLOSUM62's diagonal over
    # MKVLAARND) and t2 (no positive cell); 40 reads out
    assert lines[6] == "interop True 43 0 40"
    # --mesh on gives the unsharded SAM; the server mapped the 40 reads
    assert lines[7] == "mesh_server True ok 40"


def _tiny_index(tmp_path):
    from nvbio_tpu.io.fasta import write_fasta
    from nvbio_tpu.io.fastq import write_fastq
    from nvbio_tpu.utils.simulate import random_genome
    from nvbio_tpu_torch.tools.build_index import main as build

    g = random_genome(5_000, seed=3)
    write_fasta(str(tmp_path / "g.fa"), [("c", g)])
    write_fastq(str(tmp_path / "r.fq"),
                [("r0", g[100:180], np.full(80, 30, np.uint8))])
    build([str(tmp_path / "g.fa"), str(tmp_path / "g.npz"), "--lut-k", "6"])
    return ["-x", str(tmp_path / "g.npz"), "-U", str(tmp_path / "r.fq"),
            "-S", str(tmp_path / "o.sam")]


def test_map_reads_cuda_raises_without_cuda(tmp_path):
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        mapr(_tiny_index(tmp_path) + ["--device", "cuda"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("tool", ["mem_map", "qmap"])
def test_seed_mappers_cuda_raise_without_cuda(tmp_path, tool):
    """mem_map and qmap take --device cuda by default and never fall back
    to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    main = importlib.import_module(f"nvbio_tpu_torch.tools.{tool}").main
    args = _tiny_index(tmp_path)
    for extra in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="cuda"):
            main(args + extra)
    assert main(args + ["--device", "cpu"]) == 0
    recs = [ln.split("\t") for ln in open(tmp_path / "o.sam")
            if not ln.startswith("@")]
    assert len(recs) == 1 and recs[0][3] == "101"


@pytest.mark.parametrize("tool", ["protein_sw", "correct_reads"])
def test_protein_and_corrector_cuda_raise_without_cuda(tmp_path, tool):
    """protein_sw and correct_reads take --device cuda by default and never
    fall back to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    main = importlib.import_module(f"nvbio_tpu_torch.tools.{tool}").main
    (tmp_path / "p.fa").write_text(">p\nMKVLAARND\n")
    (tmp_path / "r.fq").write_text("@r\nACGTACGTACGTACGTACGT\n+\n"
                                   + "I" * 20 + "\n")
    args = ([str(tmp_path / "p.fa"), str(tmp_path / "p.fa"), "-o",
             str(tmp_path / "o.tsv")] if tool == "protein_sw"
            else [str(tmp_path / "r.fq"), str(tmp_path / "o.fq")])
    for extra in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="cuda"):
            main(args + extra)
    assert main(args + ["--device", "cpu"]) == 0


@pytest.mark.parametrize("flags", [["--mesh", "on"]], ids=["mesh"])
def test_map_reads_rejects_unported_flags(tmp_path, flags, capsys):
    """No flag of the reference's map_reads is refused as unported any
    more: --mesh on an unsharded index is ignored, as in the reference,
    and the SAM is the one without it."""
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    def body():
        return [ln for ln in open(tmp_path / "o.sam")
                if not ln.startswith("@PG")]

    args = _tiny_index(tmp_path) + ["--device", "cpu"]
    assert mapr(args + flags) == 0
    with_flags = body()
    assert "not ported" not in capsys.readouterr().err
    assert mapr(args) == 0
    assert body() == with_flags and len(with_flags) == 3


def test_shard_build_worker_imports_neither_torch_nor_jax(tmp_path):
    """The sharded build's pool workers run fmindex.build's
    build_shard_arrays: in a process that refuses torch, jax and the JAX
    package, it builds a shard equal to the in-process build."""
    code = textwrap.dedent("""
        import sys
        import numpy as np

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "jaxlib",
                                          "nvbio_tpu"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        from nvbio_tpu_torch.fmindex.build import build_shard_arrays
        seg = np.random.default_rng(5).integers(0, 4, 20_000).astype(
            np.uint8)
        fm, ssa, lut = build_shard_arrays((seg, 0, 8, 6, False))
        np.savez(sys.argv[1], *fm, *ssa, *lut)
    """)
    out = str(tmp_path / "shard.npz")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, out],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from nvbio_tpu_torch.fmindex.build import build_shard_arrays

    seg = np.random.default_rng(5).integers(0, 4, 20_000).astype(np.uint8)
    fm, ssa, lut = build_shard_arrays((seg, 0, 8, 6, False))
    with np.load(out) as z:
        for i, want in enumerate([*fm, *ssa, *lut]):
            np.testing.assert_array_equal(z[f"arr_{i}"], want)


@pytest.fixture()
def one_torch_thread():
    """One intra-op torch thread: the plain DP runs ~30 small ops per
    pattern row, which slow down many times over when the test workers'
    thread pools fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_map_reads_takes_long_read_settings(one_torch_thread, tmp_path,
                                           capsys):
    """--max-read-len 2048 --band 63, the JAX CLI's advice for long
    reads, is accepted and maps; the help says what the JAX CLI says."""
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    args = _tiny_index(tmp_path)
    assert mapr(args + ["--device", "cpu", "--max-read-len", "2048",
                        "--band", "63", "--batch", "32"]) == 0
    recs = [ln.split("\t") for ln in open(tmp_path / "o.sam")
            if not ln.startswith("@")]
    assert len(recs) == 1 and recs[0][3] == "101"
    with pytest.raises(SystemExit):
        mapr(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert ("raise for long reads (the DP engine row-blocks patterns "
            "beyond 512 bp automatically)") in text
    assert ("extension band half-width (default 15; long reads want more "
            "indel drift room, e.g. 63)") in text
