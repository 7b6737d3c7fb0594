"""The port must run where JAX is not installed (the GPU machine has
none) and keeps its own copies of the host code it needs: in a
subprocess whose import system refuses ``jax`` and every ``nvbio_tpu``
module, import every ``nvbio_tpu_torch`` module, build an index and map
a tiny dataset on the CPU.  Also: the CLI's device and unported-flag
errors."""

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
                 f"{out}/o.sam", "--device", "cpu", "--batch", "32"]) == 0
    assert not any(m in ("jax", "nvbio_tpu")
                   or m.startswith(("jax.", "nvbio_tpu.")) for m in sys.modules)
    recs = [l for l in open(f"{out}/o.sam") if not l.startswith("@")]
    print("records", len(recs),
          "aligned", sum(l.split("\\t")[1] != "4" for l in recs))
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


@pytest.mark.parametrize("flags", [["-N", "1"], ["--local"], ["-a"],
                                   ["-1", "a.fq", "-2", "b.fq"],
                                   ["--mesh", "on"], ["--xprof", "d"]],
                         ids=["N1", "local", "all", "paired", "mesh",
                              "xprof"])
def test_map_reads_rejects_unported_flags(tmp_path, flags, capsys):
    from nvbio_tpu_torch.tools.map_reads import main as mapr

    with pytest.raises(SystemExit):
        mapr(_tiny_index(tmp_path) + ["--device", "cpu"] + flags)
    assert "not ported" in capsys.readouterr().err


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
