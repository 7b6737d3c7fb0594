"""Sharded FM-index: references past one int32 index (GRCh38's 3.1 Gbp).

Port of ``nvbio_tpu/fmindex/sharded.py``.  Each shard keeps the int32
layout of ``fmindex/index.py`` over its slice of the genome plus an
``overlap`` tail, so that an alignment crossing a shard boundary is
found whole in the left shard; ``models/sharded_mapper.py`` maps
against every shard and reduces across them.  Positions become global
(shard start + local, int64) only on the host.

The files are the reference's: ``<prefix>.manifest.json``, one ``.npz``
per shard in the ``io/index_file.py`` format, and ``<prefix>.genome.npy``.
Indexes written by either package load in the other.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ..io.index_file import index_from_numpy, load_index, save_index
from .build import build_kmer_lut, build_shard_arrays
from .index import SSA


class ShardedIndex:
    """List of (fm, ssa, lut_or_None, start, length) over one global
    genome; the shards' tensors all lie on one device."""

    def __init__(self, shards, n_total, sa_sample, lut_k):
        self.shards = shards
        self.n_total = int(n_total)
        self.sa_sample = int(sa_sample)
        self.lut_k = int(lut_k)


def _shard_bounds(n: int, shard_bp: int, overlap: int):
    bounds = []
    start = 0
    while start < n:
        end = min(start + shard_bp, n)
        if bounds and n - start <= overlap:
            # the tail's whole span already lies inside the previous
            # shard's overlap: its ownership folds left instead of
            # paying a full per-batch candidate stage for a sliver (the
            # stage's cost is batch-shaped, not text-shaped)
            break
        bounds.append((start, min(end + overlap, n)))
        start = end
    return bounds


def build_sharded_index(symbols: np.ndarray, shard_bp: int,
                        overlap: int = 1024, sa_sample: int = 16,
                        lut_k: int = 11, bi_sample: bool = False,
                        n_procs: int = 1, occ_device: bool = False,
                        device="cuda") -> ShardedIndex:
    """Split ``symbols`` into shards of ``shard_bp`` (each extended by
    ``overlap`` into the next, a tail no longer than the overlap folded
    into the previous shard) and build every shard's index, as CPU
    tensors.  ``n_procs > 1`` builds shards in that many spawned worker
    processes (the shards are independent), which run
    ``fmindex.build.build_shard_arrays`` on the host and load no torch.
    ``occ_device`` computes each shard's occ tables on ``device`` in the
    sequential build only: the pool's workers build them on the host,
    as the reference's pool worker drops ``occ_device``."""
    bounds = _shard_bounds(len(symbols), shard_bp, overlap)
    jobs = [(symbols[s:e], s, sa_sample, lut_k, bi_sample)
            for s, e in bounds]
    if n_procs > 1 and len(bounds) > 1:
        with ProcessPoolExecutor(max_workers=min(n_procs, len(bounds)),
                                 mp_context=mp.get_context("spawn")) as ex:
            outs = list(ex.map(build_shard_arrays, jobs))
    else:
        outs = [build_shard_arrays(job, occ_device, device) for job in jobs]
    shards = []
    for (fm_f, ssa_f, lut), (s, e) in zip(outs, bounds):
        fm, ssa, _, lut = index_from_numpy(
            fm_f, (*ssa_f, sa_sample, int(bool(bi_sample))), np.zeros(0),
            lut)
        shards.append((fm, ssa, lut, s, e - s))
    return ShardedIndex(shards, len(symbols), sa_sample, lut_k)


def save_sharded_index(prefix: str, idx: ShardedIndex, genome, contig_names,
                       contig_lens):
    """Writes <prefix>.manifest.json + one .npz per shard + genome."""
    man = {
        "n_total": idx.n_total,
        "sa_sample": idx.sa_sample,
        "lut_k": idx.lut_k,
        "contig_names": list(contig_names),
        "contig_lens": [int(x) for x in contig_lens],
        "shards": [],
    }
    np.save(prefix + ".genome.npy", np.asarray(genome, dtype=np.int8))
    for i, (fm, ssa, lut, start, length) in enumerate(idx.shards):
        path = f"{prefix}.shard{i}.npz"
        save_index(path, (fm.bwt_words, fm.occ_abs, fm.occ_sub, fm.C,
                          fm.primary, fm.n),
                   (ssa.mark_words, ssa.mark_abs, ssa.vals),
                   np.zeros(0, np.int8), [], [], idx.sa_sample,
                   sa_bi=ssa.bi, lut=lut, lut_k=idx.lut_k)
        man["shards"].append({
            "file": os.path.basename(path), "start": int(start),
            "length": int(length),
        })
    with open(prefix + ".manifest.json", "w") as f:
        json.dump(man, f)


def _strip_bi_ssa(ssa: SSA) -> SSA:
    """Drop the SA % K == 1 marks of a bi-marked SSA (on the host).

    The sharded mappers locate with single LF steps, where only the
    SA % K == 0 marks are needed; plain locate() is exact with either
    marking, and the stripped SSA is half the size."""
    if not ssa.bi:
        return ssa
    dev = ssa.vals.device
    words = ssa.mark_words.cpu().numpy()
    vals = ssa.vals.cpu().numpy()
    bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)
    keep_val = (vals % max(int(ssa.k), 1)) == 0
    rows = np.flatnonzero(bits)
    bits[rows[~keep_val]] = False
    packed = np.packbits(bits.reshape(-1, 32), axis=1, bitorder="little")
    mark_words = packed.view("<i4").reshape(-1)
    popc = bits.reshape(-1, 32).sum(axis=1)
    mark_abs = np.zeros(len(mark_words), np.int32)
    np.cumsum(popc[:-1], out=mark_abs[1:])
    return SSA(mark_words=torch.from_numpy(mark_words).to(dev),
               mark_abs=torch.from_numpy(mark_abs).to(dev),
               vals=torch.from_numpy(np.ascontiguousarray(vals[keep_val])
                                     ).to(dev),
               k=int(ssa.k), bi=0)


def read_manifest(prefix: str) -> dict:
    """The manifest of ``prefix``, with a sliver tail shard that older
    builds emitted (fully covered by the previous shard's overlap, see
    _shard_bounds) folded left."""
    with open(prefix + ".manifest.json") as f:
        man = json.load(f)
    entries = list(man["shards"])
    while (len(entries) > 1
           and entries[-2]["start"] + entries[-2]["length"]
           >= entries[-1]["start"] + entries[-1]["length"]):
        entries.pop()
    return {**man, "shards": entries}


def load_sharded_index(prefix: str, lut_k: int | None = None,
                       device="cpu"):
    """Returns (ShardedIndex with its tensors on ``device``, genome int8
    numpy array, manifest dict).

    Bi-marked shard SSAs are stripped to mono marks (_strip_bi_ssa).
    ``lut_k``: rebuild each shard's k-mer LUT at this depth from the
    stored genome (a histogram cumsum, no suffix array), as the
    reference's loader does; 0 or None keeps the stored one."""
    man = read_manifest(prefix)
    d = os.path.dirname(os.path.abspath(prefix + ".manifest.json"))
    genome = np.load(prefix + ".genome.npy")
    rebuild = bool(lut_k) and lut_k != man["lut_k"]
    shards = []
    for s in man["shards"]:
        fm, ssa, _, meta = load_index(os.path.join(d, s["file"]), device)
        lut = meta.get("lut")
        start, length = s["start"], s["length"]
        if rebuild:
            seg = np.ascontiguousarray(
                genome[start:start + length]).astype(np.uint8)
            lut = tuple(torch.from_numpy(x).to(device)
                        for x in build_kmer_lut(seg, k=lut_k))
        shards.append((fm, _strip_bi_ssa(ssa), lut, start, length))
    if rebuild:
        man = {**man, "lut_k": lut_k}
    idx = ShardedIndex(shards, man["n_total"], man["sa_sample"],
                       man["lut_k"])
    return idx, genome, man
