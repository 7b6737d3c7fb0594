"""Shard-per-device mapping: one FM-index shard on each device of a mesh.

Port of ``nvbio_tpu/models/mesh_sharded.py``.  One process drives S
devices (the single-controller model of the reference's ``shard_map``):
shard k's index, genome slice and packed words live on ``devices[k]``,
and the read batch goes to every device.  The output equals the
sequential ``ShardedMapper``'s bit for bit; only the schedule changes:

  1. every shard's candidate stage runs on its own device, all S issued
     before any is collected, so that separate cards overlap;
  2. the (R, 2C) candidate tensors come to the lead device
     (``devices[0]``) and the sequential path's cross-shard top-2
     (``_top2_concat`` over the shard-major concat; ``_pe_merge_stacked``
     for pairs; the -a merge) reduces them, the locate drops summed;
  3. each lane's window comes from its winning shard's genome slice
     (the reference's masked ``psum``), gathered on the shard's device
     and copied to the lead device;
  4. the winners' traceback is one walk over the whole batch on the lead
     device, as in the sequential path.  The reference walks S read
     slices, one a chip, because SPMD gives each chip one slice; one
     controller needs no split, and S walks cost S syncs of the host.

A device may repeat: ``[cuda:0] * S`` runs the whole schedule on one
card, ``[cpu] * S`` on the CPU.  Where the reference stacks the shards
padded to one shape (``shard_map`` needs one), each shard here keeps its
own size; there is no pair-BWT or fused occ rows, as on every sharded
path of the port.  Positions stay shard-local on the devices and become
global on the host, as in the sequential path.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..parallel.mesh import to_device
from ..strings.seeds import num_uniform_seeds
from .mapper import stage_reads
from .params import MapperParams
from .paired import pe_map_batch
from .sharded_mapper import PairedShardedMapper, ShardedMapper, _shard_cands


def _indexed(dev) -> torch.device:
    """``dev`` with its index (``cuda`` -> ``cuda:<current>``), so that
    devices compare equal to the ones tensors report."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _nbytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (as ``to_device`` takes it)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


class MeshShardedMapper(ShardedMapper):
    """ShardedMapper whose shards each live on their own device of
    ``devices`` (one a shard; the first S cards by default).  SE and -a
    here; PE in MeshPairedShardedMapper."""

    #: device memory fraction left to the allocator's scratch and
    #: fragmentation
    HBM_RESERVE = 0.15

    def __init__(self, sidx, genome_symbols, params=MapperParams(),
                 ref_name="ref", contigs=None, devices=None):
        S = len(sidx.shards)
        if devices is None:
            n = torch.cuda.device_count()
            if n < S:
                raise ValueError(
                    f"need >= {S} devices for {S} shards, have {n} (use "
                    "the sequential ShardedMapper)")
            devices = [torch.device("cuda", k) for k in range(S)]
        devices = [_indexed(d) for d in devices]
        if len(devices) != S:
            raise ValueError(f"mesh size {len(devices)} != shard count {S}")
        if params.batch_size % S:
            # the reference's read-sharded traceback needs it; kept so
            # that the same command lines are accepted and refused
            raise ValueError(
                f"batch_size {params.batch_size} must divide by the "
                f"{S}-device mesh (traceback is read-sharded)")
        self.devices = devices
        self.params = params
        lt_pad = params.max_read_len + 2 * params.band_w + 8
        # a shard's index tensors, its genome slice (int8) and its packed
        # words (int32, 16 symbols a word)
        self._resident = [
            _nbytes((fm, ssa, lut)) + length + lt_pad
            + (length + 15) // 16 * 4
            for fm, ssa, lut, _, length in sidx.shards]
        self._check_hbm_budget()  # before anything is placed
        placed = copy.copy(sidx)
        placed.shards = [
            (to_device(fm, d), to_device(ssa, d), to_device(lut, d), start,
             length)
            for (fm, ssa, lut, start, length), d in zip(sidx.shards, devices)]
        super().__init__(placed, genome_symbols, params=params,
                         ref_name=ref_name, contigs=contigs)

    def hbm_budget(self, batch_size: int | None = None) -> dict:
        """Device memory model of the mesh, by device: resident bytes
        (each shard's index, genome slice and packed words) and the
        dominant per-batch transients of each shard's stages (seed and
        locate matrices at (2R, ...), extension windows at (2R * C,
        L + LT)), plus, on the lead device, the gathered candidates and
        the walk's flag matrix over R lanes; a device holding several
        shards counts them together.  ``limit`` is the card's total memory
        less HBM_RESERVE (None on the CPU, which is not checked)."""
        p = self.params
        R = batch_size or p.batch_size
        S = len(self.devices)
        L, W, C = p.max_read_len, p.band_w, p.max_candidates
        S_seeds = num_uniform_seeds(L, p.seed_len, p.seed_interval)
        KLOC = min(p.max_locate, S_seeds * p.max_hits_per_seed)
        transient = {
            "seed_select": 2 * R * S_seeds * p.max_hits_per_seed * 4 * 4,
            "locate_walk": 2 * R * KLOC * 4 * 4,
            "extension_windows": 2 * R * C * (L + L + 2 * W) * 2,
        }
        lead = {
            "dirs_matrix": R * ((L + 7) // 8 * 8) * (2 * W + 2),
            "gathered_cands": S * R * 2 * C * 4 * 4,
        }
        out = {}
        for k, d in enumerate(self.devices):
            b = out.setdefault(str(d), {
                "shards": [], "resident_index": 0, "transient_batch": 0,
                "limit": (int(torch.cuda.get_device_properties(d)
                              .total_memory * (1 - self.HBM_RESERVE))
                          if d.type == "cuda" else None)})
            b["shards"].append(k)
            b["resident_index"] += self._resident[k]
            b["transient_batch"] += sum(transient.values())
        out[str(self.devices[0])]["transient_batch"] += sum(lead.values())
        for b in out.values():
            b["total"] = b["resident_index"] + b["transient_batch"]
        return out

    def _check_hbm_budget(self):
        for dev, b in self.hbm_budget().items():
            if b["limit"] is not None and b["total"] > b["limit"]:
                raise ValueError(
                    f"device memory budget exceeded on {dev} (shards "
                    f"{b['shards']}): {b['total'] / 2**30:.2f} GiB needed, "
                    f"{b['limit'] / 2**30:.2f} GiB available (card memory - "
                    f"{self.HBM_RESERVE:.0%} reserve): resident index "
                    f"{b['resident_index'] / 2**30:.2f} GiB, transient batch "
                    f"{b['transient_batch'] / 2**30:.2f} GiB; remedies: more "
                    "shards (smaller slices a card), more cards, or a "
                    "smaller batch_size")

    def _on_devices(self, *tensors):
        """``tensors`` on each distinct device of the mesh (the lead's as
        they are)."""
        return {d: tensors if d == self.device
                else tuple(to_device(t, d) for t in tensors)
                for d in dict.fromkeys(self.devices)}

    def _shard_candidates(self, jr, jl, jq, params, uniform_shift=-1):
        """Each shard's candidate stage on its device (strands and seeds
        once a device), every stage issued before any result is copied
        to the lead device."""
        on = {d: (*r, stage_reads(*r, params=params,
                                  uniform_shift=uniform_shift))
              for d, r in self._on_devices(jr, jl, jq).items()}
        cands = [_shard_cands(st, *on[d][:3], params=params, pre=on[d][3])
                 for st, d in zip(self.shard_state, self.devices)]
        return [to_device(c, self.device) for c in cands]


class MeshPairedShardedMapper(MeshShardedMapper, PairedShardedMapper):
    """Paired-end mapping with one index shard a device: each shard's
    pe_map_batch on its device (pair ownership by the leftmost mate),
    the sequential path's cross-shard merge on the lead device, then one
    walk a mate there.  The pair policy and SAM records are
    PairedShardedMapper's."""

    def _shard_pairs(self, tensors):
        on = self._on_devices(*tensors)
        outs = [pe_map_batch(st["fm"], st["ssa"], st["gw"], st["g"],
                             *on[d][0], *on[d][1], params=self.params,
                             lut=st["lut"], span=st["own"])
                for st, d in zip(self.shard_state, self.devices)]
        return [to_device(o, self.device) for o in outs]
