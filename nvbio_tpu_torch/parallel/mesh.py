"""Device meshes for data-parallel and shard-per-device mapping.

Port of ``nvbio_tpu/parallel/mesh.py``.  A mesh is an explicit list of
``torch.device``s, one a part, named by the caller: nothing here picks a
device on its own.  A device may repeat, so ``[cpu] * n`` runs n parts on
the CPU (the counterpart of the reference tests' virtual CPU devices) and
``[cuda:0] * n`` runs them on one card.  ``shard_reads`` splits a batch's
leading axis into one equal part a device, and ``replicate`` copies a
tree of tensors (an index, a genome) to each device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device


def make_mesh(n_devices: int | None = None,
              device: str | torch.device = "cuda") -> list[torch.device]:
    """``n_devices`` devices of the kind ``device`` names: the first n
    cards for ``"cuda"`` (every card by default; ValueError if fewer
    exist), or n copies of a device with an index (``"cuda:0"``) or of
    ``"cpu"`` (one by default)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * (1 if n_devices is None else n_devices)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"a mesh of {n} cards needs {n} cards, have {count}")
    return [torch.device("cuda", k) for k in range(n)]


def to_device(tree, dev: torch.device):
    """A copy of ``tree`` (tensors, and tuples, lists, dicts and
    dataclasses of them) with every tensor on ``dev``; other leaves as
    they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, dev) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    return tree


def shard_reads(mesh: list[torch.device], *arrays):
    """Split each array's leading (reads) axis into ``len(mesh)`` equal
    parts, part k on ``mesh[k]``.  Returns a list of parts for one array,
    a tuple of such lists for several."""
    n = len(mesh)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split into {n} "
                             "equal parts")
        out.append([p.to(d) for p, d in zip(a.chunk(n), mesh)])
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: list[torch.device], tree):
    """One copy of ``tree`` (as ``to_device`` takes it) a device."""
    return [to_device(tree, d) for d in mesh]
