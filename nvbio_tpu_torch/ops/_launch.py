"""What the kernel wrappers of ``ops/`` share: the device decision, input
staging for the C entry points, the scheme arguments and the launch on
the inputs' card."""

from __future__ import annotations

import torch

from ..alignment.types import AlignmentType, GotohScheme, gap_penalties
from . import _build


def on_cpu(*tensors) -> bool:
    """True for CPU inputs, False for CUDA inputs; raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def stage_inputs(patterns, plens, tlens, quals):
    """Contiguous int8 patterns, uint8 quals (None = 40), int32 lengths
    and an empty (3, NB) int32 output, checked for shape."""
    nb, lp = patterns.shape
    dev = patterns.device
    if quals is None:
        quals = torch.full((nb, lp), 40, dtype=torch.uint8, device=dev)
    if quals.shape != patterns.shape:
        raise ValueError(f"quals {tuple(quals.shape)} != patterns "
                         f"{tuple(patterns.shape)}")
    if plens.shape != (nb,) or tlens.shape != (nb,):
        raise ValueError("plens and tlens must be (NB,)")
    return (patterns.to(torch.int8).contiguous(),
            quals.to(torch.uint8).contiguous(),
            plens.to(torch.int32).contiguous(),
            tlens.to(torch.int32).contiguous(),
            torch.empty((3, nb), dtype=torch.int32, device=dev))


def stage_texts(texts, nb: int) -> torch.Tensor:
    tx = texts.to(torch.int8).contiguous()
    if tx.shape[0] != nb:
        raise ValueError("texts and patterns differ in batch size")
    return tx


def stage_packed(packed, win_start, nb: int):
    ws = win_start.to(torch.int64).contiguous()
    if ws.shape != (nb,):
        raise ValueError("win_start must be (NB,)")
    return packed.to(torch.int32).contiguous(), ws


def scheme_args(scheme: GotohScheme, atype: AlignmentType):
    eo, ee, fo, fe = gap_penalties(scheme)
    return [atype.value, scheme.match, scheme.mismatch_min,
            scheme.mismatch_max, scheme.n_penalty, eo, ee, fo, fe]


def call(name: str, dev: torch.device, *args) -> None:
    """Call the kernel library's entry point ``name`` on ``args`` and
    ``dev``'s current stream, with ``dev`` the CUDA current device: a
    ``<<<>>>`` inside goes to the current device, so a call on tensors of
    another card would fail (invalid resource handle) or launch there.
    Raises on a CUDA error."""
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, name)


def result(out):
    return {"score": out[0], "p_end": out[1], "t_end": out[2]}
