"""Suffix-array / BWT construction: the port of ``nvbio_tpu/sufsort``.

The same names as the reference's package:

- ``suffix_array``, ``suffix_array_pd``, ``bwt_from_sa`` (``sa``):
  native C++ SA-IS with a NumPy prefix-doubling fallback, host only;
- ``suffix_array_device``, ``set_bwt_device``, ``set_bwt_oracle``
  (``device``): whole-text prefix doubling and the read-set BWT on a
  torch device, and the naive host set-BWT;
- ``suffix_array_bucketed`` (``bucketed``): the shard-scale sort (host
  8-symbol bucketing, chunked device refinement, compacted doubling).

The names resolve on first use, so that ``from .sa import ...`` (the
index build, whose pool workers must not load torch) imports numpy and
the native library only.
"""

import importlib

_EXPORTS = {
    "suffix_array": "sa", "suffix_array_pd": "sa", "bwt_from_sa": "sa",
    "suffix_array_device": "device", "set_bwt_device": "device",
    "set_bwt_oracle": "device", "suffix_array_bucketed": "bucketed",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
