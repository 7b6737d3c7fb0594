#!/usr/bin/env python3
"""Instructions a step of the step loops of a column-sweep kernel, read
from the SASS of the kernel library: by default K5's banded tier
(``k5_band_kernel``), or any kernel whose mangled name contains
``--kernel``'s text (K4's sweep: ``k4_sweep_kernelILi4ELi1ELb0ELb1E``,
4 rows a lane, SEMI_GLOBAL, symbol windows, byte table).

    python3 k5_band_sass.py     # on a machine with nvcc and cuobjdump
    python3 k5_band_sass.py --kernel k4_sweep_kernelILi4ELi1ELb0ELb1E \
        [--root DIR]            # DIR/nvbio_tpu_torch instead of this one

Builds the kernels from nvbio_tpu_torch/ops/csrc (or reuses the build),
disassembles the library with cuobjdump and, for the SEMI_GLOBAL 16-warp
instantiation (``k5_band_kernel<1, 16>``, sw_benchmark's shape) or the
named kernel, counts the instructions of each innermost loop that
shuffles H and F up a lane over the steps it runs.  Prints one JSON
line: the loops' instructions a step in ascending order (the smallest is
the mask-free body of the strips without a sink).  Needs no card.
"""

import argparse
import json
import os
import re
import subprocess
import sys

K5_BAND = "k5_band_kernelILi1ELi16E"


def k5_band_sass(lib_path, kernel=K5_BAND):
    """Instructions a step of each step loop of the banded tier's
    SEMI_GLOBAL 16-warp kernel (k5_band_kernel<1, 16>), in ascending
    order, from cuobjdump's SASS of the kernel library: an innermost loop
    (a backward branch with no other inside it) whose body shuffles H and
    F up a lane (two SHFL.UP a step), its instructions over its steps;
    the smallest is the body of the strips without a sink.  ``kernel``:
    the text of the mangled name to take instead.  None without
    cuobjdump beside nvcc or without the kernel."""
    from nvbio_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    for part in re.split(r"\n\s*Function : ", sass):
        if kernel not in part.split("\n", 1)[0]:
            continue
        ins = [(int(m[1], 16), m[2]) for m in
               (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
                for ln in part.splitlines()) if m]
        at = {a: i for i, (a, _) in enumerate(ins)}
        back = [(at[int(m[1], 16)], i) for i, (a, op) in enumerate(ins)
                for m in [re.search(r"BRA.*?(0x[0-9a-f]+)", op)]
                if m and int(m[1], 16) <= a and int(m[1], 16) in at]
        steps = []
        for lo, hi in back:
            if any(lo <= x and y < hi for x, y in back if (x, y) != (lo, hi)):
                continue  # not innermost
            n = sum("SHFL.UP" in op for _, op in ins[lo:hi + 1]) // 2
            if n:
                steps.append((hi - lo + 1) / n)
        return sorted(steps)
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default=K5_BAND)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from nvbio_tpu_torch.ops import _build

    steps = k5_band_sass(_build.build(), args.kernel)
    if not steps:
        sys.exit(f"k5_band_sass.py: no cuobjdump beside nvcc, or no "
                 f"{args.kernel} in the library")
    print(json.dumps({f"{args.kernel} instructions a step":
                      [round(n, 2) for n in steps]}))


if __name__ == "__main__":
    main()
