"""Opcode counts of the tick kernels' machine code (SASS) on the card's
architecture: each ``csrc/*.cu`` compiled to a cubin with the package's
nvcc flags and disassembled with ``cuobjdump -sass``.  Shared loads (LDS)
against generic loads (LD) show whether the compiler sees a view as shared
memory; local loads and stores (LDL, STL) show a stack frame in use.

    python -m libdwbc_tpu_torch.sass_counts [tick_prestage tick_qpchain ...]

Prints one line per kernel source.  Needs nvcc and cuobjdump (a CUDA
toolkit); no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from .ops import _build

OPCODES = ("LDS", "LD", "LDG", "LDL", "STS", "ST", "STG", "STL", "FFMA", "BAR", "WARPSYNC")


def counts(stem: str, out: Path) -> Counter:
    """Opcode counts of csrc/<stem>.cu's cubin."""
    nvcc = _build.nvcc_path()
    cubin = out / f"{stem}.cubin"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", str(_build.CSRC / f"{stem}.cu"), "-o",
                    str(cubin)], check=True, capture_output=True)
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    ops = Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)[.\s]", sass):
        ops[m.group(1)] += 1
    return ops


def main():
    stems = sys.argv[1:] or ["tick_prestage", "tick_qpchain"]
    with tempfile.TemporaryDirectory(prefix="sass_counts_") as tmp:
        for stem in stems:
            ops = counts(stem, Path(tmp))
            print(f"{stem}: " + "  ".join(f"{op} {ops[op]}" for op in OPCODES)
                  + f"  (all instructions {sum(ops.values())})")


if __name__ == "__main__":
    main()
