"""Serve every full-width path of ``chip_smoke.py`` from two checkouts of
the port in turns (A, B, B, A), each turn in a process of its own, and
print each path's serve line: its greedy-token digest, launch counts,
prefill times and decode median.

    python3 scripts/ab_serve_torch.py A_DIR B_DIR

Each directory is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory). Both sides
run this checkout's ``chip_smoke.phase_serve`` against their own
``src/``, so they print the same line; equal digests mean equal greedy
tokens. Needs one CUDA card; compare times only within one run.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("qwen2.5-3b", "mamba2-1.3b", "zamba2-7b", "mixtral-8x7b-16l",
         "nemotron-4-15b", "codeqwen1.5-7b", "phi3-mini-3.8b", "internvl2-76b-40l")

_CHILD = r"""
import os, sys
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
root, tree, paths = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path.insert(0, root)
import chip_smoke  # puts this checkout's src/ on the path; the tree's goes before it
sys.path.insert(0, os.path.join(tree, "src"))
import torch
from repro_torch.kernels import _build
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
_build.build()
for arch in paths:
    engine, served, counts = chip_smoke.phase_serve(torch, arch)
    del engine, served
    torch.cuda.empty_cache()
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for side in ("A", "B", "B", "A"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT), str(trees[side]),
                               *PATHS], capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if "requests in" in line:
                print(f"{side} {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(f"{side} ({trees[side]}) took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
