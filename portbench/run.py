"""The port's benchmark: one run of one cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It puts ``src`` on the path itself, keeps
every cache inside ``portbench/out/``, fails without a CUDA card, and
prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and ``checks`` last: each number compared with its
limit, also the last lines on standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "portbench" / "out"


def _environment() -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(OUT / "cache" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    # the program's host work is one Python thread launching kernels: idle
    # intra-op workers spinning beside it only take cores from it
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    need = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START)
    except Exception:  # a run that cannot finish prints its traceback and no result
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
