"""Readings behind a cell's ``logit_gap`` limit, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 12]
        [--control]

For each seed: a run of the cell (set-up, a window of ``--seconds`` at the
cell's own load, the program's state freed), then the widest gap of the
served tokens on the sample a run compares, and with ``--control`` the
control on the same sample: the reference computed with float8 weights
and activations in the program's place, its widest gap read as the gap
of the token it puts first. The benchmark's own runs never run the
control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, control: bool, *, t_start: float,
             device="cuda", root=None) -> dict:
    from portbench import harness

    sv = harness.serve(workload, seed, seconds, False, t_start=t_start, device=device,
                       root=root or harness.PB)
    checks = harness.judge(sv, control)
    return {"seed": seed, "read": checks.pop("read", None), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="logit-gap readings of the program and the control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    t = T_START
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds, args.control, t_start=t)
        print(json.dumps(r), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
