"""Readings behind a cell's limits, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 12]
        [--control] [--root DIR] [--neighbour-router] [--bf16-router]

For each seed: a run of the cell (set-up, a window of ``--seconds`` at the
cell's own load, the program's state freed), then the numbers of the
sample a run compares, and with ``--control`` the control on the same
sample: the reference computed with float8 weights and activations in
the program's place, its widest gap read as the gap of the token it puts
first; and the seconds the check took. For a configuration with experts
both references route as the program routed, and the readings add the
widest route deficit, the share of (token, layer) choices that are not
the reference's own top-k (``route_flip_pct``) and the invocations
served again differently.
``--root`` takes the cell from another copy of the benchmark directory
(its ``BENCHMARK.json`` beside it), so that a cell not yet committed can
be calibrated. ``--neighbour-router`` and ``--bf16-router`` plant a
routing fault in the program, through the window and the serving again
alike: each layer's experts chosen by the next layer's router, or the
router's logits computed in bfloat16 in place of float32. The
benchmark's own runs never run the control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, control: bool, *, t_start: float,
             device="cuda", root=None) -> dict:
    from portbench import harness

    sv = harness.serve(workload, seed, seconds, False, t_start=t_start, device=device,
                       root=root or harness.PB)
    t = time.perf_counter()
    checks = harness.judge(sv, control)
    return {"seed": seed, "read": checks.pop("read", None), "checks": checks,
            "check_s": time.perf_counter() - t}


@contextlib.contextmanager
def neighbour_router():
    """The program's layer i routes with layer i + 1's router (the last
    with the first's); everything else as served."""
    from repro_torch.models import model

    layer = model._layer

    def faulty(blocks, i):
        bp = layer(blocks, i)
        if isinstance(blocks, dict) and "moe" in blocks:
            router = blocks["moe"]["router"]
            bp["moe"] = dict(bp["moe"], router=router[(i + 1) % router.shape[0]])
        return bp

    model._layer = faulty
    try:
        yield
    finally:
        model._layer = layer


@contextlib.contextmanager
def bf16_router():
    """The program's router logits computed in bfloat16 (hidden state,
    router and product), then routed as served."""
    import torch
    from repro_torch.models import moe

    route = moe.route

    def faulty(p, cfg, xt):
        probs = torch.softmax((xt.bfloat16() @ p["router"].bfloat16()).float(), dim=-1)
        gates, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
        return probs, gates / gates.sum(dim=-1, keepdim=True), ids

    moe.route = faulty
    try:
        yield
    finally:
        moe.route = route


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the program and the control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--root", type=Path, default=None,
                    help="a copy of the benchmark directory that holds the cell")
    ap.add_argument("--neighbour-router", action="store_true")
    ap.add_argument("--bf16-router", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    t = T_START
    root = args.root.resolve() if args.root else None
    faults = []
    with contextlib.ExitStack() as stack:
        if args.neighbour_router:
            stack.enter_context(neighbour_router())
            faults.append("neighbour_router")
        if args.bf16_router:
            stack.enter_context(bf16_router())
            faults.append("bf16_router")
        for s in args.seeds.split(","):
            r = readings(args.workload, int(s), args.seconds, args.control, t_start=t,
                         root=root)
            print(json.dumps(dict(r, faults=faults)), flush=True)
            t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
