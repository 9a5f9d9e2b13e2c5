"""Fix a cell's SLO fit and its rate, once, on the card, in one process.

    python3 portbench/sweep.py --workload <cell> [--seed 0] [--fit 60]
        [--rates 4,5,6 | --rel 0.8,0.9,1.0] [--seconds 20]

1. The isolated service time: ``--fit`` invocations of the cell's mix
   (its fixed shapes), each sent when the one before it has ended, timed
   from the start of the Shabari loop to the last token, and fitted as
   k0 + k1 * (batch x padded prompt) + k2 * new tokens by least squares.
2. The knee (open-loop mixes only): the mix at each of ``--rates``
   invocations per second (or ``--rel`` times the capacity the fit's
   mean service time gives) for ``--seconds`` each, on a fresh loop. At a
   rate the system sustains, the last token comes about one service time
   after the window and the wait does not grow from the first quarter of
   the window to the last.

It prints both tables; the cell file takes the fit and 0.8 x the knee.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fit_service(records):
    import numpy as np

    X = np.array([[1.0, r.batch * r.padded_len, r.max_new] for r in records])
    y = np.array([r.t_gen - r.start for r in records])
    k, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ k
    return k, y, pred


def sweep(workload: str, seed: int, n_fit: int, rates, seconds: float, device="cuda",
          root=None, log=print, rel=()):
    import dataclasses

    import numpy as np
    import torch

    from portbench import harness, readers, traffic

    root = root or harness.PB
    device = torch.device(device)
    spec = harness.load_spec(workload, root)
    vocab = spec.config["vocab_size"]
    fit_invs = traffic.generate(dict(spec.mix, loop="closed", documents=n_fit), seed, vocab)
    weights, engine = harness.start(spec, seed, fit_invs, device)
    log(f"sweep {workload}: set-up {time.perf_counter() - T_START:.1f} s on "
        f"{harness.device_info(device)}")

    loop = harness.Loop(spec, engine, device)
    recs = harness._records(fit_invs, 0.0)
    for r in recs:
        loop.serve(r)
    k, y, pred = fit_service(recs)
    res = (y - pred) / pred
    log(f"fit over {len(recs)} isolated invocations: k0_s {k[0]:.6g} "
        f"k1_s_per_prompt_token {k[1]:.6g} k2_s_per_new_token {k[2]:.6g}; mean service "
        f"{y.mean() * 1e3:.2f} ms (capacity {1 / y.mean():.3f}/s); residual / fit: median "
        f"{np.median(np.abs(res)):.4f}, worst {np.abs(res).max():.4f}")
    for r, yy, pp in list(zip(recs, y, pred))[:12]:
        log(f"  batch {r.batch} padded {r.padded_len:5d} new {r.max_new}: "
            f"{yy * 1e3:8.2f} ms (fit {pp * 1e3:8.2f}; prefill {r.prefill_s * 1e3:7.2f}, "
            f"decode {r.decode_s * 1e3 / r.max_new:6.2f}/step)")
    if spec.mix["loop"] != "open":
        return k, []
    rates = list(rates) + [x / float(y.mean()) for x in rel]
    cell = dict(spec.cell, slo_fit={"k0_s": float(k[0]), "k1_s_per_prompt_token": float(k[1]),
                                    "k2_s_per_new_token": float(k[2])})
    rows = []
    log("rate/s  N   last_token_s  wait_q1_ms  wait_q4_ms  p50_ms  p90_ms  slo_%")
    for rate in rates:
        sp = dataclasses.replace(spec, cell=dict(cell, rate_per_s=rate, trace_seconds=1e9))
        invs = traffic.generate(sp.mix, seed + 1, vocab, rate=rate, seconds=seconds)
        loop = harness.Loop(sp, engine, device)
        t0 = time.perf_counter() + 0.01
        done, _, _ = harness.serve_window(sp, loop, invs, seconds, t0)
        waits = [(r.start - r.due) * 1e3 for r in done]
        q = max(1, len(waits) // 4)
        lat = [(r.t_gen - r.due) * 1e3 for r in done]
        met = sum(r.t_gen - r.due <= r.slo_s for r in done) / len(done) * 100
        row = (rate, len(done), max(r.t_gen for r in done) - t0, float(np.mean(waits[:q])),
               float(np.mean(waits[-q:])), readers.percentile(lat, 50),
               readers.percentile(lat, 90), met)
        rows.append(row)
        log("{:6.3f} {:4d} {:10.3f} {:11.2f} {:11.2f} {:8.1f} {:8.1f} {:6.1f}".format(*row))
    return k, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SLO fit and knee sweep of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fit", type=int, default=60)
    ap.add_argument("--rates", default="")
    ap.add_argument("--rel", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    rates = [float(x) for x in args.rates.split(",") if x]
    rel = [float(x) for x in args.rel.split(",") if x]
    sweep(args.workload, args.seed, args.fit, rates, args.seconds,
          log=lambda m: print(m, flush=True), rel=rel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
