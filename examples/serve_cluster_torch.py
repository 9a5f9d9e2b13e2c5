"""Cluster serving on the PyTorch port: Shabari vs the five baselines on
an Azure-style ten-minute trace over a 16-worker cluster (paper Figure 8,
one seed).

The port of ``examples/serve_cluster.py``, with the same printed lines.
Shabari's per-invocation CSOAA agents run on ``--device`` (the card by
default); the baselines hold no tensors.

Run:  PYTHONPATH=src python examples/serve_cluster_torch.py [--rps 5] [--quick]
      [--device cpu]
"""

import argparse

from repro_torch.serving.experiment import run_experiment


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rps", type=float, default=5.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the agents (cuda by default; cpu for a CPU run)")
    args = ap.parse_args(argv)
    dur = 240.0 if args.quick else 600.0

    print(f"trace: rps={args.rps} duration={dur:.0f}s seed={args.seed}")
    print(f"{'policy':18s} {'SLO viol%':>9s} {'idle vCPU p50':>13s} "
          f"{'idle mem p50':>12s} {'cold%':>6s} {'OOM%':>5s}")
    for pol in ("static-medium", "static-large", "parrotfish", "aquatope",
                "cypress", "shabari"):
        r = run_experiment(pol, rps=args.rps, duration_s=dur, seed=args.seed,
                           device=args.device)
        s = r.summary
        print(f"{pol:18s} {s['slo_violation_pct']:9.2f} "
              f"{s['wasted_vcpus_p50']:13.1f} {s['wasted_mem_mb_p50']:10.0f}MB "
              f"{s['cold_start_pct']:6.2f} {s['oom_pct']:5.2f}")


if __name__ == "__main__":
    main()
