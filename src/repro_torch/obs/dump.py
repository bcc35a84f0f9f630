"""CLI metric dump: replay a small instrumented workload, print the registry.

    PYTHONPATH=src python -m repro_torch.obs.dump                 # Prometheus text
    PYTHONPATH=src python -m repro_torch.obs.dump --format json   # snapshot() dict
    PYTHONPATH=src python -m repro_torch.obs.dump --workload none # current registry
    PYTHONPATH=src python -m repro_torch.obs.dump --device cpu    # the plain route

The default ``--workload serve`` drives a ``ServingService`` replay (mixed
BFS / wBFS / PPR, one budgeted tenant so the admission counters populate)
against the process-global registry on ``--device`` (default ``cuda``),
then dumps it: per-(op, tenant) latency histograms, queue depth, flush
causes, admission outcomes, engine batch shapes and cache hits, the
mirrored PSAM charge counters and the drift gauge.
``--workload none`` dumps whatever the process has already recorded.
"""
from __future__ import annotations

import argparse
import json
import sys

from .metrics import get_registry


def run_serve_workload(n: int = 256, m: int = 1024, requests: int = 12, device=None) -> None:
    """Drive a small replay through ``ServingService`` on ``device`` (default
    ``cuda``) so every instrumented layer records into the process-global
    registry.  The graph and the arrival times are the JAX package's
    (``python -m repro.obs.dump``) for the same arguments."""
    import numpy as np

    from ..data import rmat_graph
    from ..serving import ServiceConfig, ServingService

    g = rmat_graph(n, m, weighted=True, seed=3, block_size=32, device=device)
    svc = ServingService(
        g,
        config=ServiceConfig(slo=0.01, max_batch=8, budgets={"budgeted": (5e5, 1e7)}),
    )
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(requests):
        t += float(rng.exponential(1 / 300.0))
        # cohort ops (bfs / wbfs) and an engine op (ppr), so both the
        # service's and the engine's metric families populate
        op = ("bfs", "wbfs", "bfs", "ppr")[i % 4]
        tenant = "budgeted" if i % 2 else "default"
        svc.submit(op, tenant=tenant, src=int(rng.integers(0, g.n)), now=t)
        svc.tick(t)
        nd = svc.next_deadline()
        if nd is not None and (i + 1 == requests or nd < t + 0.01):
            svc.tick(nd)
    svc.drain(t + 1.0)


def main(argv=None) -> int:
    """Entry point: optional workload, then dump the default registry."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--format", choices=("prom", "json"), default="prom",
        help="Prometheus text exposition (default) or the snapshot() dict",
    )
    ap.add_argument(
        "--workload", choices=("serve", "none"), default="serve",
        help="'serve' replays a small instrumented trace first; "
        "'none' dumps the registry as-is",
    )
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the dump to PATH instead of stdout")
    ap.add_argument("--n", type=int, default=256, help="workload graph vertices")
    ap.add_argument("--m", type=int, default=1024, help="workload graph edges")
    ap.add_argument("--requests", type=int, default=12, help="workload request count")
    ap.add_argument("--device", default=None,
                    help="where the workload runs (default cuda; 'cpu' runs the plain route)")
    args = ap.parse_args(argv)

    if args.workload == "serve":
        run_serve_workload(n=args.n, m=args.m, requests=args.requests, device=args.device)

    reg = get_registry()
    if args.format == "json":
        text = json.dumps(reg.snapshot(), indent=1, sort_keys=True, default=str)
    else:
        text = reg.to_prometheus_text()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"wrote {len(text.splitlines())} lines to {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
