"""Quickstart of the PyTorch/CUDA port: the Sage PSAM engine in five minutes.

The same steps and the same graph as ``examples/quickstart.py``, through
``repro_torch``: an R-MAT graph (the read-only large-memory structure), an
ExecutionPlan, a handful of the 18 algorithms through it, the graphFilter,
and a batch of concurrent queries through the QueryEngine.  Runs on the card
(the default) or, with ``--device cpu``, on the plain PyTorch route.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.algorithms import bfs, connectivity, kcore, pagerank, triangle_count
from repro_torch.core import PSAMCost, filter_edges_pred, make_filter, make_plan
from repro_torch.data import rmat_graph
from repro_torch.serving import QueryEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the graph lives (default: cuda; 'cpu' for the plain route)")
    args = ap.parse_args(argv)
    g = rmat_graph(n=2048, m=16384, weighted=True, seed=42, block_size=64, device=args.device)
    generator = torch.Generator(device=g.device).manual_seed(0)
    print(f"graph: n={g.n} m={g.m} blocks={g.num_blocks} (F_B={g.block_size})")

    # one plan, every algorithm: algorithm code never picks an engine
    plan = make_plan(g)
    print(f"plan: {plan.describe()}")

    parents, levels = bfs(g, 0, plan=plan)
    reached = int((levels >= 0).sum())
    print(f"BFS from 0: reached {reached} vertices, max level {int(levels.max())}")

    labels = connectivity(g, generator, plan=plan)
    n_comp = len(set(labels.tolist()))
    print(f"connectivity: {n_comp} components")

    pr, iters = pagerank(g, plan=plan)
    top = torch.argsort(-pr)[:5]
    print(f"pagerank converged in {int(iters)} iters; top-5 vertices: {top.tolist()}")

    core = kcore(g, plan=plan)
    print(f"k-core: max coreness {int(core.max())}")

    print(f"triangles: {triangle_count(g)}")

    # graphFilter: delete light edges WITHOUT touching the CSR (PSAM rule)
    f = make_filter(g)
    f2, remaining = filter_edges_pred(g, f, lambda s, d, w: w >= 2.0)
    print(
        f"filter: kept {int(remaining)}/{g.m} edges (w>=2) — "
        f"bits={f2.bits.numel() * 4} bytes of small memory, zero large-memory writes"
    )

    # serving: coalesce concurrent requests into one edge sweep per round
    eng = QueryEngine(g, plan=plan, max_batch=8)
    handles = [eng.submit("bfs", src=s) for s in [0, 17, 99, 512]]
    eng.submit("ppr", src=0, max_rounds=50)
    results = eng.flush()
    print(
        f"served {eng.stats['served']} queries in {eng.stats['batches']} "
        f"batches; BFS(17) reached "
        f"{int((results[handles[1]][1] >= 0).sum())} vertices"
    )

    cost = PSAMCost()
    cost.charge_edgemap_batched(g, 4)  # one batched sweep, 4 queries
    cost.charge_filter_pack(g, g.num_blocks)
    print(
        f"PSAM accounting for one batched round: work={cost.work:.0f} "
        f"(GBBS-equivalent with in-place packing at omega=4: "
        f"{cost.gbbs_equivalent_work(g.m):.0f})"
    )


if __name__ == "__main__":
    main()
