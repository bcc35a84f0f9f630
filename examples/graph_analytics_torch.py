"""Sage graph-analytics pipeline in the PyTorch/CUDA port: the steps of
``examples/graph_analytics.py``, on the same graph, through ``repro_torch``.

1. build the immutable CSR (large memory) + an ExecutionPlan
2. maximal matching via graphFilter rounds (edge deletions = bit clears)
3. orient the remaining graph low→high degree through a second filter
4. triangle counting over the filtered view
5. k-core through the same plan (bucketed peeling, filtered edgeMaps)
6. PSAM cost report: Sage (0 large-memory writes) vs modeled GBBS (ω=4)

Runs on the card (the default) or, with ``--device cpu``, on the plain
PyTorch route.

    PYTHONPATH=src python examples/graph_analytics_torch.py [--device cpu]
"""
import argparse

from repro_torch.algorithms import kcore, maximal_matching, orientation_filter, triangle_count
from repro_torch.core import PSAMCost, make_plan
from repro_torch.data import rmat_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the graph lives (default: cuda; 'cpu' for the plain route)")
    args = ap.parse_args(argv)
    g = rmat_graph(n=1024, m=8192, seed=7, block_size=64, device=args.device)
    plan = make_plan(g, strategy="auto")
    print(f"graph: n={g.n} m={g.m}; {plan.describe()}")

    partner = maximal_matching(g)
    matched = int((partner >= 0).sum())
    print(f"maximal matching: {matched // 2} pairs ({matched}/{g.n} vertices)")

    f, keep = orientation_filter(g)
    print(
        f"orientation filter: {int(f.num_active_edges)} directed edges kept "
        f"(bits = {f.bits.numel() * 4} bytes, CSR untouched)"
    )

    tri = triangle_count(g)
    print(f"triangles: {tri}")

    core = kcore(g, plan=plan)
    print(f"k-core through the plan: max coreness {int(core.max())}")

    cost = PSAMCost(omega=4.0)
    # matching: ~8 filter rounds; triangles: one orientation + intersections
    live = int(f.block_live.sum())
    for _ in range(8):
        cost.charge_edgemap_planned(g, filter_live_blocks=live)
        cost.charge_filter_pack(g, g.num_blocks)
    print(
        f"PSAM work (Sage, zero NVRAM writes): {cost.work:.0f}\n"
        f"GBBS-equivalent (in-place edge packing, omega=4): "
        f"{cost.gbbs_equivalent_work(8 * g.m):.0f}  "
        f"→ {cost.gbbs_equivalent_work(8 * g.m) / cost.work:.2f}x more work"
    )


if __name__ == "__main__":
    main()
