"""The 18 Sage algorithms (Table 1), grouped as in §4.3."""
from .covering import coloring, maximal_matching, mis, set_cover
from .decomposition import (
    biconnectivity,
    connectivity,
    ldd,
    multi_source_bfs,
    spanner,
    spanning_forest,
)
from .eigen import pagerank, pagerank_iteration, pagerank_iteration_batched
from .local import personalized_pagerank, personalized_pagerank_batched
from .substructure import densest_subgraph, kcore, orientation_filter, triangle_count
from .traversal import (
    bellman_ford,
    betweenness,
    bfs,
    bfs_batched,
    traversal_cohort_active,
    traversal_cohort_init,
    traversal_cohort_rounds,
    wbfs,
    wbfs_batched,
    widest_path,
)

ALL_PROBLEMS = [
    "bfs",
    "wbfs",
    "bellman_ford",
    "widest_path",
    "betweenness",
    "spanner",
    "ldd",
    "connectivity",
    "spanning_forest",
    "biconnectivity",
    "coloring",
    "mis",
    "maximal_matching",
    "set_cover",
    "triangle_count",
    "kcore",
    "densest_subgraph",
    "pagerank",
]

__all__ = ALL_PROBLEMS + [
    "personalized_pagerank",
    "personalized_pagerank_batched",
    "pagerank_iteration",
    "pagerank_iteration_batched",
    "bfs_batched",
    "wbfs_batched",
    "multi_source_bfs",
    "orientation_filter",
    "traversal_cohort_init",
    "traversal_cohort_rounds",
    "traversal_cohort_active",
    "ALL_PROBLEMS",
]
