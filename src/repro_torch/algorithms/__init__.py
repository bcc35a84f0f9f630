from .covering import coloring, maximal_matching, mis, set_cover
from .decomposition import connectivity, ldd
from .eigen import pagerank, pagerank_iteration, pagerank_iteration_batched
from .local import personalized_pagerank, personalized_pagerank_batched
from .substructure import densest_subgraph, kcore, orientation_filter, triangle_count
from .traversal import (
    bfs,
    bfs_batched,
    traversal_cohort_active,
    traversal_cohort_init,
    traversal_cohort_rounds,
    wbfs,
    wbfs_batched,
)
