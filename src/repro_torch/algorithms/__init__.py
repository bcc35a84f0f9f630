from .covering import coloring, maximal_matching, mis, set_cover
from .eigen import pagerank, pagerank_iteration, pagerank_iteration_batched
from .substructure import densest_subgraph, kcore, orientation_filter, triangle_count
from .traversal import bfs, bfs_batched, wbfs, wbfs_batched
