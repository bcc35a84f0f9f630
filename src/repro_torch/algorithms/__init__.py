from .eigen import pagerank, pagerank_iteration, pagerank_iteration_batched
from .traversal import bfs, bfs_batched, wbfs, wbfs_batched
