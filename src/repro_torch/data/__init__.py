from .rmat import rmat_edges, rmat_graph, rmat_weights, structured_graph
