"""GNN models of the port (``repro.models.gnn``): message passing over COO
edges with ``index_add_`` segment sums, and NequIP."""
