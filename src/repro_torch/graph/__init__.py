from repro_torch.graph.convert import (
    ell_from_arrays,
    graph_from_arrays,
    handle_from_arrays,
)
from repro_torch.graph.generators import (
    TOY_TABLE2,
    bipartite_graph,
    erdos_renyi_graph,
    paper_dataset,
    powerlaw_graph,
    toy_graph,
)
from repro_torch.graph.structs import (
    EllGraph,
    Graph,
    check_live_prefix,
    ell_from_edges,
    graph_from_edges,
    graph_to_host_edges,
    push_coo,
    push_ell,
    push_ell_padded,
    resolve_device,
)

__all__ = [
    "EllGraph",
    "Graph",
    "check_live_prefix",
    "ell_from_edges",
    "graph_from_edges",
    "graph_to_host_edges",
    "push_coo",
    "push_ell",
    "push_ell_padded",
    "resolve_device",
    "ell_from_arrays",
    "graph_from_arrays",
    "handle_from_arrays",
    "TOY_TABLE2",
    "bipartite_graph",
    "erdos_renyi_graph",
    "paper_dataset",
    "powerlaw_graph",
    "toy_graph",
]
