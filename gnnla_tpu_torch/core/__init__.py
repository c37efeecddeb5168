"""The GN-block engine: graph containers, blocks and aggregators,
matrix <-> graph conversions and block-diagonal batching."""

from gnnla_tpu_torch.core.graph import GraphState, GraphBatch, columns
from gnnla_tpu_torch.core.block import (GNBlock, EdgeAggregator,
                                        NodeAggregator, make_edge_aggregator,
                                        chain)
from gnnla_tpu_torch.core.convert import (as_operator, coo_to_gnn_input,
                                          remove_diag_entries,
                                          matrix_to_graph, graph_to_matrix,
                                          graph_state_from_matrix)
from gnnla_tpu_torch.core.batch import (batch_operators, batch_states,
                                        graph_sizes, unbatch_vertices)

__all__ = ["GraphState", "GraphBatch", "columns", "GNBlock",
           "EdgeAggregator", "NodeAggregator", "make_edge_aggregator",
           "chain", "as_operator", "coo_to_gnn_input", "remove_diag_entries",
           "matrix_to_graph", "graph_to_matrix", "graph_state_from_matrix",
           "batch_operators", "batch_states", "graph_sizes",
           "unbatch_vertices"]
