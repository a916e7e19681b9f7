from .dsl import CircuitGraph, CoreSpec, Edge, parse_graph, get_symbol, render_dsl
from .generators import (
    mps_graph,
    tree_graph,
    wall_graph,
    wall_graph_col,
    random_graph,
    example_graph,
    build_brick_wall_incidence,
    incidence_to_graph,
)
from .surgery import split_graph, merge_graphs
from .mutable import MutableGraph

__all__ = [
    "CircuitGraph",
    "CoreSpec",
    "Edge",
    "parse_graph",
    "get_symbol",
    "render_dsl",
    "mps_graph",
    "tree_graph",
    "wall_graph",
    "wall_graph_col",
    "random_graph",
    "example_graph",
    "build_brick_wall_incidence",
    "incidence_to_graph",
    "split_graph",
    "merge_graphs",
    "MutableGraph",
]
