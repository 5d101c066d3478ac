"""Nodes of the request's CUDA graph, captured by an engine without a tracer
(the window's kind), over the batch (the engine's `graph_nodes` counter)."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "graph_nodes_per_frame")
