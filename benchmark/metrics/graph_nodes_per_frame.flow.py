"""Nodes of the pair's CUDA graph, captured by a `FlowEngine` without a
tracer (the window's kind), over the batch (the engine's `graph_nodes`
counter)."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "graph_nodes_per_frame")
