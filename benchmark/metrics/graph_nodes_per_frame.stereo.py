"""Nodes of the stereo pair's CUDA graph, captured by a `FlowEngine` without
a tracer (the window's kind), over the batch (the engine's `graph_nodes`
counter)."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "graph_nodes_per_frame")
