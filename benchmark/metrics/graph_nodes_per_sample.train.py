"""Nodes of the training step's graphs A and B, captured by a trainer without
a tracer (the window's kind), over the batch (the trainer's `graph_nodes`
counter)."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "train", "graph_nodes_per_sample")
