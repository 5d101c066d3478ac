"""Mean host ms per request in the engine's `engine/replay` span (the graph's
launch) over the stamped stretch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "engine_replay_host_ms")
