"""Mean host ms per step in the trainer's `trainer/replay_a` and
`trainer/replay_b` spans (the two graphs' launches) over the stamped
stretch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "train", "trainer_replay_host_ms")
