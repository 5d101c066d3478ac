"""The runners of the traffic kinds, one file each: `runners/<kind>.py`
defines `run(ctx)` and `judge(ctx, got, trace) -> (numbers, flops)` for
the traffic mixes whose `kind` is its name (`benchmark/run.py` finds it by
that name). A new kind of traffic, or a new model's, adds a file here."""
