"""Median host ms a training step of the window waited in `next()` for its
batch from the program's loader (`data/loader.PrefetchLoader`), by the
host clock; nothing where the run read no batches from files."""
import statistics


def read(ctx):
    waits = ctx.get("loader_wait_ms")
    return statistics.median(waits) if waits else None
