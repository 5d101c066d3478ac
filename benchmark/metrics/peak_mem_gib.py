"""`torch.cuda.max_memory_allocated()` in GiB from the program's build
through the window (reset after the benchmark renders its scene), read
when the window closes, before the check."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2 ** 30
