"""Seconds from the start of `benchmark/run.py` to the window: imports,
scene, weights, the key's encode_3d, warm-ups and capture, the warm-up
requests or steps."""


def read(ctx):
    return ctx["setup_s"]
