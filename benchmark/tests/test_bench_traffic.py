"""A seed makes the same traffic twice, and another seed other traffic:
the scene, the weights, the serving stream and the training pool."""
from __future__ import annotations

import json
import os

import torch

from benchmark import build, gen, serve, train
from benchmark.tests._bench_common import BENCH, tiny_config

CPU = torch.device("cpu")


def _traffic(name, **over):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    t.update(over)
    return t


def _stream(seed, n=3):
    cfg = tiny_config("tiny")
    s = gen.seeds(seed)
    scene = gen.make_scene(cfg, 2, s["scene"], CPU)
    reqs = serve.Requests(_traffic("batch8", batch=2), scene, s["requests"])
    w = gen.make_weights(build.build_model(build.side("reference"), cfg, "meta"),
                         s["weights"], CPU)
    return [scene.image, scene.T_init] + [x for _ in range(n) for x in reqs.next()] + list(
        w.values())


def _pool(seed):
    cfg = tiny_config("tiny")
    scene = gen.make_scene(cfg, 2, gen.seeds(seed)["scene"], CPU)
    pool = train.make_pool(_traffic("train8", pool=3, num_corr=32), scene, seed % 2**31)
    return [b[k] for b in pool for k in ("T_init", "image")] + [
        t for b in pool for t in b["corr"].values()]


def test_same_seed_same_traffic_other_seed_other():
    big = 2**31 + 12345
    a, b, c = _stream(big), _stream(big), _stream(big + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])
    # the requests of one run differ from each other
    assert not torch.equal(a[2], a[4]) and not torch.equal(a[3], a[5])


def test_training_pool_is_seeded_and_distinct():
    a, b, c = _pool(99), _pool(99), _pool(100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[2]) and not torch.equal(a[1], a[3])


def test_seeds_are_independent_streams():
    s = gen.seeds(7)
    assert len(set(s.values())) == len(s) and all(0 <= v < 2**63 for v in s.values())
    assert gen.seeds(7) == s != gen.seeds(8)
