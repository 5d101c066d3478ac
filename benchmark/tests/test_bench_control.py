"""The lower-precision control comes out not correct under each cell's
limits: the reference computed one step below the configuration's
precision (float8 for its bf16 convolutions; TF32 for a float32
configuration), put in the program's place and judged by the same
comparison. At the tiny scene on the CPU for the bf16 configuration (the
CPU has no TF32), and at each cell's own size on the card."""
from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.run import ROOT
from benchmark.spec import load_spec
from benchmark.tests._bench_common import tiny_spec


def _fails(spec, cell, seed, device):
    c = spec.cell(cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    fn = control.serving_control if traffic["kind"] == "serve" else control.training_control
    numbers = fn(cfg, traffic, seed, device)
    limits = cfg["limits"][traffic["kind"]]
    return any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.parametrize("cell", ["tiny-track", "tiny-train"])
def test_control_fails_at_the_tiny_scene(tmp_path, cell):
    failed, numbers = _fails(tiny_spec(str(tmp_path)), cell, 2**31 + 3, torch.device("cpu"))
    assert failed, numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["linemod-track-b1", "parity-eval-b8", "linemod-train-b8",
                                  "linemod-serve-b8"])
def test_control_fails_at_the_cells_size(card, cell):
    failed, numbers = _fails(load_spec(ROOT), cell, 2**31 + 11, card)
    assert failed, numbers
