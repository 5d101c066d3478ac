"""A whole run past the harness's look for a chip, at the tiny scene on the
CPU, with the timed path broken underneath (`benchmark/faults.py`):
`correct` comes out false for each fault a cell can have, and true for the
sound run. The limits are the configuration files' own."""
from __future__ import annotations

import pytest
import torch

from benchmark import faults, run
from benchmark.tests._bench_common import tiny_spec

CPU = torch.device("cpu")
SEED = 2**31 + 77

CASES = ([("tiny-track", None, True)]
         + [("tiny-track", f, False) for f in ("unchanged", "altered")]
         + [("tiny-parity", None, True)]
         + [("tiny-parity", f, False) for f in ("unchanged", "half", "altered")]
         + [("tiny-train", None, True)]
         + [("tiny-train", f, False) for f in ("unchanged", "half", "altered")])


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f, _ in CASES])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault, correct):
    torch.manual_seed(0)
    spec = tiny_spec(str(tmp_path))
    table = faults.TRAINING if cell == "tiny-train" else faults.SERVING
    hooks = {"fault": table[fault]} if fault else None
    res = run.run_cell(spec, cell, SEED, 0.5, False, CPU, hooks=hooks)
    assert res["correct"] is correct, res["limits"]
