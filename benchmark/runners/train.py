"""The `train` kind: `benchmark/train.py` (the program's `Trainer.run_step`
on a pool of synthetic batches made in memory)."""
from benchmark.train import judge, run

__all__ = ["run", "judge"]
