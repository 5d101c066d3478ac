"""The `serve` kind: `benchmark/serve.py` (the program's
`InferenceEngine.refine` under a closed loop of one client)."""
from benchmark.serve import judge, run

__all__ = ["run", "judge"]
