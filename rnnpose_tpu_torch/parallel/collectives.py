"""Metric reduction across processes (port of
`rnnpose_tpu/parallel/collectives.py`).

The reference all-gathers seq_len-weighted metric sums across ranks at
eval; the training step's metrics are averaged with its gradients
(`train/loop.py`).
"""
from __future__ import annotations

from typing import Dict, List

from .mesh import all_gather_object, process_count

__all__ = ["weighted_reduce_metrics"]


def _local_sums(summaries, keys, weight_key):
    """Per-key (weighted sum, weight) over this process's summaries, and
    its total weight. A summary weighs only the keys it carries, so mixed
    evaluator classes (or a process with no frame) do not drag down
    metrics they never measured."""
    sums = {k: float(sum(s[k] * s.get(weight_key, 0) for s in summaries if k in s))
            for k in keys}
    ws = {k: float(sum(s.get(weight_key, 0) for s in summaries if k in s)) for k in keys}
    return sums, ws, float(sum(s.get(weight_key, 0) for s in summaries))


def weighted_reduce_metrics(summaries: List[Dict[str, float]],
                            weight_key: str = "seq_len") -> Dict[str, float]:
    """The seq_len-weighted mean of per-class summaries, per key, over
    every process's summaries; `weight_key` holds the total weight.

    Across processes (a process group of more than one rank) every rank
    must call it, a rank without summaries too: each contributes its
    per-key sums and weights over its own key set, the keys are the union
    of the sets, and a key's mean divides the summed sums by the summed
    weights. Every rank gets the same result."""
    local_keys = sorted({k for s in summaries for k in s if k != weight_key})
    if process_count() > 1:
        gathered = all_gather_object(_local_sums(summaries, local_keys, weight_key))
        keys = sorted({k for sums, _, _ in gathered for k in sums})
        sums = {k: sum(g[0].get(k, 0.0) for g in gathered) for k in keys}
        ws = {k: sum(g[1].get(k, 0.0) for g in gathered) for k in keys}
        total = sum(g[2] for g in gathered)
    else:
        sums, ws, total = _local_sums(summaries, local_keys, weight_key)
    out = {k: sums[k] / ws[k] for k in sums if ws[k] > 0}
    out[weight_key] = total
    return out
