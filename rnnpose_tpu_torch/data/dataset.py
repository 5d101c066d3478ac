"""Dataset registry and base class (port of `rnnpose_tpu/data/dataset.py`)."""
from __future__ import annotations

from typing import Dict

__all__ = ["register_dataset", "get_dataset_class", "Dataset"]

_DATASET_REGISTRY: Dict[str, type] = {}


def register_dataset(cls):
    _DATASET_REGISTRY[cls.__name__] = cls
    return cls


def get_dataset_class(name: str) -> type:
    return _DATASET_REGISTRY[name]


class Dataset:
    """Minimal map-style dataset interface."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError
