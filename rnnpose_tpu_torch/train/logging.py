"""Training logs (port of `rnnpose_tpu/train/logging.py`): plain-text
`log.txt`, JSON-lines `log.json.lst` and, when `torch.utils.tensorboard`
imports, TensorBoard event files under `summary/`. Under a process group
only rank 0 logs: a `ModelLog` on another rank is disabled unless the
caller says otherwise."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from ..parallel.mesh import process_index

__all__ = ["ModelLog"]


class ModelLog:
    def __init__(self, model_dir: str, disable: Optional[bool] = None,
                 tensorboard: bool = True):
        self.model_dir = model_dir
        if disable is None:
            disable = process_index() != 0
        self.disable = disable
        self._txt = self._jsonl = self._tb = None
        if disable:
            return
        os.makedirs(model_dir, exist_ok=True)
        self._txt = open(os.path.join(model_dir, "log.txt"), "a")
        self._jsonl = open(os.path.join(model_dir, "log.json.lst"), "a")
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(model_dir, "summary"))

    def log_text(self, text: str, step: int):
        if self.disable:
            return
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] step {step}: {text}"
        print(line, flush=True)
        self._txt.write(line + "\n")
        self._txt.flush()

    def log_metrics(self, metrics: Dict[str, Any], step: int):
        if self.disable:
            return
        clean = {k: v if isinstance(v, str) else float(np.asarray(v)) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
        self.log_text(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in clean.items()), step)

    def close(self):
        for h in (self._txt, self._jsonl):
            if h is not None:
                h.close()
        if self._tb is not None:
            self._tb.close()
