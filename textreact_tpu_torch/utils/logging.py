"""Metric logging: stdout + metrics.jsonl (+ W&B when importable). Own copy
of textreact_tpu/utils/logging.py.

Role of reference main.py:362-369 (WandbLogger), self.log calls
(main.py:168-174,195) and log_every_n_steps (main.py:383).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional

log = logging.getLogger("textreact_tpu_torch")


def setup_logging(level=logging.INFO) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=level, stream=sys.stderr,
            format="%(asctime)s %(levelname).1s %(name)s: %(message)s")


def _as_scalar(v):
    """Device scalars/np numbers -> float; strings/bools pass through
    (event records like resumed_from)."""
    if isinstance(v, (str, bool)):
        return v
    return float(v)


class MetricLogger:
    def __init__(self, save_path: str, project: Optional[str] = None,
                 run_name: Optional[str] = None, use_wandb: bool = False):
        os.makedirs(save_path, exist_ok=True)
        self.path = os.path.join(save_path, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb  # optional; not in the baked environment
                self.wandb = wandb.init(project=project, name=run_name,
                                        dir=save_path)
            except Exception:
                log.info("wandb unavailable; logging to %s only", self.path)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": round(time.time() - self._t0, 3)}
        record.update({k: _as_scalar(v) for k, v in metrics.items()})
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()
