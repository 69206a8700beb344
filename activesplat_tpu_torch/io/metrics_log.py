"""Experiment-tracker hooks (counterpart of activesplat_tpu/io/metrics_log.py:
the reference's optional Weights & Biases logging, `use_wandb`).

`get_tracker()` returns a live wandb run when the package is importable and
logging was asked for, a JSONL file tracker in the results directory where
it is not (the machine with the card has no wandb), or a no-op. The mapper
calls `tracker.log({...}, step=frame_id)`, the wandb API's shape.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class NullTracker:
    enabled = False

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker:
    """Appends wandb-shaped log rows to a metrics.jsonl file."""

    enabled = True

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        row = dict(metrics)
        if step is not None:
            row["step"] = int(step)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()


class WandbTracker:
    enabled = True

    def __init__(self, run):
        self._run = run

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        self._run.log(metrics, step=step)

    def finish(self) -> None:
        self._run.finish()


def get_tracker(
    use_wandb: bool,
    results_dir: Optional[str],
    project: str = "activesplat_tpu",
    run_name: Optional[str] = None,
):
    """wandb when asked for and importable, else a metrics.jsonl file in the
    results directory, else a no-op."""
    if not use_wandb:
        return NullTracker()
    try:
        import wandb
    except ImportError:
        if results_dir:
            return JsonlTracker(os.path.join(results_dir, "metrics.jsonl"))
        return NullTracker()
    return WandbTracker(wandb.init(project=project, name=run_name))
