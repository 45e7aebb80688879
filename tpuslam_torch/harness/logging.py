"""Structured run logging — one JSONL record per registration run.

A copy of ``tpuslam/harness/logging.py`` with the same record keys; its
``"backend"`` is the type of the device the run used (``"cuda"`` or
``"cpu"``), where the original records ``jax.default_backend()``.

The reference's telemetry is printf + CSV (``testrunner.cpp:62-74``) with
a config echo (``configuration.cpp:4-114``).  Here the same information —
config, result transform, iterations, error, stage timings, backend —
lands in one machine-readable JSONL record per run, alongside the
human-readable echo the CLI already prints."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpuslam_torch.config.configuration import Configuration


def result_record(
    config: Configuration,
    rotation: np.ndarray,
    translation: np.ndarray,
    iterations: int,
    error: float,
    cloud_sizes: Optional[tuple] = None,
    timings_ms: Optional[Dict[str, int]] = None,
    *,
    device: torch.device | str,
) -> Dict[str, Any]:
    tp = config.transformation_parameters
    return {
        "ts": time.time(),
        "backend": torch.device(device).type,
        "method": config.computation_method.value,
        "before_path": config.before_path,
        "after_path": config.after_path,
        "approximation_type": config.approximation_type.value,
        "rotation_range": tp[0] if tp else None,
        "translation_range": tp[1] if tp else None,
        "cloud_sizes": list(cloud_sizes) if cloud_sizes else None,
        "rotation": np.asarray(rotation).reshape(-1).tolist(),
        "translation": np.asarray(translation).reshape(-1).tolist(),
        "iterations": int(iterations),
        "error": float(error),
        "timings_ms": timings_ms or {},
    }


class RunLogger:
    """Appends one JSONL record per registration run."""

    def __init__(self, path: str):
        self.path = path
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)

    def log(self, record: Dict[str, Any]) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(record) + "\n")
