"""Disk checkpoints for the chunked ICP and CPD drivers (port of
``tpuslam/harness/checkpoint.py``).

A chunked run's boundary is the exact loop state (``ICPResume``,
``CPDResume``); this module makes it durable, so a killed run continues
in a new process along the same trajectory.

The file format is the JAX package's: one ``.npz`` holding the resume
leaves as arrays and a ``header`` (uint8 JSON: ``version`` 1, ``kind``
``"icp"`` or ``"cpd"``, and ``meta``).  Loading checks the kind and
every key the caller expects in ``meta``, cloud fingerprints among them,
so a file never resumes another registration; the drivers treat any
failure as "not this run's state" and start fresh.

Files move between the packages as files: each loads the other's arrays.
A resume across packages is not promised: ``cloud_fingerprint`` sums in
float32, and XLA and torch add in different orders, so the other
package's fingerprints may not match and its driver then starts fresh
with its notice.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.algorithms.cpd import CPDResume
from tpuslam_torch.algorithms.icp import ICPResume
from tpuslam_torch.ops.nn_hier import HierState

_VERSION = 1

# what a checkpoint file can throw at a loader: a metadata mismatch
# (ValueError), a truncated or empty file from a killed save (BadZipFile,
# EOFError, OSError), a foreign npz without our arrays (KeyError) or a
# garbled header; each means "not my checkpoint" to a driver
LOAD_ERRORS = (
    ValueError,
    OSError,
    EOFError,
    KeyError,
    zipfile.BadZipFile,
    json.JSONDecodeError,
)


def cloud_fingerprint(points: torch.Tensor, mask: torch.Tensor) -> List[float]:
    """A cheap content fingerprint for checkpoint metadata, in float32 on
    the cloud's device: the masked per-axis coordinate sums, the masked
    sum of squares and a row-order-weighted sum.  The weighted sum tells
    row permutations apart: they give the same transform but other
    per-row warm NN bounds, which a resume carries (``ICPResume.nn``)."""
    masked = points * mask[:, None]
    sums = torch.sum(masked, dim=0, dtype=torch.float32)
    ssq = torch.sum(masked * masked, dtype=torch.float32)
    n = points.shape[0]
    w = torch.arange(1, n + 1, dtype=torch.float32, device=points.device) / n
    ordered = torch.sum(masked * w[:, None], dtype=torch.float32)
    return torch.cat([sums, ssq[None], ordered[None]]).tolist()


def _host(x, dtype) -> np.ndarray:
    """A tensor, array or number as a host array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _save(path: str, kind: str, arrays: dict, meta: Optional[dict]) -> None:
    header = json.dumps({"version": _VERSION, "kind": kind, "meta": meta or {}})
    arrays["header"] = np.frombuffer(header.encode(), dtype=np.uint8)
    # atomic: a run killed mid-save must never leave a truncated file
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(z, kind: str, expect_meta: Optional[dict]) -> dict:
    header = json.loads(bytes(z["header"]).decode())
    if header.get("version") != _VERSION:
        raise ValueError(f"checkpoint version {header.get('version')} != {_VERSION}")
    # files written before the kind tag existed were all ICP
    if header.get("kind", "icp") != kind:
        raise ValueError(
            f"checkpoint mismatch on kind: stored {header.get('kind')!r}, expected {kind!r}")
    meta = header.get("meta", {})
    for key, want in (expect_meta or {}).items():
        got = meta.get(key)
        if got != want:
            raise ValueError(
                f"checkpoint mismatch on {key!r}: stored {got!r}, expected {want!r}")
    return meta


def save_icp_checkpoint(path: str, resume: ICPResume, meta: Optional[dict] = None) -> None:
    """Write ``resume`` (transform, guard state, the hierarchical arm's warm
    state when there is one, iterations done) and ``meta`` to ``path``."""
    arrays = {
        "rotation": _host(resume.rotation, np.float32),
        "translation": _host(resume.translation, np.float32),
        "error": _host(resume.error, np.float32),
        "done_before": _host(resume.done_before, np.int32),
    }
    if resume.prev_error is not None:
        arrays["prev_error"] = _host(resume.prev_error, np.float32)
    if resume.nn is not None:
        arrays["nn_prev_target"] = _host(resume.nn.prev_target, np.float32)
        arrays["nn_warm"] = _host(resume.nn.warm, bool)
        arrays["nn_sparse"] = _host(resume.nn.sparse, bool)
    _save(path, "icp", arrays, meta)


def load_icp_checkpoint(
    path: str, expect_meta: Optional[dict] = None, device=None
) -> Tuple[ICPResume, dict]:
    """Load an ICP checkpoint as torch tensors on ``device`` (the CPU by
    default); every key of ``expect_meta`` must match the stored
    metadata exactly."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device or "cpu")

    with np.load(path) as z:
        meta = _load(z, "icp", expect_meta)
        nn = None
        # older files stored other warm-state arrays: they load without
        # one, and the search re-warms after one query (every arm is exact)
        if "nn_prev_target" in z:
            nn = HierState(prev_target=t(z["nn_prev_target"]), warm=t(z["nn_warm"]),
                           sparse=t(z["nn_sparse"]))
        resume = ICPResume(
            rotation=t(z["rotation"]),
            translation=t(z["translation"]),
            error=t(z["error"]),
            done_before=int(z["done_before"]),
            prev_error=t(z["prev_error"]) if "prev_error" in z else None,
            nn=nn,
        )
    return resume, meta


def save_cpd_checkpoint(path: str, resume: CPDResume, meta: Optional[dict] = None) -> None:
    """Write a ``CPDResume`` (the EM loop state at a chunk boundary) and
    ``meta`` to ``path``."""
    arrays = {
        name: _host(getattr(resume, name), np.float32)
        for name in ("rotation", "translation", "scale", "sigma2", "log_likelihood", "ntol")
    }
    arrays["done_before"] = _host(resume.done_before, np.int32)
    _save(path, "cpd", arrays, meta)


def load_cpd_checkpoint(
    path: str, expect_meta: Optional[dict] = None, device=None
) -> Tuple[CPDResume, dict]:
    """Load a CPD checkpoint as torch tensors on ``device`` (the CPU by
    default); ``expect_meta`` as in ``load_icp_checkpoint``."""
    with np.load(path) as z:
        meta = _load(z, "cpd", expect_meta)
        resume = CPDResume(
            *(torch.from_numpy(np.array(z[name])).to(device or "cpu")
              for name in ("rotation", "translation", "scale", "sigma2", "log_likelihood",
                           "ntol")),
            done_before=int(z["done_before"]),
        )
    return resume, meta


def load_resume_or_none(
    path: str, kind: str, expect_meta: Optional[dict], quiet: bool = False, device=None
):
    """The chunked drivers' load policy: the resume state when ``path``
    holds a checkpoint matching ``expect_meta`` exactly, else None: a
    missing, mismatched, truncated or corrupt file alike means "not this
    registration's state" (start fresh and overwrite).  Prints one notice
    for a file that exists but does not load, unless ``quiet``."""
    if not os.path.exists(path):
        return None
    loader = load_icp_checkpoint if kind == "icp" else load_cpd_checkpoint
    try:
        resume, _ = loader(path, expect_meta=expect_meta, device=device)
        return resume
    except LOAD_ERRORS as exc:
        if not quiet:
            print(f"[tpuslam] ignoring checkpoint {path} "
                  f"(not this registration's state: {exc!r})")
        return None
