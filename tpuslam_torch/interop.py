"""State carried between the JAX package and the port, as numpy arrays.

``to_numpy_state(obj)`` turns a ``Cloud``, ``RigidTransform``,
``HierState``, ``ICPResume``, ``Sufficient``, ``FGTModel``, ``CPDState``
(a CPD ``RegistrationResult.em``) or ``CPDResume`` of either package
into a dict of numpy arrays (it reads the NamedTuple's fields and never
imports JAX).
``from_numpy_state(d, device)`` turns such a dict into the port's object
on ``device``:

* ``{"points", "count"}`` -> ``Cloud``;
* ``{"rotation", "translation", "scale"}`` -> ``RigidTransform``;
* ``{"prev_target", "warm", "sparse"}`` -> ``HierState``;
* ``{"rotation", "translation", "error"}`` plus optional ``prev_error``,
  ``done_before`` and ``nn`` (a nested ``HierState`` dict) ->
  ``ICPResume``;
* ``{"p1", "pt1", "px", "error"}`` -> ``Sufficient``;
* ``{"centers", "ak"}`` -> ``FGTModel``;
* ``{"rotation", ..., "log_likelihood", "ntol", "iterations"}`` ->
  ``CPDState``; with ``done_before`` instead of ``iterations`` ->
  ``CPDResume``.

The tests use these to start both ICP or CPD loops from the same
mid-run state.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tpuslam_torch.algorithms.cpd import CPDResume, CPDState
from tpuslam_torch.algorithms.icp import ICPResume
from tpuslam_torch.core.device import resolve_device
from tpuslam_torch.core.types import Cloud, RigidTransform, Sufficient
from tpuslam_torch.ops.fgt import FGTModel
from tpuslam_torch.ops.nn_hier import HierState

_KINDS = {
    "Cloud": ("points", "count"),
    "RigidTransform": ("rotation", "translation", "scale"),
    "HierState": ("prev_target", "warm", "sparse"),
    "ICPResume": (
        "rotation", "translation", "error", "prev_error", "done_before",
        "nn",
    ),
    "Sufficient": ("p1", "pt1", "px", "error"),
    "FGTModel": ("centers", "ak"),
    "CPDState": (
        "rotation", "translation", "scale", "sigma2", "log_likelihood",
        "ntol", "iterations",
    ),
    "CPDResume": (
        "rotation", "translation", "scale", "sigma2", "log_likelihood",
        "ntol", "done_before",
    ),
}
_EM = ("rotation", "translation", "scale", "sigma2", "log_likelihood", "ntol")

PortState = Union[Cloud, RigidTransform, HierState, ICPResume, Sufficient,
                  FGTModel, CPDState, CPDResume]


def _to_numpy(value):
    if type(value).__name__ in _KINDS:  # a nested state (ICPResume.nn)
        return to_numpy_state(value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def to_numpy_state(obj) -> dict:
    """A ``Cloud``, ``RigidTransform``, ``HierState`` or ``ICPResume`` (of
    either package) as a dict of numpy arrays, a nested state as a nested
    dict; fields that are None are left out."""
    name = type(obj).__name__
    if name not in _KINDS:
        raise TypeError(f"no numpy state for {name}")
    return {
        k: _to_numpy(getattr(obj, k))
        for k in _KINDS[name]
        if getattr(obj, k) is not None
    }


def from_numpy_state(
    d: dict, device: Optional[torch.device | str] = None
) -> PortState:
    """The port's object for a dict made by ``to_numpy_state``."""
    device = resolve_device(device)

    def f32(k):
        return torch.tensor(np.asarray(d[k], np.float32), device=device)

    if "log_likelihood" in d:
        em = {k: f32(k) for k in _EM}
        if "iterations" in d:
            return CPDState(**em, iterations=int(d["iterations"]))
        return CPDResume(**em, done_before=int(d.get("done_before", 0)))
    if "p1" in d:
        return Sufficient(*(f32(k) for k in ("p1", "pt1", "px", "error")))
    if "ak" in d:
        return FGTModel(centers=f32("centers"), ak=f32("ak"))
    if "points" in d:
        return Cloud(
            points=f32("points"),
            count=torch.tensor(np.asarray(d["count"], np.int32), device=device),
        )
    if "scale" in d:
        return RigidTransform(f32("rotation"), f32("translation"), f32("scale"))
    if "prev_target" in d:
        return HierState(
            prev_target=f32("prev_target"),
            warm=torch.tensor(bool(d["warm"]), device=device),
            sparse=torch.tensor(bool(d["sparse"]), device=device),
        )
    if "error" in d:
        return ICPResume(
            rotation=f32("rotation"),
            translation=f32("translation"),
            error=f32("error"),
            done_before=int(d.get("done_before", 0)),
            prev_error=f32("prev_error") if "prev_error" in d else None,
            nn=from_numpy_state(d["nn"], device) if "nn" in d else None,
        )
    raise ValueError(f"unrecognised state keys: {sorted(d)}")
