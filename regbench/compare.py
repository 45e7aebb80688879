"""The numbers that decide ``correct``: a registration's result against the
plain reference's on the same pair, each held to its limit.

A result is ``(R f[3,3], t f[3], iterations, error)``.  The numbers:

* ``rot_deg``: the angle of ``R_program R_reference^T`` in degrees
  (taken as ``2 asin(|R_p - R_r|_F / (2 sqrt 2))``, exact near 0);
* ``trans``: ``|t_program - t_reference|``, in the clouds' units;
* ``error_rel``: ``|e_program - e_reference| / |e_reference|``;
* ``iters``: ``|iterations_program - iterations_reference|``.

Over the registrations a run checks, each number is the worst one.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("rot_deg", "trans", "error_rel", "iters")


def numbers(program, reference) -> dict:
    r_p, t_p, i_p, e_p = program
    r_r, t_r, i_r, e_r = reference
    r_p, r_r = np.asarray(r_p, np.float64), np.asarray(r_r, np.float64)
    gap = np.linalg.norm(r_p - r_r) / (2.0 * math.sqrt(2.0))
    return {
        "rot_deg": math.degrees(2.0 * math.asin(min(1.0, gap))),
        "trans": float(np.linalg.norm(np.asarray(t_p, np.float64) - np.asarray(t_r, np.float64))),
        "error_rel": abs(float(e_p) - float(e_r)) / max(abs(float(e_r)), 1e-30),
        "iters": float(abs(int(i_p) - int(i_r))),
    }


def worst(rows: list) -> dict:
    """Each number's largest value over ``rows`` (NaN counts as largest)."""
    out = {}
    for name in NUMBERS:
        vals = [r[name] for r in rows]
        out[name] = float("nan") if any(v != v for v in vals) else max(vals)
    return out


def held(readings: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for each number with a limit."""
    return {name: {"value": readings[name], "limit": float(limit)}
            for name, limit in limits.items()}


def passes(checks: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
