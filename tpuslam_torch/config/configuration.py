"""Configuration struct mirroring the reference's JSON config contract.

A verbatim copy of ``tpuslam/config/configuration.py``.  It is copied,
not imported: importing any ``tpuslam`` module runs
``tpuslam/__init__.py``, which imports JAX, and the port must run where
JAX is not installed.  ``tests/test_torch_types.py`` pins this copy to
the original (same fields, defaults and enum values).

Field names, defaults and semantics follow the *parser* (the executable
truth, ``configparser.cpp:192-257``), resolving the documented quirks:

* ``cpd-const-scale`` struct default is true but the parser overwrites with
  default **false** (``configparser.cpp:240``) — effective default false.
* ``cpd-weight`` is parsed twice with the same default 0.3
  (``configparser.cpp:212,238``) — harmless, default 0.3.
* The parser reads ``rotation-range`` (not the schema's ``angle-range``,
  ``configparser.cpp:170-177``).
* An unknown ``approximation-type`` silently falls back to ``hybrid``
  (``configparser.cpp:214-230``); unknown ``method``/``policy`` are errors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


class ComputationMethod(enum.Enum):
    """Mirrors ``enumerators.h:5-11``."""

    Icp = "icp"
    NoniterativeIcp = "nicp"
    Cpd = "cpd"


class ExecutionPolicy(enum.Enum):
    """Mirrors ``enumerators.h:13-17``.  On TPU there is a single
    implementation per algorithm; the policy is accepted for config
    compatibility and recorded, but does not select a different backend."""

    Sequential = "sequential"
    Parallel = "parallel"


class ApproximationType(enum.Enum):
    """Mirrors ``enumerators.h:19-23``."""

    NONE = "none"
    Full = "full"
    Hybrid = "hybrid"


@dataclass
class Configuration:
    """Mirrors ``configuration.h:7-45`` with parser-truth defaults."""

    # required parameters
    computation_method: ComputationMethod = ComputationMethod.Icp
    before_path: str = ""
    after_path: str = ""

    # optional parameters (None == std::nullopt)
    execution_policy: Optional[ExecutionPolicy] = None
    # (rotation 3x3 row-major ndarray — already scale-multiplied, translation 3-vec)
    transformation: Optional[Tuple[np.ndarray, np.ndarray]] = None
    # (rotation range [rad], translation range) — ``configparser.cpp:182``
    transformation_parameters: Optional[Tuple[float, float]] = None
    max_iterations: Optional[int] = None
    cloud_before_resize: Optional[int] = None
    cloud_after_resize: Optional[int] = None
    cloud_spread: Optional[float] = None
    random_seed: Optional[int] = None
    noise_affected_points_before: Optional[float] = None
    noise_affected_points_after: Optional[float] = None

    # optional parameters with default values (parser truth)
    show_visualisation: bool = False
    max_distance_squared: float = 1000.0
    approximation_type: ApproximationType = ApproximationType.Hybrid
    nicp_batch_size: int = 16
    nicp_iterations: int = 32
    nicp_subcloud_size: int = 1000
    cpd_weight: float = 0.3
    cpd_const_scale: bool = False  # parser default wins (configparser.cpp:240)
    cpd_tolerance: float = 1e-3
    convergence_epsilon: float = 1e-3
    noise_intensity_before: float = 0.1
    noise_intensity_after: float = 0.1
    additional_outliers_before: int = 0
    additional_outliers_after: int = 0
    ratio_of_far_field: float = 10.0  # fgt-ratio-of-far-field
    order_of_truncation: int = 8  # fgt-order-of-truncation
    # extension (not in the reference config contract): tri-state pick
    # of the CPD full/hybrid fast-phase E-step.  None (default) = auto,
    # the measured size crossover (cpd.CPD_FGT_CROSSOVER: exact blocked
    # kernel below it, device FGT at/above it); true/false force one arm
    cpd_use_fgt: Optional[bool] = None
    # extension: start CPD EM from the centroid-difference translation
    # (rescues free-scale mode at large translations; see cpd_register)
    cpd_centroid_init: bool = False
    # extension: seed the ICP loop with a one-shot NICP estimate
    # (rescues large-motion cases; see icp_register_prealigned)
    icp_prealign: bool = False
    # extension: write the transformed BEFORE cloud here after
    # registration (.obj / .off, tpuslam.data.writer) — the reference
    # only prints the transform
    save_output_path: Optional[str] = None
    # extension: NICP in-plane candidate widening on (near-)degenerate
    # inertia spectra (rotationally symmetric clouds).  None = auto
    # (host-side eigengap pre-pass picks the axes; 16 angles),
    # 0 = off, N > 1 = force N angles per degenerate axis.  See
    # tpuslam.algorithms.nicp.degenerate_axes_for.
    nicp_degenerate_widening: Optional[int] = None

    def print(self) -> str:
        """Config echo in the spirit of ``configuration.cpp:4-114``."""
        lines = [
            f"method: {self.computation_method.value}",
            f"before-path: {self.before_path}",
            f"after-path: {self.after_path}",
        ]
        if self.execution_policy is not None:
            lines.append(f"policy: {self.execution_policy.value}")
        if self.transformation is not None:
            rot, trans = self.transformation
            lines.append(f"rotation: {np.asarray(rot).reshape(-1).tolist()}")
            lines.append(f"translation: {np.asarray(trans).reshape(-1).tolist()}")
        if self.transformation_parameters is not None:
            rr, tr = self.transformation_parameters
            lines.append(f"rotation-range: {rr}")
            lines.append(f"translation-range: {tr}")
        for name, val in [
            ("max-iterations", self.max_iterations),
            ("cloud-before-resize", self.cloud_before_resize),
            ("cloud-after-resize", self.cloud_after_resize),
            ("cloud-spread", self.cloud_spread),
            ("random-seed", self.random_seed),
            ("noise-affected-points-before", self.noise_affected_points_before),
            ("noise-affected-points-after", self.noise_affected_points_after),
        ]:
            if val is not None:
                lines.append(f"{name}: {val}")
        lines += [
            f"show-visualisation: {str(self.show_visualisation).lower()}",
            f"max-distance-squared: {self.max_distance_squared}",
            f"approximation-type: {self.approximation_type.value}",
            f"nicp-batch-size: {self.nicp_batch_size}",
            f"nicp-iterations: {self.nicp_iterations}",
            f"nicp-subcloud-size: {self.nicp_subcloud_size}",
            f"cpd-weight: {self.cpd_weight}",
            f"cpd-const-scale: {str(self.cpd_const_scale).lower()}",
            f"cpd-tolerance: {self.cpd_tolerance}",
            f"convergence-epsilon: {self.convergence_epsilon}",
            f"noise-intensity-before: {self.noise_intensity_before}",
            f"noise-intensity-after: {self.noise_intensity_after}",
            f"additional-outliers-before: {self.additional_outliers_before}",
            f"additional-outliers-after: {self.additional_outliers_after}",
            f"fgt-ratio-of-far-field: {self.ratio_of_far_field}",
            f"fgt-order-of-truncation: {self.order_of_truncation}",
            f"cpd-use-fgt: "
            f"{'auto' if self.cpd_use_fgt is None else str(self.cpd_use_fgt).lower()}",
            f"cpd-centroid-init: {str(self.cpd_centroid_init).lower()}",
            f"icp-prealign: {str(self.icp_prealign).lower()}",
            f"save-output-path: {self.save_output_path}",
            f"nicp-degenerate-widening: "
            f"{'auto' if self.nicp_degenerate_widening is None else self.nicp_degenerate_widening}",
        ]
        text = "\n".join(lines)
        print(text)
        return text
