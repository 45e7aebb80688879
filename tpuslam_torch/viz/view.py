"""Point-cloud visualization — the capability equivalent of the
reference's OpenGL renderer (``renderer.h:23-114``, ~2300 LoC of
GLFW/instanced-icosphere machinery, SURVEY §2.5 "out-of-scope for v1
kernels") as a matplotlib 3-D scatter with the same cloud coloring:
before = red, after = green, transformed = yellow (``renderer.cpp``
cloud color assignment), driven by the same ``show-visualisation`` config
flag.

Headless environments (no DISPLAY) save ``registration.png`` instead of
opening a window.

A copy of ``tpuslam/viz/view.py``.  matplotlib is imported when a
figure is drawn, never at import; where it is not installed,
``show_registration`` says so on stderr and returns None, so that a
registration run with ``show-visualisation`` still ends (the WebGL
export of ``viz/webgl.py`` needs no matplotlib).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

MAX_POINTS_DRAWN = 20000  # subsample large clouds for responsiveness


def _sub(cloud: np.ndarray) -> np.ndarray:
    if len(cloud) <= MAX_POINTS_DRAWN:
        return cloud
    step = len(cloud) // MAX_POINTS_DRAWN + 1
    return cloud[::step]


def show_registration(
    before: np.ndarray,
    after: np.ndarray,
    transformed: Optional[np.ndarray] = None,
    origin: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    show: Optional[bool] = None,
) -> Optional[str]:
    """Render the three clouds; returns the saved path when headless,
    None when shown in a window or when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no registration plot drawn",
              file=sys.stderr)
        return None

    headless = not os.environ.get("DISPLAY")
    if show is None:
        show = not headless
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(111, projection="3d")
    # the reference renderer's 4 toggleable clouds (renderer.h:26-37):
    # before=red, after=green, transformed=yellow, + origin markers
    for cloud, color, label in (
        (before, "red", "before"),
        (after, "green", "after"),
        (transformed, "gold", "transformed"),
        (origin, "blue", "origin"),
    ):
        if cloud is None or len(cloud) == 0:
            continue
        pts = _sub(np.asarray(cloud))
        ax.scatter(
            pts[:, 0], pts[:, 1], pts[:, 2],
            c=color, s=1.5, alpha=0.6, label=label,
        )
    ax.legend(loc="upper right")
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout()

    if show:
        plt.show()
        return None
    path = save_path or "registration.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"Visualization saved to {path}")
    return path
