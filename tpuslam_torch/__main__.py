"""``python -m tpuslam_torch`` — the port's executable entry, as
``python -m tpuslam`` is the JAX package's (``tpuslam/__main__.py``)."""

import sys

from tpuslam_torch.harness.cli import main

if __name__ == "__main__":
    sys.exit(main())
