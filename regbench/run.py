"""The benchmark of ``tpuslam_torch`` on one NVIDIA card: one run of one
cell of ``BENCHMARK.json``.

    python3 regbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port.  Prints the run's
result as the last line of standard output (one JSON object) and, as the
last lines of standard error, each number compared with the plain
reference beside its limit.  Exits with 1, printing no result, where
there is no card or fewer cards than the cell asks for, where the port
cannot be imported, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every build and kernel cache at a fixed path inside the checkout
BUILD = ROOT / "build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}", file=sys.stderr)
        return 1
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import tpuslam_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program under test cannot be imported: {exc!r}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(BENCH_DIR))
    import harness

    torch.set_num_threads(4)
    result = harness.run(BENCH_DIR, args.workload, args.seed, args.seconds, bool(args.trace),
                         T_START, torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
