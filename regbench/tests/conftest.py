"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``regbench/`` on ``sys.path``, and a copy of the benchmark cut to tiny
sizes that ``harness.run`` drives on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# one thread a test process: the tests run several processes at once
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"100k": [400], "4k-20k": [300, 500]}


def tiny_copy(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``regbench/`` under ``dest`` whose
    traffic is cut to a few hundred points and a few pairs; returns the
    copy's ``regbench``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = dest / "regbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TINY.items():
        f = bench / "traffic" / f"{name}.json"
        spec = json.loads(f.read_text())
        spec.update(sizes=sizes, pool_pairs_per_size=3, sync_registrations=1)
        f.write_text(json.dumps(spec))
    return bench


@pytest.fixture
def tiny_bench(tmp_path):
    return tiny_copy(tmp_path)
