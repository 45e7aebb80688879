"""Named-stage wall-clock timer — same API as the reference's
``Common::Timer`` (``timer.h:13-33``, ``timer.cpp:5-75``): re-entrant
start/stop accumulation per stage in milliseconds, ``stage_timed_call``,
``get_stage_time``, ``print_results``.

A copy of ``tpuslam/harness/timer.py`` for torch: ``stage_timed_call``
fences with ``torch.cuda.synchronize`` on the CUDA devices of the
callable's result, where the original calls ``jax.block_until_ready``
(a host clock without a fence measures the enqueue); a result on the
CPU needs no fence.  ``profiled`` wraps ``torch.profiler.profile``
where the original wraps ``jax.profiler.trace``."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator

import torch


@dataclass
class StageProperties:
    """Mirrors ``timer.h:6-11``."""

    is_running: bool = False
    begin: float = 0.0
    milliseconds_elapsed: float = 0.0


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors in ``obj`` and in the tuples, lists and dicts it holds."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def fence(result: Any) -> None:
    """Wait for the work queued on every CUDA device ``result`` lies on."""
    for device in {t.device for t in _tensors(result) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    timer_name: str = "Timer"
    stages: Dict[str, StageProperties] = field(default_factory=dict)

    def add_stage(self, name: str) -> StageProperties:
        self.stages.setdefault(name, StageProperties())
        return self.stages[name]

    def start_stage(self, name: str) -> None:
        stage = self.add_stage(name)
        if not stage.is_running:
            stage.is_running = True
            stage.begin = time.perf_counter()

    def stop_stage(self, name: str) -> None:
        stage = self.stages.get(name)
        if stage is not None and stage.is_running:
            stage.is_running = False
            stage.milliseconds_elapsed += (
                time.perf_counter() - stage.begin
            ) * 1000.0

    def stage_timed_call(self, name: str, func: Callable[[], Any]) -> Any:
        """Run ``func`` under the stage clock, fencing device async work."""
        self.start_stage(name)
        try:
            result = func()
            fence(result)
        finally:
            self.stop_stage(name)
        return result

    def get_stage_time(self, name: str) -> int:
        """Accumulated whole milliseconds (the reference returns
        ``long long`` ms, ``timer.cpp:44-52``)."""
        stage = self.stages.get(name)
        return int(stage.milliseconds_elapsed) if stage else 0

    def profiled(self, log_dir: str):
        """Context manager wrapping ``torch.profiler.profile`` over the
        CPU and, where there is one, the card; the trace is written to
        ``log_dir`` for TensorBoard when the context exits."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        )

    def print_results(self) -> str:
        lines = [f"{self.timer_name} results:"]
        for name, stage in self.stages.items():
            lines.append(f"  {name}: {int(stage.milliseconds_elapsed)} ms")
        text = "\n".join(lines)
        print(text)
        return text
