"""Profiling & metrics.

The reference has no profiling subsystem (SURVEY.md section 5 — implicit
Unity Profiler only). Here: wall-clock counters around compiled steps,
derived domain metrics (ray-bounce intersections/s, IR build ms, streaming
xRT), and optional ``jax.profiler`` trace capture for device timelines.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


@dataclass
class Timer:
    """Accumulating wall-clock timer; ``block_until_ready`` is the caller's
    responsibility (pass a pytree to :meth:`stop` to sync on it)."""

    total_s: float = 0.0
    count: int = 0
    _t0: float = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync=None) -> float:
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return dt

    @property
    def mean_s(self) -> float:
        return self.total_s / max(1, self.count)


@contextlib.contextmanager
def timed(label: str, metrics: Optional["Metrics"] = None):
    t = Timer().start()
    yield t
    dt = t.stop()
    if metrics is not None:
        metrics.record(label + "_s", dt)


def ray_bounce_intersections(n_rays: int, max_bounces: int, n_walls: int,
                             nee: bool = True) -> int:
    """Intersection tests per trace frame: the nearest-hit pass is
    rays x bounces x walls; NEE occlusion adds the same again
    (BASELINE.md workload accounting)."""
    per = n_rays * max_bounces * n_walls
    return per * 2 if nee else per


@dataclass
class Metrics:
    """Structured metric log; dumps one JSON object per record (the
    observability channel the reference lacks)."""

    values: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, name: str, value: float) -> None:
        self.values.setdefault(name, []).append(float(value))

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.values.items() if v}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard-viewable) around a block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them —
    printed beside every device timing, since a card set below its
    maximum power limit runs slower under load."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
