"""Performance instrumentation: FPS window, rays/sec, step timing.

Capability parity with the reference's ``FpsCounter`` (src/main.rs:484-513:
8-frame sliding-window average shown in the UI) plus the throughput metrics
the reference lacks (SURVEY.md §5 tracing/profiling gap): rays/sec,
seconds-to-N-spp, and optional jax.profiler trace capture.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Deque, Iterator, Optional


class FpsCounter:
    """Sliding-window FPS (reference main.rs:484-513; window = 8 frames)."""

    def __init__(self, window: int = 8):
        self._deltas: Deque[float] = collections.deque(maxlen=window)

    def update(self, delta_seconds: float) -> None:
        self._deltas.append(delta_seconds)

    def average_fps(self) -> float:
        if not self._deltas:
            return 0.0
        mean = sum(self._deltas) / len(self._deltas)
        return 1.0 / mean if mean > 0 else 0.0


@dataclasses.dataclass
class StepTimer:
    """Accumulates device-step wall times and derives throughput."""

    rays_per_step: int
    times: list = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def total_seconds(self) -> float:
        return sum(self.times)

    @property
    def best_rays_per_sec(self) -> float:
        return self.rays_per_step / min(self.times) if self.times else 0.0

    @property
    def mean_rays_per_sec(self) -> float:
        return (
            self.rays_per_step * len(self.times) / self.total_seconds
            if self.times
            else 0.0
        )


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace when log_dir is set (else no-op)."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


class NoGpuError(RuntimeError):
    """A measurement was asked for on a machine where JAX finds no GPU."""


def require_gpu() -> None:
    """Raise NoGpuError unless JAX's default backend is a GPU. Timings
    are device metrics: a measurement never falls back to the CPU."""
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        raise NoGpuError(f"no GPU: JAX's default backend is {platform!r}")


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a
    card set below its maximum power runs slower under load, so every
    number is kept beside this line)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_stamp(backend: str) -> dict:
    """Fields that name the device every benchmark line ran on."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power_limit(),
        "backend": backend,
    }
