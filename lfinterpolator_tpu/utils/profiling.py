"""Benchmark & profiling harness.

Replacement for the reference's CUDA-event Timer + 100-run loop
(reference: src/interpolator.cu:13-34, 271-295): warmup-excluded wall timing
around block_until_ready, optional jax.profiler traces, and throughput
reporting in output megapixels/gigapixels per second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax


@dataclasses.dataclass
class BenchResult:
    times_s: list[float]
    out_pixels: int

    @property
    def avg_ms(self) -> float:
        return 1000 * sum(self.times_s) / len(self.times_s)

    @property
    def min_ms(self) -> float:
        return 1000 * min(self.times_s)

    @property
    def gpixels_per_s(self) -> float:
        return self.out_pixels / min(self.times_s) / 1e9

    def to_dict(self) -> dict:
        return {
            "runs": len(self.times_s),
            "avg_ms": self.avg_ms,
            "min_ms": self.min_ms,
            "gpixels_per_s": self.gpixels_per_s,
        }


def benchmark(step, out_pixels: int, *, runs: int = 100, warmup: int = 3) -> BenchResult:
    """Time `step(i)` `runs` times (after `warmup` untimed calls).

    `step` accepts a run index and returns device arrays; each call is
    timed to block_until_ready.
    """
    for i in range(warmup):
        jax.block_until_ready(step(i))
    times = []
    for i in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(step(warmup + i))
        times.append(time.perf_counter() - t0)
    return BenchResult(times_s=times, out_pixels=out_pixels)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Context-manager wall timer.

    Register the device arrays produced inside the block with `sync()`;
    they are blocked on when the context exits (the JAX analogue of the
    reference's cudaEventSynchronize, src/interpolator.cu:22-31).
    """

    def __init__(self):
        self._arrays = []

    def sync(self, x):
        self._arrays.append(x)
        return x

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._arrays:
            jax.block_until_ready(self._arrays)
        self.elapsed_s = time.perf_counter() - self.t0
        return False
