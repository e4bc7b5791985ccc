"""Tracing and per-stage profiling hooks.

The reference's only instrumentation is the LSD ``elapsed_time``
microsecond counter (reference: src_cpp/lsd.hpp:687,766-775) plus the
Monte-Carlo harness printing iterations/s (python_test/test_qcodes.py:
73-90). On this stack the interesting questions are device-side — which
fused kernel dominates, whether the host link is the bottleneck — so the
hooks wrap the JAX profiler:

- :func:`trace` — capture a TensorBoard/XProf device trace of a code
  region (kernel timeline, memory traffic, collectives).
- :func:`annotate` — name a region so it is attributable in the trace.
- :class:`StageTimer` — host-side per-stage wall-clock breakdown with
  ``block_until_ready`` fencing, for quick "where did the time go"
  reports without a full trace.
- :func:`profile_decode` — one-call breakdown of a decoder's
  ``decode_batch`` path (transfer vs compute vs postprocess).
"""

import contextlib
import time
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a JAX device trace of the enclosed region.

    View with TensorBoard (``tensorboard --logdir <log_dir>``) or the
    generated perfetto link. Wraps ``jax.profiler.trace``; safe on any
    backend.
    """
    with jax.profiler.trace(
        log_dir, create_perfetto_link=create_perfetto_link
    ):
        yield


def annotate(name: str):
    """Name a region for the device trace (``TraceAnnotation``)."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Per-stage wall-clock breakdown with device fencing.

    >>> t = StageTimer()
    >>> with t.stage("bp"):
    ...     out = bp_fn(syndromes, llr)   # async-dispatched
    >>> t.report()                        # {'bp': 0.0123, ...}

    Each ``stage`` exit calls ``jax.block_until_ready`` on nothing —
    i.e. it fences by ``jax.effects_barrier()`` — so queued device work
    is charged to the stage that launched it. Pass the stage's output to
    :meth:`fence` for precise accounting of a specific array.
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, fence_output: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence_output:
                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def fence(self, value):
        """Block on ``value`` inside a stage for exact device timing."""
        return jax.block_until_ready(value)

    def report(self) -> Dict[str, float]:
        return dict(self.times)

    def pretty(self) -> str:
        total = sum(self.times.values()) or 1.0
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:<24s} {dt * 1e3:10.2f} ms  {100 * dt / total:5.1f}%"
            f"  (x{self.counts[name]})"
            for name, dt in rows
        )


def profile_decode(
    decoder,
    syndromes,
    *,
    repeats: int = 3,
    log_dir: Optional[str] = None,
) -> Dict[str, float]:
    """Per-stage breakdown of a decoder's ``decode_batch`` path.

    Stages: ``compile`` (first call, includes XLA compilation),
    ``decode`` (median of ``repeats`` steady-state calls, including
    host<->device transfers). With ``log_dir`` set, the steady-state
    calls also emit a device trace there.
    """
    import numpy as np

    timer = StageTimer()
    with timer.stage("compile"):
        out = decoder.decode_batch(syndromes)
        timer.fence(out) if hasattr(out, "block_until_ready") else None

    ctx = trace(log_dir) if log_dir else contextlib.nullcontext()
    laps = []
    with ctx:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            with annotate("decode_batch"):
                decoder.decode_batch(syndromes)
            laps.append(time.perf_counter() - t0)
    laps.sort()
    med = laps[len(laps) // 2]
    report = timer.report()
    report["decode"] = med
    report["syndromes_per_sec"] = float(np.shape(syndromes)[0]) / med
    return report
