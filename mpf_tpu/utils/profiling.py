"""Profiling helpers (aux-subsystem parity, SURVEY.md section 5: the
reference has only chrono wall-clock timers, `benchmark.cpp:219-222`; the
equivalent here is `jax.profiler` device traces + derived TFLOP/s)."""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str = "/tmp/mpf_tpu_trace"):
    """Capture a jax.profiler device trace around a block:

        with profiling.trace("/tmp/t"):
            fac(a)   # view in TensorBoard / xprof
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
