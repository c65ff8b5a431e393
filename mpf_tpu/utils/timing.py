"""Timing / throughput helpers (reference: chrono wall-clock around MPF and
dgetrf, `benchmark.cpp:219-242`).

Every timed call ends in ``jax.block_until_ready`` on its result: JAX
dispatches asynchronously, so a clock read without it measures the enqueue.
The first call of a new shape compiles; it is left out of the timed runs
(set-up time).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


def lu_flops(n: int) -> float:
    """Canonical LU flop count 2n^3/3 (BASELINE.json metric)."""
    return 2.0 * n**3 / 3.0


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            setup: Callable | None = None) -> float:
    """Median wall-clock seconds of ``fn(*args)`` over ``iters`` runs, after
    ``warmup`` untimed calls (the first one compiles).

    ``setup``: called before each run, untimed, to make fresh arguments
    (its result replaces ``args``) — for functions that donate their input.
    """
    def once():
        call_args = args if setup is None else jax.block_until_ready(setup())
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*call_args))
        return time.perf_counter() - t0

    for _ in range(warmup):
        once()
    return statistics.median([once() for _ in range(iters)])


def tflops(n: int, seconds: float) -> float:
    return lu_flops(n) / seconds / 1e12
