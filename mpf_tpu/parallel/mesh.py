"""Device mesh construction and capability probe.

Analogue of the reference's `check_cooperative_groups.cu:4-48`
probe (which enumerates devices and checks cooperative-launch support): here
we enumerate JAX devices, report platform/memory, and construct the 2D
process mesh used by the block-cyclic distributed LU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


ROW_AXIS = "p"  # process-grid rows (distributes matrix block-rows)
COL_AXIS = "q"  # process-grid cols (distributes matrix block-cols)


def choose_grid(n_devices: int) -> Tuple[int, int]:
    """Pick the most-square (P, Q) process grid with P*Q = n_devices."""
    best = (1, n_devices)
    p = int(np.sqrt(n_devices))
    while p >= 1:
        if n_devices % p == 0:
            best = (p, n_devices // p)
            break
        p -= 1
    return best


def make_mesh(shape: Tuple[int, int] | None = None, devices: Sequence | None = None) -> Mesh:
    """2D mesh over the available devices with axes (ROW_AXIS, COL_AXIS)."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = choose_grid(len(devices))
    p, q = shape
    if p * q != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(np.array(devices).reshape(p, q), (ROW_AXIS, COL_AXIS))


def device_report(verbose: bool = True) -> dict:
    """Enumerate devices and their capabilities (probe CLI backing)."""
    devs = jax.devices()
    rows = []
    for d in devs:
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        rows.append(
            {
                "id": d.id,
                "platform": d.platform,
                "kind": getattr(d, "device_kind", "?"),
                "process": d.process_index,
                "hbm_bytes_limit": stats.get("bytes_limit"),
            }
        )
    grid = choose_grid(len(devs))
    report = {
        "backend": jax.default_backend(),
        "num_devices": len(devs),
        "suggested_mesh": {"p": grid[0], "q": grid[1]},
        "devices": rows,
    }
    if verbose:
        print(f"backend={report['backend']} devices={report['num_devices']} "
              f"mesh={grid[0]}x{grid[1]}")
        for r in rows:
            print(f"  device {r['id']}: {r['platform']}/{r['kind']} "
                  f"process={r['process']} hbm_limit={r['hbm_bytes_limit']}")
    return report
