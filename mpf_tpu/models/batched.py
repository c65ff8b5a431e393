"""Batched LU factorizations (north-star addition, BASELINE.json config 5:
4096 x 256^2 batched LUs).

The blocked driver uses only static shapes and functional updates, so it is
directly ``jax.vmap``-compatible; the batch axis can additionally be sharded
across a device mesh for data-parallel batched factorization (see
``mpf_tpu.parallel``).
"""

from __future__ import annotations

import functools

import jax

from mpf_tpu.precision import PrecisionPolicy, MPF_BF16
from mpf_tpu.models.mpf import mpf_factorize_traced, MPFResult
from mpf_tpu.ops.getf2 import panel_pivots_perm


@functools.partial(jax.jit, static_argnames=("r", "policy", "pivot"))
def batched_factorize(
    a: jax.Array,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
) -> MPFResult:
    """Factor a (batch, n, n) stack of matrices.  Returns stacked MPFResult.

    The blocked driver runs under ``vmap``.  Its pivot panel is the jnp
    version: the CUDA panel kernel factors one panel per launch and has no
    batched form.  Throughput at scale comes from the batch axis itself:
    :func:`batched_factorize_dp` shards it over a mesh.
    """
    fn = lambda m: mpf_factorize_traced(m, r=r, policy=policy, pivot=pivot,
                                        panel_kernel=panel_pivots_perm)
    return jax.vmap(fn)(a)


def batched_factorize_dp(
    a: jax.Array,
    mesh=None,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
) -> MPFResult:
    """Data-parallel batched LU: shard the batch axis across the mesh.

    BASELINE config 5's scaling axis (4096 independent 256^2 LUs): each
    device factors batch/n_devices matrices with ZERO communication — every
    op in the vmapped driver is batch-pointwise, so XLA partitions the whole
    computation along the batch dimension from the input sharding alone.
    ``mesh`` defaults to a 1D mesh over all visible devices (axis "dp");
    a 2D (p, q) mesh from :func:`mpf_tpu.parallel.make_mesh` also works —
    the batch axis is sharded over ALL its axes."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    if mesh is None:
        import numpy as np

        mesh = Mesh(np.array(jax.devices()), ("dp",))
    axes = tuple(mesh.axis_names)
    bsz = a.shape[0]
    if bsz % mesh.devices.size:
        raise ValueError(
            f"batch {bsz} not divisible by {mesh.devices.size} devices")
    a = jax.device_put(a, NamedSharding(mesh, PartitionSpec(axes)))
    return batched_factorize(a, r=r, policy=policy, pivot=pivot)


@functools.partial(jax.jit, static_argnames=("r", "policy", "sweeps"))
def batched_solve(a: jax.Array, b: jax.Array, r: int = 128,
                  policy: PrecisionPolicy = MPF_BF16, sweeps: int = 2):
    """Factor + IR-solve a (batch, n, n) stack against (batch, n) RHS."""
    from mpf_tpu.models.refine import ir_solve

    def one(m, rhs):
        res = mpf_factorize_traced(m, r=r, policy=policy, pivot=True,
                                   panel_kernel=panel_pivots_perm)
        # pass the composed perm: without it every getrs inside the IR loop
        # re-derives it from ipiv via an O(n) sequential fori_loop
        return ir_solve(m.astype(policy.working), res.lu, res.ipiv, rhs,
                        sweeps=sweeps, perm=res.perm).x

    return jax.vmap(one)(a, b)
