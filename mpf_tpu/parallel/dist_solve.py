"""Distributed getrs + iterative refinement on block-cyclic factors.

[north-star addition — the reference stops at factorization; its harness
reconstructs P*L*U rather than solving (`benchmark.cpp:106-144`).  The
north star's accuracy story is IR at scale, which needs a mesh-sharded
solve.]

SPMD design (shard_map over the same (P, Q) mesh as `dist_lu`):

  * the right-hand side / solution vector stays **replicated** (O(n)
    state is negligible next to the O(n^2/PQ) tiles) — pivots are applied
    with one gather of the composed row map (`MPFResult.perm`), exactly
    like the single-device path (`models/solve.py`);
  * forward/backward substitution walk the nb diagonal blocks; per block
    the owner's (b, b) diagonal tile is replicated with one masked psum
    over both mesh axes, solved locally everywhere (replicated, so no
    result broadcast), and the <= n trailing updates are computed from the
    owning device column's local rows and combined with one more psum —
    2*nb collectives of b and n elements;
  * the IR residual is a distributed GEMV: every device multiplies its
    local tile by its columns' slice of x, scatters into global row
    positions, and one psum over both axes replicates the residual.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mpf_tpu.ops.blas3 import _mm_precision
from mpf_tpu.parallel.mesh import ROW_AXIS, COL_AXIS
from mpf_tpu.parallel.block_cyclic import (
    check_dims,
    local_row_indices,
    local_col_indices,
)

_BOTH = (ROW_AXIS, COL_AXIS)


def _replicate_diag_block(aloc, k, b, gp, gq, pp, qq):
    """Masked psum of the (k, k) diagonal block from its owner."""
    blk = jax.lax.dynamic_slice(aloc, ((k // gp) * b, (k // gq) * b), (b, b))
    blk = jnp.where((pp == k % gp) & (qq == k % gq), blk, jnp.zeros_like(blk))
    return jax.lax.psum(blk, _BOTH)


def _scatter_rows(v, grows, n):
    """Local (H,) values -> (n,) global positions (zeros elsewhere)."""
    return jnp.zeros((n,), v.dtype).at[grows].set(v)


def _dist_getrs_local(tile, perm, rhs, *, n, b, gp, gq, nb, unit_only=False):
    aloc = tile[0, 0]
    h, w = aloc.shape
    pp = jax.lax.axis_index(ROW_AXIS)
    qq = jax.lax.axis_index(COL_AXIS)
    grows = local_row_indices(h, b, gp, pp)
    gcols = local_col_indices(w, b, gq, qq)
    fprec = _mm_precision(aloc)

    x = jnp.take(rhs, perm)  # pivots: ONE gather of the composed row map

    def fwd(k, x):
        off = k * b
        lkk = _replicate_diag_block(aloc, k, b, gp, gq, pp, qq)
        xk = jax.lax.dynamic_slice(x, (off,), (b,))
        yk = jax.lax.linalg.triangular_solve(
            lkk, xk[:, None], left_side=True, lower=True, unit_diagonal=True
        )[:, 0]
        # trailing update from the owning device column's local rows
        colk = jax.lax.dynamic_slice(aloc, (0, (k // gq) * b), (h, b))
        contrib = jnp.dot(colk, yk, preferred_element_type=jnp.float32,
                          precision=fprec).astype(x.dtype)
        contrib = jnp.where((qq == k % gq) & (grows >= off + b), contrib, 0)
        upd = jax.lax.psum(_scatter_rows(contrib, grows, n), _BOTH)
        x = x - upd
        return jax.lax.dynamic_update_slice(x, yk, (off,))

    y = jax.lax.fori_loop(0, nb, fwd, x)
    if unit_only:
        return y

    def bwd(t, x):
        k = nb - 1 - t
        off = k * b
        ukk = _replicate_diag_block(aloc, k, b, gp, gq, pp, qq)
        xk = jax.lax.dynamic_slice(x, (off,), (b,))
        yk = jax.lax.linalg.triangular_solve(
            ukk, xk[:, None], left_side=True, lower=False
        )[:, 0]
        colk = jax.lax.dynamic_slice(aloc, (0, (k // gq) * b), (h, b))
        contrib = jnp.dot(colk, yk, preferred_element_type=jnp.float32,
                          precision=fprec).astype(x.dtype)
        contrib = jnp.where((qq == k % gq) & (grows < off), contrib, 0)
        upd = jax.lax.psum(_scatter_rows(contrib, grows, n), _BOTH)
        x = x - upd
        return jax.lax.dynamic_update_slice(x, yk, (off,))

    return jax.lax.fori_loop(0, nb, bwd, y)


def _dist_matvec_local(aloc, x, grows, gcols, n):
    """Distributed GEMV: (n,) replicated -> (n,) replicated A @ x."""
    fprec = _mm_precision(aloc)
    v = jnp.dot(aloc, jnp.take(x, gcols), preferred_element_type=jnp.float32,
                precision=fprec).astype(x.dtype)
    return jax.lax.psum(_scatter_rows(v, grows, n), _BOTH)


def make_dist_getrs(n: int, b: int, mesh):
    """Jitted SPMD solve on block-cyclic packed factors.

    Returns ``fn(tiles_lu, perm, rhs) -> x`` with ``perm`` the composed row
    map (``MPFResult.perm``) and ``rhs``/``x`` replicated (n,) vectors."""
    gp, gq = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    nb = check_dims(n, b, gp, gq)
    body = functools.partial(_dist_getrs_local, n=n, b=b, gp=gp, gq=gq, nb=nb)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ROW_AXIS, COL_AXIS, None, None), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def _dist_ir_local(tile_a, tile_lu, perm, rhs, *, n, b, gp, gq, nb, sweeps):
    aloc = tile_a[0, 0]
    h, w = aloc.shape
    pp = jax.lax.axis_index(ROW_AXIS)
    qq = jax.lax.axis_index(COL_AXIS)
    grows = local_row_indices(h, b, gp, pp)
    gcols = local_col_indices(w, b, gq, qq)

    solve = functools.partial(
        _dist_getrs_local, tile_lu, perm, n=n, b=b, gp=gp, gq=gq, nb=nb
    )
    x = solve(rhs)

    def sweep(_, x):
        r = rhs - _dist_matvec_local(aloc, x, grows, gcols, n)
        return x + solve(r)

    x = jax.lax.fori_loop(0, sweeps, sweep, x)
    # final residual norms for convergence reporting (replicated scalars)
    r = rhs - _dist_matvec_local(aloc, x, grows, gcols, n)
    return x, jnp.linalg.norm(r), jnp.linalg.norm(rhs)


def make_dist_ir_solve(n: int, b: int, mesh, sweeps: int = 3):
    """Jitted SPMD factor-backed solve with Richardson iterative refinement
    (HPL-AI flow at distributed scale).

    Returns ``fn(tiles_a, tiles_lu, perm, rhs) -> (x, |r|, |rhs|)``."""
    gp, gq = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    nb = check_dims(n, b, gp, gq)
    body = functools.partial(
        _dist_ir_local, n=n, b=b, gp=gp, gq=gq, nb=nb, sweeps=sweeps
    )
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(ROW_AXIS, COL_AXIS, None, None),
            P(ROW_AXIS, COL_AXIS, None, None),
            P(),
            P(),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def dist_solve(a, mesh, b: int = 128, policy=None, sweeps: int = 3):
    """Convenience end-to-end: distribute, factor, IR-solve.  ``a`` is the
    global (n, n) matrix; returns (x, backward_error_proxy |r|/|rhs|)."""
    from mpf_tpu.precision import MPF_BF16
    from mpf_tpu.parallel.block_cyclic import to_block_cyclic
    from mpf_tpu.parallel.dist_lu import make_dist_lu

    policy = policy or MPF_BF16
    n = a.shape[0]
    gp, gq = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    tiles = to_block_cyclic(jnp.asarray(a, policy.working), gp, gq, b)
    lu_fn = make_dist_lu(n, b, mesh, policy)
    tiles_lu, ipiv, info, perm = lu_fn(tiles)
    ir_fn = make_dist_ir_solve(n, b, mesh, sweeps=sweeps)
    rhs = jnp.ones((n,), policy.working)
    x, rn, bn = ir_fn(tiles, tiles_lu, perm, rhs)
    return x, rn / bn
