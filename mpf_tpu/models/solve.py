"""Triangular solves on the packed factors (getrs).

The reference stops at the factorization (its oracle reconstructs P*L*U,
`benchmark.cpp:106-144`); the solve path is required by the north star's
iterative refinement.  LAPACK getrs conventions: apply the ipiv swaps to the
right-hand side, then L (unit lower) and U solves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mpf_tpu.ops.pivoting import apply_row_swaps_vector


def _as_matrix(b):
    if b.ndim == 1:
        return b[:, None], True
    return b, False


# Above this size the two full-matrix triangular_solve calls are replaced by
# blocked substitution, which reads each triangle once (~n^2/2 elements per
# triangle) with only (nb, nb) triangular solves on the diagonal blocks.
# Which of the two is faster on the H100 is not measured yet.
_BLOCKED_SOLVE_MIN = 32768
_SOLVE_NB = 2048
# the off-diagonal products run in the working precision (fp32), never TF32
_HI = jax.lax.Precision.HIGHEST


def _blocked_substitution(lu, b, nb: int):
    """Forward (unit-lower) then backward (upper) blocked substitution.
    The block loop is unrolled at trace time (static shapes, n/nb <= 32
    iterations at the headline sizes)."""
    n = lu.shape[0]
    y = jnp.zeros_like(b)
    for i in range(0, n, nb):
        rhs = b[i:i + nb]
        if i:
            rhs = rhs - jnp.dot(lu[i:i + nb, :i], y[:i], precision=_HI)
        yi = jax.lax.linalg.triangular_solve(
            lu[i:i + nb, i:i + nb], rhs, left_side=True, lower=True,
            unit_diagonal=True,
        )
        y = jax.lax.dynamic_update_slice(y, yi, (i, 0))
    x = jnp.zeros_like(b)
    for i in range(n - nb, -1, -nb):
        rhs = y[i:i + nb]
        if i + nb < n:
            rhs = rhs - jnp.dot(lu[i:i + nb, i + nb:], x[i + nb:], precision=_HI)
        xi = jax.lax.linalg.triangular_solve(
            lu[i:i + nb, i:i + nb], rhs, left_side=True, lower=False,
        )
        x = jax.lax.dynamic_update_slice(x, xi, (i, 0))
    return x


def _blocked_substitution_t(lu, b, nb: int):
    """Transpose solve A^T x = P^T L^-T U^-T b on the packed factors:
    forward pass with U^T (non-unit lower) then backward with L^T (unit
    upper).  Off-diagonal GEMMs read the SAME upper/lower triangles as the
    forward solve, transposed at the contraction."""
    n = lu.shape[0]
    y = jnp.zeros_like(b)
    for i in range(0, n, nb):
        rhs = b[i:i + nb]
        if i:
            # U^T[i:i+nb, :i] = U[:i, i:i+nb]^T
            rhs = rhs - jnp.dot(lu[:i, i:i + nb].T, y[:i], precision=_HI)
        yi = jax.lax.linalg.triangular_solve(
            lu[i:i + nb, i:i + nb], rhs, left_side=True, lower=False,
            transpose_a=True,
        )
        y = jax.lax.dynamic_update_slice(y, yi, (i, 0))
    x = jnp.zeros_like(b)
    for i in range(n - nb, -1, -nb):
        rhs = y[i:i + nb]
        if i + nb < n:
            # L^T[i:i+nb, i+nb:] = L[i+nb:, i:i+nb]^T
            rhs = rhs - jnp.dot(lu[i + nb:, i:i + nb].T, x[i + nb:], precision=_HI)
        xi = jax.lax.linalg.triangular_solve(
            lu[i:i + nb, i:i + nb], rhs, left_side=True, lower=True,
            unit_diagonal=True, transpose_a=True,
        )
        x = jax.lax.dynamic_update_slice(x, xi, (i, 0))
    return x


@functools.partial(jax.jit, static_argnames=("trans",))
def getrs(
    lu: jax.Array, ipiv: jax.Array, b: jax.Array,
    perm: jax.Array | None = None, trans: bool = False,
) -> jax.Array:
    """Solve A x = b (or A^T x = b with ``trans=True``, LAPACK getrs TRANS)
    given the packed LU and 1-based global ipiv.

    Pass ``perm`` (``MPFResult.perm``, the composed row map) to apply the
    pivots with one gather; without it the map is recomposed from ipiv
    first (O(n) scalar swaps).  With PA = LU: the forward solve permutes b
    then substitutes L, U; the transpose solve substitutes U^T, L^T then
    applies the INVERSE permutation (x = P^-1 z, one scatter)."""
    from mpf_tpu.ops.pivoting import ipiv_to_perm

    b, was_vec = _as_matrix(b)
    n = lu.shape[0]
    blocked = n >= _BLOCKED_SOLVE_MIN and n % _SOLVE_NB == 0
    if not trans:
        b = apply_row_swaps_vector(b, ipiv, perm)
        if blocked:
            x = _blocked_substitution(lu, b, _SOLVE_NB)
        else:
            y = jax.lax.linalg.triangular_solve(
                lu, b, left_side=True, lower=True, unit_diagonal=True
            )
            x = jax.lax.linalg.triangular_solve(
                lu, y, left_side=True, lower=False)
    else:
        if blocked:
            z = _blocked_substitution_t(lu, b, _SOLVE_NB)
        else:
            y = jax.lax.linalg.triangular_solve(
                lu, b, left_side=True, lower=False, transpose_a=True
            )
            z = jax.lax.linalg.triangular_solve(
                lu, y, left_side=True, lower=True, unit_diagonal=True,
                transpose_a=True,
            )
        if perm is None:
            perm = ipiv_to_perm(ipiv)
        x = jnp.zeros_like(z).at[perm].set(z)
    return x[:, 0] if was_vec else x


@jax.jit
def lu_solve(
    lu: jax.Array, ipiv: jax.Array, b: jax.Array, perm: jax.Array | None = None
) -> jax.Array:
    """Alias for :func:`getrs` (scipy.linalg.lu_solve-style name)."""
    return getrs(lu, ipiv, b, perm)


@jax.jit
def getri(
    lu: jax.Array, ipiv: jax.Array, perm: jax.Array | None = None
) -> jax.Array:
    """A^-1 from the packed factors (LAPACK getri): solve A X = I through
    :func:`getrs`.  The blocked-substitution path makes the off-diagonal
    work (nb, i) @ (i, n) GEMMs, so the n-RHS solve is BLAS3-rich —
    there is no separate in-place getri kernel."""
    n = lu.shape[0]
    return getrs(lu, ipiv, jnp.eye(n, dtype=lu.dtype), perm)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def gecon(
    lu: jax.Array, ipiv: jax.Array, anorm: jax.Array,
    perm: jax.Array | None = None, max_iter: int = 5,
):
    """Reciprocal 1-norm condition estimate (LAPACK gecon): Hager's power
    iteration on ||A^-1||_1 using forward and transpose solves on the
    packed factors.  ``anorm`` is ||A||_1 of the ORIGINAL matrix (the
    packed LU overwrites it, as in the reference's in-place `MPF.h:3`).
    Returns ``rcond = 1 / (||A||_1 * est(||A^-1||_1))``; the estimate is a
    lower bound, so rcond is an upper bound (LAPACK semantics).
    ``max_iter`` mirrors LAPACK's internal cap (it converges in <= 3 steps
    on almost all matrices)."""
    n = lu.shape[0]
    f32 = lu.dtype
    x = jnp.full((n,), 1.0 / n, f32)
    est = jnp.zeros((), f32)
    # fixed-trip loop (traced): each step is solve + transpose-solve; the
    # estimate is monotonically non-decreasing, so extra trips are safe
    for _ in range(max_iter):
        y = getrs(lu, ipiv, x, perm)                      # y = A^-1 x
        est = jnp.maximum(est, jnp.sum(jnp.abs(y)))
        xi = jnp.sign(jnp.where(y == 0, jnp.ones((), f32), y))
        z = getrs(lu, ipiv, xi, perm, trans=True)         # z = A^-T xi
        j = jnp.argmax(jnp.abs(z))
        x = jnp.zeros((n,), f32).at[j].set(1.0)
    rcond = jnp.where(
        (anorm > 0) & (est > 0), 1.0 / (anorm.astype(f32) * est),
        jnp.zeros((), f32),
    )
    return rcond, est


@functools.partial(jax.jit, static_argnames=())
def logdet(lu: jax.Array, ipiv: jax.Array):
    """(sign, log|det|) from the packed factors — diag(U) and the swap parity."""
    n = lu.shape[0]
    d = jnp.diagonal(lu)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    nswaps = jnp.sum((ipiv - 1 != idx).astype(jnp.int32))
    sign = jnp.prod(jnp.sign(d)) * jnp.where(nswaps % 2 == 0, 1.0, -1.0).astype(lu.dtype)
    return sign, jnp.sum(jnp.log(jnp.abs(d)))
