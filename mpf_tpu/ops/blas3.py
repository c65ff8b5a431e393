"""BLAS3 building blocks.

Equivalents of the reference's cuBLAS calls (`MPF.cu:215-239`):

  * :func:`trsm_u12` — the left/lower/no-trans/unit-diag TRSM computing
    U12 = L11^{-1} A12 (`cublasDtrsm`, `MPF.cu:215-225`)
  * :func:`trsm_l21` — right/upper TRSM computing L21 = A21 U11^{-1}
    (the reference instead re-runs its no-pivot elimination kernel over the
    whole (m, r) panel, `MPF.cu:183`; the sub-diagonal part of that
    elimination is exactly a triangular solve, which becomes one GEMM via
    the inverse trick below, so only the r x r top block needs the scalar
    elimination loop)
  * :func:`trailing_update` — A22 <- A22 - L21 @ U12 (`cublasDgemm` with
    alpha=-1, beta=1, `MPF.cu:230-239`), with policy-controlled operand
    precision and fp32 accumulation.

Triangular solves with many right-hand sides are implemented as
``inv(T) @ B`` where ``inv(T)`` of the r x r triangular block is computed
once per panel with a fixed-size triangular solve against the identity —
turning the O(r^2 n) TRSM into one r x r solve plus a single GEMM
(the standard HPL-on-accelerator formulation).  Set ``use_inv=False`` for
the direct `lax.linalg.triangular_solve` path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mpf_tpu.precision import PrecisionPolicy, MPF_BF16


def _mm_precision(x):
    """fp32 operands request HIGHEST precision: at the default precision the
    GPU runs fp32 products in TF32 (about three decimal digits) and silently
    degrades the working precision; low-precision operands take the default
    path (fp32 accumulation is asked for with ``preferred_element_type``)."""
    return jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None


def unit_lower_inv(l11: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the unit-lower-triangular r x r block (diagonal of the
    packed LU holds U; the implicit unit diagonal of L is supplied here)."""
    r = l11.shape[0]
    l = jnp.tril(l11, -1) + jnp.eye(r, dtype=l11.dtype)
    return jax.lax.linalg.triangular_solve(
        l, jnp.eye(r, dtype=l11.dtype), left_side=True, lower=True, unit_diagonal=True
    )


def unit_lower_inv_blocked(l11: jnp.ndarray, base: int = 128) -> jnp.ndarray:
    """Inverse of a unit-lower-triangular block by recursive 2x2 block
    partitioning — log-depth, all the O(n^3) work in GEMMs:

        inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]

    The <= ``base``-sized leaves use the scalar triangular solve.  This is
    how the reference's big cublasDtrsm (`MPF.cu:215-225`) becomes GEMMs
    for wide blocks."""
    n = l11.shape[0]
    h = (n // 2 + base - 1) // base * base  # split at a multiple of base
    if n <= base or h >= n:
        return unit_lower_inv(l11)
    a = l11[:h, :h]
    bmat = l11[h:, :h]
    c = l11[h:, h:]
    ai = unit_lower_inv_blocked(a, base)
    ci = unit_lower_inv_blocked(c, base)
    # the inner product accumulates in fp32, so the outer one multiplies
    # fp32 operands whatever the block's dtype
    inner = jnp.dot(bmat, ai, preferred_element_type=jnp.float32,
                    precision=_mm_precision(l11))
    x = -jnp.dot(
        ci.astype(jnp.float32), inner, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(l11.dtype)
    top = jnp.concatenate([ai, jnp.zeros((h, n - h), dtype=l11.dtype)], axis=1)
    bot = jnp.concatenate([x, ci], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def upper_inv(u11: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the upper-triangular r x r block."""
    r = u11.shape[0]
    u = jnp.triu(u11)
    return jax.lax.linalg.triangular_solve(
        u, jnp.eye(r, dtype=u11.dtype), left_side=True, lower=False
    )


def trsm_u12(
    lu11: jnp.ndarray,
    a12: jnp.ndarray,
    policy: PrecisionPolicy = MPF_BF16,
    use_inv: bool = True,
) -> jnp.ndarray:
    """U12 = L11^{-1} @ A12 with L11 unit-lower from the packed block."""
    if use_inv:
        linv = unit_lower_inv(lu11)
        return jnp.dot(
            linv, a12, preferred_element_type=policy.accum, precision=_mm_precision(a12)
        ).astype(a12.dtype)
    l = jnp.tril(lu11, -1) + jnp.eye(lu11.shape[0], dtype=lu11.dtype)
    return jax.lax.linalg.triangular_solve(
        l, a12, left_side=True, lower=True, unit_diagonal=True
    )


def trsm_l21(
    lu11: jnp.ndarray,
    a21: jnp.ndarray,
    policy: PrecisionPolicy = MPF_BF16,
    use_inv: bool = True,
) -> jnp.ndarray:
    """L21 = A21 @ U11^{-1} with U11 upper from the packed block."""
    if use_inv:
        uinv = upper_inv(lu11)
        return jnp.dot(
            a21, uinv, preferred_element_type=policy.accum, precision=_mm_precision(a21)
        ).astype(a21.dtype)
    u = jnp.triu(lu11)
    return jax.lax.linalg.triangular_solve(u, a21, left_side=False, lower=False)


def trailing_update(
    a22: jnp.ndarray,
    l21: jnp.ndarray,
    u12: jnp.ndarray,
    policy: PrecisionPolicy = MPF_BF16,
) -> jnp.ndarray:
    """A22 <- A22 - L21 @ U12 with policy-controlled GEMM input precision and
    accumulation (`preferred_element_type=policy.accum`).  This is the
    O(n^3)-dominant operation (`MPF.cu:230-239`)."""
    l = l21.astype(policy.gemm_in)
    u = u12.astype(policy.gemm_in)
    prod = jnp.dot(l, u, preferred_element_type=policy.accum, precision=_mm_precision(l))
    return (a22.astype(policy.accum) - prod).astype(a22.dtype)
