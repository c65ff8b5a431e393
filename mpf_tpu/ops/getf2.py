"""Unblocked panel LU kernels (jnp reference implementations).

jnp versions of the reference's two cooperative CUDA kernels:

  * :func:`panel_pivots` — the low-precision pre-pivoting panel LU
    (`HGETF2_kernel`, `hgetf2_kernel.cu:15-120`): full partial-pivoted LU of
    an (m, r) panel in the policy's panel dtype, where the numeric factors
    are **discarded** and only the pivot sequence escapes (the reference
    writes `d_P_FP16_buffer` at `MPF.cu:120`, reads only `ipiv_panel` back at
    `MPF.cu:145`).  The reference's 4 grid-wide barriers per column
    (`hgetf2_kernel.cu:25,65,84,101`) become a `lax.fori_loop` over columns of
    fully vectorized ops.  On the GPU the driver runs the CUDA kernel
    `native/panel_pivots.cu` in its place, which returns the same pivots.
  * :func:`getf2_npv` — the working-precision no-pivot re-factorization
    (`dgetf2_native_npv`, `dgetf2_native_npv.cu:11-36`), with the zero-pivot
    detection the reference lacks (`dgetf2_native_npv.cu:23-24` divides
    blindly): returns a LAPACK-style ``info`` (1-based column of the first
    exactly-zero pivot, 0 if none).

Both operate on fixed-shape (m, r) arrays with row/column masks — XLA-friendly
static shapes, no data-dependent control flow.  Pivot ties resolve to the
lowest row index (``jnp.argmax`` takes the first maximum), matching the
reference's strict-``>`` inter-block scan (`hgetf2_kernel.cu:68-82`).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def panel_pivots(
    panel: jnp.ndarray, ncols: int | None = None, row_offset=0
) -> jnp.ndarray:
    """Partial-pivoted LU of an (m, r) panel in its own (low) dtype; returns
    only the 0-based pivot rows (panel-array row indices), shape (r,) int32.

    ``ncols`` (static) limits the factorization to the first ``ncols``
    columns for ragged final panels; trailing entries of the result are the
    identity (piv[j] = row_offset + j).

    ``row_offset`` (static or traced int32) places the panel's diagonal at
    array row ``row_offset`` instead of 0 — rows above it are frozen.  The
    distributed driver passes the global panel with offset k*b so pivot
    indices come back global.
    """
    m, r = panel.shape
    ncols = r if ncols is None else ncols
    off = jnp.asarray(row_offset, dtype=jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)[0, :]

    def body(j, carry):
        p, piv = carry
        d = off + j  # array row of the diagonal for column j
        # (a)+(b): argmax of |column j| over rows >= d (first max wins ties)
        colv = jnp.abs(p[:, j].astype(jnp.float32))
        colv = jnp.where(rows >= d, colv, jnp.float32(-1.0))
        pj = jnp.argmax(colv).astype(jnp.int32)
        piv = piv.at[j].set(pj)
        # (c): swap rows d <-> pj of the panel
        row_d = p[d, :]
        row_p = p[pj, :]
        p = p.at[d, :].set(row_p).at[pj, :].set(row_d)
        # (d): rank-1 elimination, multipliers stored in place (multipliers
        # are computed in fp32 and rounded to the panel dtype, matching the
        # Pallas kernel bit-for-bit)
        pivval = p[d, j].astype(jnp.float32)
        safe = jnp.where(pivval == 0, jnp.float32(1), pivval)
        mult = jnp.where(
            rows > d, p[:, j].astype(jnp.float32) / safe, 0.0
        ).astype(p.dtype)
        urow = jnp.where(cols > j, p[d, :], jnp.zeros_like(p[d, :]))
        p = p - mult[:, None] * urow[None, :]
        p = p.at[:, j].set(jnp.where(rows > d, mult, p[:, j]))
        return p, piv

    piv0 = jax.lax.broadcasted_iota(jnp.int32, (r, 1), 0)[:, 0] + off
    _, piv = jax.lax.fori_loop(0, ncols, body, (panel, piv0))
    return piv


def panel_pivots_perm(
    panel: jnp.ndarray, row_offset=0, ncols: int | None = None, prev_perm=None
):
    """Like :func:`panel_pivots` but additionally carries the row
    permutation through the same elimination loop: returns ``(piv, perm)``
    with ``perm`` (m,) int32 such that applying the panel's sequential swaps
    to any array ``X`` equals ``X_new[i] = X_old[perm[i]]`` — the blocked
    driver uses it to apply each panel's swaps with ONE bounded gather
    instead of r sequential exchanges (the LASWP semantics of `MPF.cu:47-57`
    compose exactly into this row map)."""
    m, r = panel.shape
    ncols = r if ncols is None else ncols
    off = jnp.asarray(row_offset, dtype=jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)[0, :]

    def body(j, carry):
        p, piv, perm = carry
        d = off + j
        colv = jnp.abs(p[:, j].astype(jnp.float32))
        colv = jnp.where(rows >= d, colv, jnp.float32(-1.0))
        pj = jnp.argmax(colv).astype(jnp.int32)
        piv = piv.at[j].set(pj)
        row_d = p[d, :]
        row_p = p[pj, :]
        p = p.at[d, :].set(row_p).at[pj, :].set(row_d)
        sa = perm[d]
        sb = perm[pj]
        perm = perm.at[d].set(sb).at[pj].set(sa)
        # fp32 multipliers rounded to panel dtype — the CUDA kernel
        # (native/panel_pivots.cu) rounds the same way
        pivval = p[d, j].astype(jnp.float32)
        safe = jnp.where(pivval == 0, jnp.float32(1), pivval)
        mult = jnp.where(
            rows > d, p[:, j].astype(jnp.float32) / safe, 0.0
        ).astype(p.dtype)
        urow = jnp.where(cols > j, p[d, :], jnp.zeros_like(p[d, :]))
        p = p - mult[:, None] * urow[None, :]
        p = p.at[:, j].set(jnp.where(rows > d, mult, p[:, j]))
        return p, piv, perm

    piv0 = jax.lax.broadcasted_iota(jnp.int32, (r, 1), 0)[:, 0] + off
    _, piv, perm = jax.lax.fori_loop(0, ncols, body, (panel, piv0, rows))
    if prev_perm is not None:
        return piv, perm, jnp.take(prev_perm, perm)
    return piv, perm


def getf2_npv(block: jnp.ndarray, ncols: int | None = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """No-pivot unblocked LU of an (m, r) block in working precision.

    Returns (packed LU, info) where info is the 1-based index of the first
    zero pivot (0 when the factorization is clean).  Mirrors
    `dgetf2_native_npv.cu:11-36` plus the missing singularity guard.
    """
    m, r = block.shape
    ncols = r if ncols is None else ncols
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)[0, :]

    def body(j, carry):
        b, info = carry
        pivval = b[j, j]
        info = jnp.where((pivval == 0) & (info == 0), (j + 1).astype(jnp.int32), info)
        safe = jnp.where(pivval == 0, jnp.ones_like(pivval), pivval)
        mult = jnp.where(rows > j, b[:, j] / safe, jnp.zeros_like(b[:, j]))
        urow = jnp.where(cols > j, b[j, :], jnp.zeros_like(b[j, :]))
        b = b - jnp.outer(mult, urow).astype(b.dtype)
        b = b.at[:, j].set(jnp.where(rows > j, mult, b[:, j]))
        return b, info

    lu, info = jax.lax.fori_loop(0, ncols, body, (block, jnp.int32(0)))
    return lu, info


@partial(jax.jit, static_argnames=("ncols",))
def getf2_pivoted(a: jnp.ndarray, ncols: int | None = None):
    """Unblocked partial-pivoted LU **keeping** the factors — the working-
    precision building block for tests/small problems (what LAPACK's getf2
    does).  Returns (packed LU, local 0-based pivots, info)."""
    m, r = a.shape
    ncols = r if ncols is None else ncols
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, r), 1)[0, :]

    def body(j, carry):
        b, piv, info = carry
        colv = jnp.abs(b[:, j].astype(jnp.float32))
        colv = jnp.where(rows >= j, colv, jnp.float32(-1.0))
        pj = jnp.argmax(colv).astype(jnp.int32)
        piv = piv.at[j].set(pj)
        row_j = b[j, :]
        row_p = b[pj, :]
        b = b.at[j, :].set(row_p).at[pj, :].set(row_j)
        pivval = b[j, j]
        info = jnp.where((pivval == 0) & (info == 0), (j + 1).astype(jnp.int32), info)
        safe = jnp.where(pivval == 0, jnp.ones_like(pivval), pivval)
        mult = jnp.where(rows > j, b[:, j] / safe, jnp.zeros_like(b[:, j]))
        urow = jnp.where(cols > j, b[j, :], jnp.zeros_like(b[j, :]))
        b = b - jnp.outer(mult, urow).astype(b.dtype)
        b = b.at[:, j].set(jnp.where(rows > j, mult, b[:, j]))
        return b, piv, info

    piv0 = jax.lax.broadcasted_iota(jnp.int32, (r, 1), 0)[:, 0]
    lu, piv, info = jax.lax.fori_loop(0, ncols, body, (a, piv0, jnp.int32(0)))
    return lu, piv, info
