"""LASWP-style row interchange application.

Equivalent of the reference's `LASWP_kernel` (`MPF.cu:42-59`,
launched per panel at `MPF.cu:162`): applies a panel's pivot swaps to the
**full-width** matrix rows (including already-factored L columns — LAPACK
convention, `MPF.cu:52-56`), **sequentially in pivot order** — sequential
swaps are not a naive permutation when pivot targets collide, so semantics
are preserved exactly by swapping through an index vector and applying one
gather over only the affected rows.

Traffic analysis (why not a full-matrix gather): a full N×N row-gather per
panel costs N^3/r elements over the factorization — for n=32768, r=256
that is ~550 GB of device-memory traffic.  Swapping via a bounded set of at
most 2r affected rows costs O(r·N) per panel, ~16N^2 bytes total.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def swaps_to_row_map(piv_global: jnp.ndarray, k: int, ncols: int, window: int):
    """Compose the panel's sequential swaps (dest rows k..k+ncols-1, sources
    ``piv_global`` 0-based) into a row map over the window [k, k+window).

    Returns ``rowmap`` (window,) int32 with global source-row indices such
    that ``A_new[k + i, :] = A_old[rowmap[i], :]`` reproduces applying the
    swaps one by one (`MPF.cu:47-57` semantics).  Pivot rows never point
    above the panel top (partial pivoting searches rows >= j), so the window
    [k, N) always contains every affected row.
    """
    rowmap0 = jax.lax.broadcasted_iota(jnp.int32, (window, 1), 0)[:, 0] + jnp.int32(k)

    def body(j, rowmap):
        dst = jnp.int32(j)                  # local index of row k+j
        src = piv_global[j] - jnp.int32(k)  # local index of pivot row
        a = rowmap[dst]
        b = rowmap[src]
        return rowmap.at[dst].set(b).at[src].set(a)

    return jax.lax.fori_loop(0, ncols, body, rowmap0)


def apply_row_swaps(a: jnp.ndarray, piv_global: jnp.ndarray, k: int, ncols: int) -> jnp.ndarray:
    """Apply a panel's swaps to the full matrix (all N columns), gathering
    only the rows that actually move.

    ``piv_global``: (r,) int32, 0-based global pivot rows for panel columns
    k..k+ncols-1.  ``k``/``ncols`` are static (the blocked driver unrolls
    panels at trace time).
    """
    n = a.shape[0]
    window = n - k
    rowmap = swaps_to_row_map(piv_global, k, ncols, window)
    # Rows with rowmap[i] != k+i moved.  The moved set is contained in the
    # union of destinations {k..k+ncols-1} and pivot sources; gather a
    # bounded 2*ncols-row working set instead of the whole window.
    ident = jax.lax.broadcasted_iota(jnp.int32, (window, 1), 0)[:, 0] + jnp.int32(k)
    moved = rowmap != ident
    # Candidate positions: the ncols destination rows plus the ncols pivot
    # source rows (as window-local indices).  Positions listed twice or not
    # moved write back their own row — harmless.
    dsts = jax.lax.broadcasted_iota(jnp.int32, (ncols, 1), 0)[:, 0]
    srcs = jnp.clip(piv_global[:ncols] - jnp.int32(k), 0, window - 1)
    cand = jnp.concatenate([dsts, srcs])                      # (2*ncols,) local
    src_rows = jnp.take(rowmap, cand, axis=0)                 # global source rows
    # When a candidate didn't move, read its own row so the scatter is a no-op.
    src_rows = jnp.where(jnp.take(moved, cand), src_rows, cand + jnp.int32(k))
    gathered = jnp.take(a, src_rows, axis=0)                  # (2*ncols, N)
    return a.at[cand + jnp.int32(k), :].set(gathered, mode="drop")


def laswp_bounded(a: jnp.ndarray, k, piv: jnp.ndarray, perm: jnp.ndarray,
                  skip: tuple[int, int] | None = None) -> jnp.ndarray:
    """Apply a panel's swaps to the rows of ``a`` through its composed row
    map — the LASWP of the blocked driver (`MPF.cu:42-59`).

    ``piv``: (nr,) 0-based pivot rows of the panel whose diagonal starts at
    row ``k`` (static or traced); ``perm``: the panel's composed row map
    (``a_new[i] = a[perm[i]]``).  Only the destinations ``k..k+nr-1`` and the
    pivot rows can move, so one gather and one scatter of those <= 2*nr rows
    apply all swaps.  ``skip = (c0, c1)`` (static) leaves columns
    ``[c0, c1)`` untouched (the block column the driver writes itself)."""
    nr = piv.shape[0]
    cand = jnp.concatenate(
        [jax.lax.broadcasted_iota(jnp.int32, (nr,), 0) + k, piv])
    src = jnp.take(perm, cand)
    if skip is None:
        return a.at[cand, :].set(jnp.take(a, src, axis=0))
    c0, c1 = skip
    if c0 > 0:
        a = a.at[cand, :c0].set(jnp.take(a[:, :c0], src, axis=0))
    if c1 < a.shape[1]:
        a = a.at[cand, c1:].set(jnp.take(a[:, c1:], src, axis=0))
    return a


def ipiv_to_perm(ipiv: jnp.ndarray) -> jnp.ndarray:
    """Compose LAPACK's sequential ipiv swaps (1-based) into one row map:
    applying the swaps to X equals ``X[perm]``.  O(n) scalar swaps on an
    (n,) index vector — done once, after which any number of right-hand
    sides are permuted with a single gather (the factorization driver
    already returns this map as ``MPFResult.perm``; this is the fallback
    when only ipiv is available)."""
    n = ipiv.shape[0]
    perm0 = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]

    def body(i, perm):
        p = ipiv[i] - 1
        a = perm[i]
        c = perm[p]
        return perm.at[i].set(c).at[p].set(a)

    return jax.lax.fori_loop(0, n, body, perm0)


def apply_row_swaps_vector(
    b: jnp.ndarray, ipiv: jnp.ndarray, perm: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Apply the full factorization's swaps to a right-hand side (rows of a
    (n,) or (n, nrhs) array) — the forward-permutation step of getrs.
    ``ipiv`` is 1-based global (LAPACK convention, as produced by the driver
    and consumed by the oracle).  When the composed row map ``perm`` is
    available (``MPFResult.perm``) this is ONE bounded gather; otherwise the
    map is first composed from ipiv with O(n) scalar swaps (still far
    cheaper than n sequential row exchanges of the full RHS)."""
    if perm is None:
        perm = ipiv_to_perm(ipiv)
    return jnp.take(b, perm, axis=0)
