"""MPF: blocked right-looking mixed-precision pre-pivoting LU (single device).

The reference driver `MPF(double*, int N, int r, int *IPIV)` (`MPF.cu:66-256`)
does, per r-wide panel:

  1. extract panel, cast fp64->fp16 (`MPF.cu:106-121`)
  2. fp16 partial-pivoted panel LU, keep only pivots (`MPF.cu:131`)
  3. globalize pivots via a host round-trip (`MPF.cu:145-159`) and apply them
     to the full matrix with a LASWP kernel (`MPF.cu:162`)
  4. re-factor the pre-pivoted panel in fp64 without pivoting (`MPF.cu:183`)
  5. TRSM + GEMM trailing update via cuBLAS (`MPF.cu:215-239`)

Here the **entire factorization is one traced XLA computation** with
two-level blocking:

  * an **outer loop over block columns** of width ``block`` is unrolled at
    trace time with static shrinking shapes, so the O(n^3)-dominant trailing
    GEMMs compile at their true sizes;
  * an **inner ``lax.fori_loop`` over r-wide panels** factors each (n, block)
    block column with fixed shapes and masked updates (the masking overhead
    is confined to the O(n^2 * block) block-column work), keeping compile
    time bounded for n in the tens of thousands;
  * each panel step runs the reference's pipeline: low-precision pivot
    selection (factors discarded, only pivots + the composed row map escape),
    one bounded-gather LASWP, working-precision diag re-factorization, and
    TRSM / trailing GEMM via triangular-inverse GEMMs.

The two sequential loops of a panel step are the reference's own
hand-written kernels; on the GPU they run as the CUDA pivot panel
(`ops/panel_cuda.py`) and the Triton diagonal refactor
(`ops/diag_triton.py`), and as their jnp versions elsewhere.  The row
exchange, the TRSMs and the GEMMs are left to XLA.

The reference pays a device->host pivot round-trip plus 5
`cudaDeviceSynchronize()` per panel (`MPF.cu:116-189`); this driver pays
zero host syncs.  Precision per SURVEY.md: fp16 panel -> bf16 (or fp16),
fp64 working -> fp32, fp64 accumulation -> fp32 accumulation.

Shapes are static everywhere, so the driver works under ``jax.vmap``
(batched LUs) and inside ``shard_map`` shards.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpf_tpu.precision import PrecisionPolicy, MPF_BF16, cast_to_panel
from mpf_tpu.ops.blas3 import unit_lower_inv_blocked, _mm_precision
from mpf_tpu.ops.diag_triton import diag_kernel as _select_diag_kernel
from mpf_tpu.ops.panel_cuda import panel_kernel as _select_panel_kernel
from mpf_tpu.ops.pivoting import laswp_bounded


class MPFResult(NamedTuple):
    """Factorization result (LAPACK getrf conventions).

    ``lu``   — (n, n) packed factors in working precision: strictly-lower =
               L (unit diagonal implicit), upper = U
    ``ipiv`` — (n,) int32, **1-based global** pivot rows (`MPF.cu:144-159`
               convention; initialized to identity like `benchmark.cpp:215-217`)
    ``info`` — int32, 1-based column of the first zero pivot, 0 if clean
               (LAPACK-style; the reference has no such guard)
    ``perm`` — (n,) int32, the COMPOSED row map of all swaps:
               ``lu[i] = (P a)[i] = a[perm[i]]``.  Equivalent to applying the
               ipiv swaps sequentially; kept so the solve path applies pivots
               to a right-hand side with ONE gather instead of n sequential
               exchanges.  May be None for legacy constructors.
    """

    lu: jax.Array
    ipiv: jax.Array
    info: jax.Array
    perm: jax.Array | None = None


def _iota(n):
    return jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]


def _inner_panel_step(slab, perm, piv_all, info, kk, jj0, rp, policy, pivot, panel_kernel,
                      diag_kernel):
    """One r-wide panel step inside a block column.

    ``slab``: (n, bc) full-height block-column slab (columns kk..kk+bc of the
    matrix); ``jj0``: traced slab-local column offset (global diagonal sits
    at row/column kk + jj0); ``rp``: static panel width.  Fixed shapes,
    masked updates, so one compiled body serves every panel of the block
    column.
    """
    n, bc = slab.shape
    rows = _iota(n)
    cols = _iota(bc)
    fprec = _mm_precision(slab)
    j0 = kk + jj0  # global diagonal offset (traced)

    panel = jax.lax.dynamic_slice(slab, (0, jj0), (n, rp))
    if pivot:
        piv, pperm, perm = panel_kernel(
            cast_to_panel(panel, policy), row_offset=j0, prev_perm=perm
        )
    else:
        piv = j0 + _iota(rp)
        pperm = rows

    # LASWP over the slab: one bounded row exchange over the <=2r global
    # row positions that can move
    slab = laswp_bounded(slab, j0, piv, pperm)
    piv_all = jax.lax.dynamic_update_slice(piv_all, piv, (jj0,))

    # working-precision no-pivot re-factorization of the rp x rp diag block,
    # with its triangular inverses
    diag = jax.lax.dynamic_slice(slab, (j0, jj0), (rp, rp))
    diag_lu, linv, uinv, info_k = diag_kernel(diag)
    info = jnp.where((info == 0) & (info_k > 0), info_k + j0, info)
    slab = jax.lax.dynamic_update_slice(slab, diag_lu, (j0, jj0))

    # L21 = A21 U11^{-1} (full-height masked GEMM)
    colp = jax.lax.dynamic_slice(slab, (0, jj0), (n, rp))
    l21 = jnp.dot(
        colp, uinv, preferred_element_type=policy.accum, precision=fprec
    ).astype(slab.dtype)
    below = rows >= j0 + rp
    l21 = jnp.where(below[:, None], l21, colp)
    slab = jax.lax.dynamic_update_slice(slab, l21, (0, jj0))

    # U12 within the block column (full-width masked)
    rowp = jax.lax.dynamic_slice(slab, (j0, 0), (rp, bc))
    u12 = jnp.dot(
        linv, rowp, preferred_element_type=policy.accum, precision=fprec
    ).astype(slab.dtype)
    right = cols >= jj0 + rp
    u12 = jnp.where(right[None, :], u12, rowp)
    slab = jax.lax.dynamic_update_slice(slab, u12, (j0, 0))

    # trailing update within the block column (masked rank-rp GEMM)
    lm = jnp.where(below[:, None], l21, 0).astype(policy.gemm_in)
    um = jnp.where(right[None, :], u12, 0).astype(policy.gemm_in)
    upd = jnp.dot(
        lm, um, preferred_element_type=policy.accum, precision=_mm_precision(lm)
    )
    slab = (slab.astype(policy.accum) - upd).astype(slab.dtype)
    return slab, perm, piv_all, info


def _factor_block_column(slab, kk, r, policy, pivot, panel_kernel, diag_kernel=None):
    """Partial-pivoted factorization of the (n, bc) block-column slab whose
    diagonal starts at global offset ``kk`` (static).

    ``panel_kernel`` overrides the pivot panel and ``diag_kernel`` the
    diagonal refactor; ``None`` picks each by device and shape
    (:func:`mpf_tpu.ops.panel_cuda.panel_kernel`,
    :func:`mpf_tpu.ops.diag_triton.diag_kernel`).

    Returns (factored slab, composed global row map perm (n,), global
    0-based pivot rows (bc,), global info)."""
    n, bc = slab.shape
    perm0 = _iota(n)
    piv0 = kk + _iota(bc)
    nfull, tail = divmod(bc, r)

    def step(carry, jj0, rp):
        kern = panel_kernel or _select_panel_kernel(n, rp, policy.panel)
        dkern = diag_kernel or _select_diag_kernel(slab.dtype, rp)
        return _inner_panel_step(*carry, kk, jj0, rp, policy, pivot, kern, dkern)

    carry = (slab, perm0, piv0, jnp.int32(0))
    if nfull == 1:
        carry = step(carry, 0, r)  # avoid loop machinery for a single panel
    elif nfull > 1:
        carry = jax.lax.fori_loop(0, nfull, lambda t, c: step(c, t * r, r), carry)
    # `panel_rows > 1` guard (`MPF.cu:104`): a 1x1 tail needs no work; its
    # pivot entry stays identity
    if tail and n - (kk + nfull * r) != 1:
        carry = step(carry, nfull * r, tail)
    return carry


def _resolve_super(n: int, block: int, super_block) -> int | None:
    """Resolve the superblock width for three-level blocking (``None``
    disables it).  ``"auto"`` (the default) resolves to **disabled**; an
    explicit ``super_block=<int>`` or ``MPF_SUPER=<int>`` (``0`` disables)
    turns it on.  Three-level blocking confines each block column's
    trailing update to its superblock and touches the far trailing matrix
    once per superblock with one wide GEMM; it is not measured on the
    H100 yet."""
    env = os.environ.get("MPF_SUPER", "")
    if env:
        super_block = None if env in ("0", "none") else (
            "auto" if env == "auto" else int(env))
    if super_block == "auto":
        super_block = None
    if super_block is not None:
        if super_block % block or super_block <= block or n < 2 * super_block:
            return None
    return super_block


def l11_inv(lu11, r: int):
    """L11^{-1} of a packed diagonal block for the U12 GEMM: the blocked
    inverse with leaves of at most ``min(r, 128)``.  The distributed driver
    takes the same, so both factor a matrix bit for bit alike."""
    return unit_lower_inv_blocked(lu11, base=min(r, 128))


def _trailing_update(a, ks: int, kw: int, ce: int, policy, fprec, lu_diag, r,
                     u12_block: int | None = None):
    """Deferred-window trailing update from the ``kw``-wide packed diagonal
    block at ``ks``: U12 := L11^{-1} A12 over columns [ks+kw, ce), then
    A[ks+kw:, ks+kw:ce] -= L21 @ U12.  ``ce == n`` reproduces the classic
    full-width right-looking update (reference `MPF.cu:215-239`); the
    three-level driver also calls it with ``ce`` = superblock end (narrow
    mid update) and with ``kw`` = superblock width (wide far update,
    ``u12_block`` set)."""
    n = a.shape[0]
    e = ks + kw
    w = ce - e
    if w <= 0:
        return a
    if u12_block and kw > u12_block:
        # Blocked far-U12 (three-level driver): solve per inner block and
        # push the inter-block coupling into ``policy.gemm_in``-precision
        # correction GEMMs, so the fp32 TRSM flops stay those of two-level
        # blocking.
        for bs in range(0, kw, u12_block):
            bw = min(u12_block, kw - bs)
            d = jax.lax.dynamic_slice(a, (ks + bs, ks + bs), (bw, bw))
            linv_b = l11_inv(d, r)
            a12_b = jax.lax.dynamic_slice(a, (ks + bs, e), (bw, w))
            u12_b = jnp.dot(
                linv_b, a12_b, preferred_element_type=policy.accum,
                precision=fprec,
            ).astype(a.dtype)
            a = jax.lax.dynamic_update_slice(a, u12_b, (ks + bs, e))
            rem = kw - bs - bw
            if rem:
                l21_b = jax.lax.dynamic_slice(
                    a, (ks + bs + bw, ks + bs), (rem, bw)
                ).astype(policy.gemm_in)
                corr = jnp.dot(
                    l21_b, u12_b.astype(policy.gemm_in),
                    preferred_element_type=policy.accum,
                    precision=_mm_precision(l21_b),
                )
                band = (
                    jax.lax.dynamic_slice(
                        a, (ks + bs + bw, e), (rem, w)
                    ).astype(policy.accum) - corr
                ).astype(a.dtype)
                a = jax.lax.dynamic_update_slice(a, band, (ks + bs + bw, e))
        u12 = jax.lax.dynamic_slice(a, (ks, e), (kw, w))
    else:
        # U12 block: L11^{-1} A12 via log-depth blocked triangular inverse,
        # at the working precision like every other fp32 product (a TF32
        # U12 would make MPF_REF mixed beyond pivot selection)
        linv = l11_inv(lu_diag, r)
        a12 = jax.lax.dynamic_slice(a, (ks, e), (kw, w))
        u12 = jnp.dot(
            linv, a12, preferred_element_type=policy.accum, precision=fprec,
        ).astype(a.dtype)
        a = jax.lax.dynamic_update_slice(a, u12, (ks, e))
    # trailing update at true (static) sizes — the O(n^3) hot GEMM
    l21 = a[e:, ks:e].astype(policy.gemm_in)
    u12c = u12.astype(policy.gemm_in)
    upd = jnp.dot(
        l21, u12c, preferred_element_type=policy.accum,
        precision=_mm_precision(l21),
    )
    a22 = (a[e:, e:ce].astype(policy.accum) - upd).astype(a.dtype)
    return a.at[e:, e:ce].set(a22)


def _auto_block(n: int, r: int, policy, block: int | None) -> int:
    """Default block-column width: 2048 for fp32-working n >= 32768, 1024
    otherwise (capped at n, at least r).  Not tuned for the H100 yet."""
    if block is None:
        wide = n >= 32768 and jnp.dtype(policy.working) == jnp.dtype(jnp.float32)
        block = max(r, min(n, 2048 if wide else 1024))
    return max(block, r)


def mpf_factorize_traced(
    a: jax.Array,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    panel_kernel=None,
    super_block="auto",
    diag_kernel=None,
) -> MPFResult:
    """Trace-time body: two-level blocked LU.  Call through
    :func:`mpf_factorize` / :func:`make_mpf` for the jitted entry points.

    ``panel_kernel(panel_lowprec, row_offset, prev_perm) -> (piv, perm,
    composed)`` overrides the pre-pivoting panel implementation, and
    ``diag_kernel(diag) -> (lu, linv, uinv, info)`` the diagonal refactor
    (default: each chosen by device and shape, see
    `ops/panel_cuda.panel_kernel` and `ops/diag_triton.diag_kernel`).
    """
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected a square matrix, got {a.shape}")
    a = a.astype(policy.working)
    block = _auto_block(n, r, policy, block)
    S = _resolve_super(n, block, super_block)
    fprec = _mm_precision(a)

    ipiv = _iota(n) + 1  # identity init (`benchmark.cpp:215-217`)
    info = jnp.int32(0)
    perm_total = _iota(n)  # composed row map: lu[i] = a_orig[perm_total[i]]

    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        slab = a[:, k : k + bc]
        slab, perm, piv_b, info_b = _factor_block_column(
            slab, k, r, policy, pivot, panel_kernel, diag_kernel
        )
        a = a.at[:, k : k + bc].set(slab)
        ipiv = ipiv.at[k : k + bc].set(piv_b + 1)  # piv_b is global 0-based
        info = jnp.where((info == 0) & (info_b > 0), info_b, info)
        if pivot:
            # compose this block's row map into the running total:
            # A_after[i] = A_before[perm[i]] = A_orig[perm_total[perm[i]]]
            perm_total = jnp.take(perm_total, perm)

        # LASWP on the rest of the matrix: one bounded row exchange over
        # the <=2bc global positions that can have moved (full LAPACK
        # row-swap semantics, `MPF.cu:42-59`, including already-factored
        # L columns).
        if pivot:
            a = laswp_bounded(a, k, piv_b, perm, skip=(k, k + bc))
        lu11 = slab[k : k + bc, :]

        if k + bc < n:
            # Three-level blocking: within a superblock the trailing update
            # is confined to the superblock's remaining columns (narrow mid
            # update); the far trailing matrix is touched once per
            # superblock with one wide k=S GEMM.  S=None (or the last,
            # possibly partial, superblock) degenerates to the classic
            # full-width update.
            sb_end = n if S is None else min(k - k % S + S, n)
            a = _trailing_update(a, k, bc, sb_end, policy, fprec, lu11, r)
            if S is not None and k + bc == sb_end and sb_end < n:
                s0 = sb_end - S
                a = _trailing_update(
                    a, s0, S, n, policy, fprec, None, r, u12_block=block
                )

    return MPFResult(lu=a, ipiv=ipiv, info=info, perm=perm_total)


@functools.partial(
    jax.jit, static_argnames=("r", "policy", "pivot", "block", "super_block"),
)
def mpf_factorize(
    a: jax.Array,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    super_block="auto",
) -> MPFResult:
    """Jitted blocked MPF factorization (the library entry point, reference
    `MPF.h:3`)."""
    return mpf_factorize_traced(
        a, r=r, policy=policy, pivot=pivot, block=block, super_block=super_block,
    )


@functools.lru_cache(maxsize=32)
def make_mpf(
    n: int,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
    block: int | None = None,
    panel_kernel=None,
    donate: bool = True,
    super_block="auto",
    diag_kernel=None,
):
    """Build a jitted factorizer for a fixed problem size, optionally donating
    the input buffer (in-place factorization like the reference's overwrite of
    A, `MPF.h:3`).  lru-cached: repeated calls with the same config return
    the SAME jitted callable, so callers that factor several matrices of one
    size compile once."""

    def fn(a):
        if a.shape != (n, n):
            raise ValueError(f"make_mpf({n}) got a matrix of shape {a.shape}")
        return mpf_factorize_traced(
            a, r=r, policy=policy, pivot=pivot, block=block,
            panel_kernel=panel_kernel, super_block=super_block,
            diag_kernel=diag_kernel,
        )

    return jax.jit(fn, donate_argnums=(0,) if donate else ())
