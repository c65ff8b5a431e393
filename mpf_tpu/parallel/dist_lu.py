"""Distributed blocked MPF LU over a 2D block-cyclic layout (shard_map).

[north-star addition — the reference is strictly single-GPU (`MPF.cu:77`,
no NCCL/MPI anywhere, SURVEY.md section 2); this is the collective-based
redesign of its panel loop.]

Per panel step k (block column of width b), executed SPMD on a (P, Q) mesh:

  1. **panel gather** — the owning device column contributes its local
     blocks of column k; ``psum`` over the column axis + ``all_gather`` over
     the row axis replicates the full (N, b) panel on every device
     (the collective analogue of the reference's per-panel D2D panel extract,
     `MPF.cu:108-115`).
  2. **replicated panel factorization** — every device runs the same
     pre-pivoting sequence on identical data (deterministic, so no pivot
     broadcast is needed at all — the reference instead round-trips pivots
     through the host, `MPF.cu:145-159`): low-precision pivot selection
     (`hgetf2` analogue), sequential swaps, working-precision diag-block
     refactor + L21 via triangular-inverse GEMM (`dgetf2_npv` analogue).
  3. **cross-chip row swaps** — the <= 2b affected rows are exchanged with a
     single masked ``psum`` over the row axis (the LASWP step, `MPF.cu:162`,
     without materializing any permutation matrix).
  4. **U12 broadcast** — the owning device row solves U12 = L11^{-1} A12 for
     its local columns; a masked ``psum`` over the row axis replicates it.
  5. **trailing update** — every device updates its local tile with one
     GEMM: A_loc -= L_panel[my rows] @ U12[my cols] (the reference's
     cublasDgemm, `MPF.cu:230-239`), in the policy's GEMM precision.

Everything lives inside one jitted ``lax.fori_loop`` — zero host sync
points, fixed shapes, collectives over the interconnect (NVLink on the GPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mpf_tpu.precision import PrecisionPolicy, MPF_BF16, cast_to_panel
from mpf_tpu.models.mpf import MPFResult, l11_inv
from mpf_tpu.ops.diag_triton import diag_kernel
from mpf_tpu.ops.getf2 import panel_pivots_perm
from mpf_tpu.ops.blas3 import _mm_precision
from mpf_tpu.parallel.mesh import ROW_AXIS, COL_AXIS
from mpf_tpu.parallel.block_cyclic import (
    check_dims,
    to_block_cyclic,
    from_block_cyclic,
    local_row_indices,
    local_col_indices,
    owner_local_row,
)


def _dist_lu_local(tile, *, n, b, gp, gq, nb, policy, pivot):
    """shard_map body: tile is this device's (1, 1, H, W) block-cyclic slab."""
    aloc = tile[0, 0]
    h, w = aloc.shape
    pp = jax.lax.axis_index(ROW_AXIS)
    qq = jax.lax.axis_index(COL_AXIS)
    grows = local_row_indices(h, b, gp, pp)   # (H,) global row of each local row
    gcols = local_col_indices(w, b, gq, qq)   # (W,) global col of each local col
    nlp = h // b
    nlq = w // b
    rows_g = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    fprec = _mm_precision(aloc)

    def gather_panel(aloc, k):
        """Replicate block column k as an (N, b) panel: psum over the column
        axis (only the owner contributes) + all_gather over the row axis —
        the collective analogue of the reference's per-panel D2D panel extract
        (`MPF.cu:108-115`).  ``k`` may be past the end (clamped; the caller
        ignores the result on the final iteration)."""
        jl = jnp.minimum(k // gq, nlq - 1)
        qk = k % gq
        colsl = jax.lax.dynamic_slice(aloc, (0, jl * b), (h, b))
        colsl = jnp.where(qq == qk, colsl, jnp.zeros_like(colsl))
        colsl = jax.lax.psum(colsl, COL_AXIS)
        parts = jax.lax.all_gather(colsl, ROW_AXIS)          # (P, H, b)
        return parts.reshape(gp, nlp, b, b).transpose(1, 0, 2, 3).reshape(n, b)

    def step(k, carry):
        aloc, panel, ipiv, info, permc = carry
        off = k * b
        qk = k % gq
        pk = k % gp
        jl = k // gq
        il = k // gp

        # -- 1. replicated panel factorization (identical data on every
        # device, so no pivot broadcast is needed — the reference instead
        # round-trips pivots through the host, `MPF.cu:145-159`) ------------
        if pivot:
            piv, pperm = panel_pivots_perm(cast_to_panel(panel, policy), row_offset=off)
        else:
            piv = off + jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)[:, 0]
            pperm = rows_g

        # bounded pre-pivot exchange on the replicated panel: only the <=2b
        # positions in {off..off+b-1} U piv can differ from identity under
        # the composed sequential-swap row map (vs the (N, b) full-height
        # take of round 1)
        dests = off + jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)[:, 0]
        cand = jnp.concatenate([dests, piv])                 # (2b,) global rows
        src_g = jnp.take(pperm, cand)
        if pivot:
            panel = panel.at[cand, :].set(jnp.take(panel, src_g, axis=0))
        diag = jax.lax.dynamic_slice(panel, (off, 0), (b, b))
        diag_lu, _, uinv, info_k = diag_kernel(diag.dtype, b)(diag)
        info = jnp.where((info == 0) & (info_k > 0), info_k + off, info)
        l21 = jnp.dot(
            panel, uinv, preferred_element_type=policy.accum, precision=fprec,
        ).astype(panel.dtype)
        panel = jnp.where((rows_g >= off + b)[:, None], l21, panel)
        panel = jax.lax.dynamic_update_slice(panel, diag_lu, (off, 0))
        ipiv = jax.lax.dynamic_update_slice(ipiv, piv + 1, (off,))

        # -- 2. cross-chip row swaps (LASWP, `MPF.cu:42-59`): one masked
        # psum exchange of the <=2b affected rows -------------------------
        owner_s, lrow_s = owner_local_row(src_g, b, gp)
        mine_s = owner_s == pp
        srows = jnp.take(aloc, jnp.where(mine_s, lrow_s, 0), axis=0)
        srows = jnp.where(mine_s[:, None], srows, jnp.zeros_like(srows))
        srows = jax.lax.psum(srows, ROW_AXIS)                # (2b, W) replicated
        owner_c, lrow_c = owner_local_row(cand, b, gp)
        scatter_idx = jnp.where(owner_c == pp, lrow_c, h)    # h = drop
        aloc = aloc.at[scatter_idx, :].set(srows, mode="drop")

        # -- 3. panel writeback (owning device column) ---------------------
        panel_mine = jnp.take(panel, grows, axis=0)          # (H, b) my rows
        cur = jax.lax.dynamic_slice(aloc, (0, jl * b), (h, b))
        aloc = jax.lax.dynamic_update_slice(
            aloc, jnp.where(qq == qk, panel_mine, cur), (0, jl * b)
        )

        # -- 4. U12 = L11^{-1} A12, broadcast along the row axis -----------
        rowsl = jax.lax.dynamic_slice(aloc, (il * b, 0), (b, w))
        rowsl = jnp.where(pp == pk, rowsl, jnp.zeros_like(rowsl))
        rowsl = jax.lax.psum(rowsl, ROW_AXIS)                # (b, W) replicated
        u12 = jnp.dot(
            l11_inv(diag_lu, b), rowsl, preferred_element_type=policy.accum,
            precision=fprec,
        ).astype(aloc.dtype)
        colmask = gcols >= off + b                           # (W,)
        cur_row = jax.lax.dynamic_slice(aloc, (il * b, 0), (b, w))
        new_row = jnp.where((pp == pk) & colmask[None, :], u12, cur_row)
        aloc = jax.lax.dynamic_update_slice(aloc, new_row, (il * b, 0))

        # -- 5. lookahead: update ONLY the next panel's local column with a
        # narrow GEMM, then start its gather — the collectives carry no data
        # dependence on the big trailing GEMM below, so XLA's latency-hiding
        # scheduler overlaps them with it (comm/compute overlap) ---
        lmine = jnp.where((grows >= off + b)[:, None], panel_mine, 0)
        u12m = jnp.where(colmask[None, :], u12, 0)
        gin = policy.gemm_in
        lg = lmine.astype(gin)
        gprec = _mm_precision(lg)
        jl2 = jnp.minimum((k + 1) // gq, nlq - 1)
        qk2 = (k + 1) % gq
        ucol = jax.lax.dynamic_slice(u12m, (0, jl2 * b), (b, b))
        updn = jnp.dot(
            lg, ucol.astype(gin), preferred_element_type=policy.accum,
            precision=gprec,
        )
        curn = jax.lax.dynamic_slice(aloc, (0, jl2 * b), (h, b))
        newn = (curn.astype(policy.accum) - updn).astype(aloc.dtype)
        aloc2 = jax.lax.dynamic_update_slice(
            aloc, jnp.where(qq == qk2, newn, curn), (0, jl2 * b)
        )
        panel_next = gather_panel(aloc2, k + 1)

        # -- 6. trailing update (one local GEMM, the reference's
        # cublasDgemm `MPF.cu:230-239`), skipping the column block already
        # updated in the lookahead ----------------------------------------
        cidx = jax.lax.broadcasted_iota(jnp.int32, (w, 1), 0)[:, 0] // b
        skip = (qq == qk2) & (cidx == jl2)
        u12g = jnp.where(skip[None, :], 0, u12m).astype(gin)
        upd = jnp.dot(lg, u12g, preferred_element_type=policy.accum,
                      precision=gprec)
        aloc = (aloc2.astype(policy.accum) - upd).astype(aloc.dtype)
        permc = jnp.take(permc, pperm)  # compose this panel's swaps
        return aloc, panel_next, ipiv, info, permc

    ipiv0 = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0] + 1
    panel0 = gather_panel(aloc, 0)
    aloc, _, ipiv, info, permc = jax.lax.fori_loop(
        0, nb, step, (aloc, panel0, ipiv0, jnp.int32(0), rows_g)
    )
    return aloc[None, None], ipiv, info, permc


def _dist_lu_local_owner(tile, *, n, b, gp, gq, nb, policy, pivot):
    """Owner-column / row-sharded-panel variant of :func:`_dist_lu_local`:
    the (N, b) panel is never replicated.
    Each device keeps only its local (H, b) rows of block column k (one
    COL-axis psum; the ROW-axis all_gather of the replicated path is gone),
    pivot selection runs sharded (:func:`_dist_panel_pivots_sharded`), and
    the working-precision refactor (L21 = panel · U11⁻¹) runs on local rows
    only — per-device panel flops scale as 1/P with the mesh instead of
    staying constant.  Pivots and factors are bit-identical to the
    replicated path and to the single-device driver run with
    ``r = block = b`` (tested): both take the diagonal refactor from
    :func:`~mpf_tpu.ops.diag_triton.diag_kernel` and U12's inverse from
    :func:`~mpf_tpu.models.mpf.l11_inv`."""
    aloc = tile[0, 0]
    h, w = aloc.shape
    pp = jax.lax.axis_index(ROW_AXIS)
    qq = jax.lax.axis_index(COL_AXIS)
    grows = local_row_indices(h, b, gp, pp)
    gcols = local_col_indices(w, b, gq, qq)
    nlp = h // b
    nlq = w // b
    rows_g = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    fprec = _mm_precision(aloc)

    def gather_panel_local(aloc, k):
        """This device's local rows of block column k, replicated along the
        COLUMN axis only — (H, b), no all_gather."""
        jl = jnp.minimum(k // gq, nlq - 1)
        qk = k % gq
        colsl = jax.lax.dynamic_slice(aloc, (0, jl * b), (h, b))
        return jax.lax.psum(
            jnp.where(qq == qk, colsl, jnp.zeros_like(colsl)), COL_AXIS
        )

    def step(k, carry):
        aloc, ploc, ipiv, info, permc = carry
        off = k * b
        qk = k % gq
        pk = k % gp
        jl = k // gq
        il = k // gp

        # -- 1. sharded panel pivot selection (hgetf2 analogue) -------------
        if pivot:
            piv, pperm = _dist_panel_pivots_sharded(
                cast_to_panel(ploc, policy), grows, off, b, n
            )
        else:
            piv = off + jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)[:, 0]
            pperm = rows_g
        dests = off + jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)[:, 0]
        cand = jnp.concatenate([dests, piv])                 # (2b,) global
        src_g = jnp.take(pperm, cand)

        # -- 2. bounded pre-pivot exchange on the SHARDED working panel:
        # the <=2b moved rows cross shards via one masked psum -------------
        if pivot:
            owner_ps, lrow_ps = owner_local_row(src_g, b, gp)
            mine_ps = owner_ps == pp
            pr = jnp.take(ploc, jnp.where(mine_ps, lrow_ps, 0), axis=0)
            pr = jnp.where(mine_ps[:, None], pr, jnp.zeros_like(pr))
            pr = jax.lax.psum(pr, ROW_AXIS)                  # (2b, b)
            owner_pc, lrow_pc = owner_local_row(cand, b, gp)
            pidx = jnp.where(owner_pc == pp, lrow_pc, h)
            ploc = ploc.at[pidx, :].set(pr, mode="drop")

        # -- 3. diagonal-block refactor (owner row broadcasts the (b, b)
        # block; the tiny npv refactor is replicated — O(b^3) not O(n b^2))
        diag = jax.lax.dynamic_slice(ploc, (il * b, 0), (b, b))
        diag = jax.lax.psum(
            jnp.where(pp == pk, diag, jnp.zeros_like(diag)), ROW_AXIS
        )
        diag_lu, _, uinv, info_k = diag_kernel(diag.dtype, b)(diag)
        info = jnp.where((info == 0) & (info_k > 0), info_k + off, info)
        # L21 on LOCAL rows only — the 1/P panel-flop scaling
        l21 = jnp.dot(
            ploc, uinv, preferred_element_type=policy.accum, precision=fprec,
        ).astype(ploc.dtype)
        pmine = jnp.where((grows >= off + b)[:, None], l21, ploc)
        dmine = jax.lax.dynamic_slice(pmine, (il * b, 0), (b, b))
        pmine = jax.lax.dynamic_update_slice(
            pmine, jnp.where(pp == pk, diag_lu, dmine), (il * b, 0)
        )
        ipiv = jax.lax.dynamic_update_slice(ipiv, piv + 1, (off,))

        # -- 4. cross-chip row swaps on the local tiles (unchanged) --------
        owner_s, lrow_s = owner_local_row(src_g, b, gp)
        mine_s = owner_s == pp
        srows = jnp.take(aloc, jnp.where(mine_s, lrow_s, 0), axis=0)
        srows = jnp.where(mine_s[:, None], srows, jnp.zeros_like(srows))
        srows = jax.lax.psum(srows, ROW_AXIS)                # (2b, W)
        owner_c, lrow_c = owner_local_row(cand, b, gp)
        scatter_idx = jnp.where(owner_c == pp, lrow_c, h)
        aloc = aloc.at[scatter_idx, :].set(srows, mode="drop")

        # -- 5. panel writeback (local rows ARE the shard — no gather) ------
        cur = jax.lax.dynamic_slice(aloc, (0, jl * b), (h, b))
        aloc = jax.lax.dynamic_update_slice(
            aloc, jnp.where(qq == qk, pmine, cur), (0, jl * b)
        )

        # -- 6. U12 = L11^{-1} A12, broadcast along the row axis ------------
        rowsl = jax.lax.dynamic_slice(aloc, (il * b, 0), (b, w))
        rowsl = jnp.where(pp == pk, rowsl, jnp.zeros_like(rowsl))
        rowsl = jax.lax.psum(rowsl, ROW_AXIS)                # (b, W)
        u12 = jnp.dot(
            l11_inv(diag_lu, b), rowsl, preferred_element_type=policy.accum,
            precision=fprec,
        ).astype(aloc.dtype)
        colmask = gcols >= off + b
        cur_row = jax.lax.dynamic_slice(aloc, (il * b, 0), (b, w))
        new_row = jnp.where((pp == pk) & colmask[None, :], u12, cur_row)
        aloc = jax.lax.dynamic_update_slice(aloc, new_row, (il * b, 0))

        # -- 7. lookahead narrow update + next-panel psum (COL only) -------
        lmine = jnp.where((grows >= off + b)[:, None], pmine, 0)
        u12m = jnp.where(colmask[None, :], u12, 0)
        gin = policy.gemm_in
        lg = lmine.astype(gin)
        gprec = _mm_precision(lg)
        jl2 = jnp.minimum((k + 1) // gq, nlq - 1)
        qk2 = (k + 1) % gq
        ucol = jax.lax.dynamic_slice(u12m, (0, jl2 * b), (b, b))
        updn = jnp.dot(
            lg, ucol.astype(gin), preferred_element_type=policy.accum,
            precision=gprec,
        )
        curn = jax.lax.dynamic_slice(aloc, (0, jl2 * b), (h, b))
        newn = (curn.astype(policy.accum) - updn).astype(aloc.dtype)
        aloc2 = jax.lax.dynamic_update_slice(
            aloc, jnp.where(qq == qk2, newn, curn), (0, jl2 * b)
        )
        ploc_next = gather_panel_local(aloc2, k + 1)

        # -- 8. trailing update (one local GEMM) ------------------------
        cidx = jax.lax.broadcasted_iota(jnp.int32, (w, 1), 0)[:, 0] // b
        skip = (qq == qk2) & (cidx == jl2)
        u12g = jnp.where(skip[None, :], 0, u12m).astype(gin)
        upd = jnp.dot(lg, u12g, preferred_element_type=policy.accum,
                      precision=gprec)
        aloc = (aloc2.astype(policy.accum) - upd).astype(aloc.dtype)
        permc = jnp.take(permc, pperm)
        return aloc, ploc_next, ipiv, info, permc

    ipiv0 = rows_g + 1
    ploc0 = gather_panel_local(aloc, 0)
    aloc, _, ipiv, info, permc = jax.lax.fori_loop(
        0, nb, step, (aloc, ploc0, ipiv0, jnp.int32(0), rows_g)
    )
    return aloc[None, None], ipiv, info, permc


def _dist_panel_pivots_sharded(ploc, vpos0, off, b: int, n: int):
    """Row-sharded hgetf2-style pivot selection (owner-column panel work):
    every device eliminates ONLY its local
    rows of the panel, so per-device panel flops are (n/P)·b² instead of
    the replicated path's n·b² (the Amdahl wall as the mesh grows), and the
    (n, b) all_gather disappears.  Pivots are reduced over the mesh row
    axis per column — 3 collectives each: ``pmax`` of the local max |v|,
    ``pmin`` of the tying current positions (the reference's
    first-max-wins scan, `hgetf2_kernel.cu:68-82`, on the virtually-
    permuted layout), and a masked ``psum`` broadcast of the pivot row.
    Rows never move (virtual pivoting): ``vpos`` carries each local row's
    current position under the composed sequential swaps.

    Bit-identical pivot sequence to :func:`panel_pivots_perm` on the
    replicated panel: same masks, same fp32-multiplier rounding, same
    elimination arithmetic per logical row — only WHERE each row's
    arithmetic runs changes.  Returns ``(piv (b,), perm (n,))``
    (both replicated)."""
    h, bb = ploc.shape
    f32 = jnp.float32
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, bb), 1)[0, :]
    rows_g = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    big = jnp.int32(2 * n + 2)

    def body(j, carry):
        p, vpos, piv, perm = carry
        d = off + j
        colv = jnp.abs(p[:, j].astype(f32))
        colv = jnp.where(vpos >= d, colv, f32(-1.0))
        gmax = jax.lax.pmax(jnp.max(colv), ROW_AXIS)
        cand = jnp.where(colv == gmax, vpos, big)
        pj = jax.lax.pmin(jnp.min(cand), ROW_AXIS).astype(jnp.int32)
        piv = piv.at[j].set(pj)
        # virtual swap of positions d <-> pj (no data movement)
        vpos = jnp.where(vpos == d, jnp.where(pj == d, d, pj),
                         jnp.where(vpos == pj, d, vpos))
        pa = perm[d]
        pb = perm[pj]
        perm = perm.at[d].set(pb).at[pj].set(pa)
        # pivot row broadcast (post-swap position d; exactly one
        # contributor mesh-wide, so the psum is exact in any dtype)
        prow = jax.lax.psum(
            jnp.sum(jnp.where((vpos == d)[:, None], p, 0), axis=0), ROW_AXIS
        )
        pivval = prow[j].astype(f32)
        safe = jnp.where(pivval == 0, f32(1), pivval)
        mult = jnp.where(
            vpos > d, p[:, j].astype(f32) / safe, 0.0
        ).astype(p.dtype)
        urow = jnp.where(cols > j, prow, jnp.zeros_like(prow))
        p = p - mult[:, None] * urow[None, :]
        p = jax.lax.dynamic_update_slice(
            p, jnp.where(vpos > d, mult, p[:, j])[:, None], (0, j)
        )
        return p, vpos, piv, perm

    piv0 = jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0)[:, 0] + off
    _, _, piv, perm = jax.lax.fori_loop(
        0, b, body, (ploc, vpos0.astype(jnp.int32), piv0, rows_g)
    )
    return piv, perm


def make_dist_lu(n: int, b: int, mesh, policy: PrecisionPolicy = MPF_BF16,
                 pivot: bool = True):
    """Build the jitted SPMD factorizer over ``mesh`` for (P,Q,H,W) tiles.

    Returns ``fn(tiles) -> (tiles_lu, ipiv, info, perm)`` where
    ``ipiv``/``info``/``perm`` are replicated (``perm`` is the composed row
    map, see ``MPFResult.perm``).  Use :func:`mpf_tpu.parallel.block_cyclic.shard_block_cyclic`
    to lay out the input.
    """
    import os

    gp, gq = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    nb = check_dims(n, b, gp, gq)
    if os.environ.get("MPF_DIST_PANEL", "owner") == "owner":
        # row-sharded panel work (1/P per-device panel flops, no (N, b)
        # all_gather); bit-identical results to the replicated path
        # (`MPF_DIST_PANEL=replicated`)
        body = functools.partial(
            _dist_lu_local_owner, n=n, b=b, gp=gp, gq=gq, nb=nb,
            policy=policy, pivot=pivot,
        )
    else:
        body = functools.partial(
            _dist_lu_local, n=n, b=b, gp=gp, gq=gq, nb=nb, policy=policy,
            pivot=pivot,
        )
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ROW_AXIS, COL_AXIS, None, None),),
        out_specs=(P(ROW_AXIS, COL_AXIS, None, None), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def dist_factorize(
    a: jax.Array,
    mesh,
    b: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    pivot: bool = True,
) -> MPFResult:
    """Factor a global (N, N) matrix over the mesh; returns a global-layout
    MPFResult (convenience wrapper around :func:`make_dist_lu`)."""
    n = a.shape[0]
    gp, gq = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    tiles = to_block_cyclic(a.astype(policy.working), gp, gq, b)
    fn = make_dist_lu(n, b, mesh, policy, pivot)
    tiles_lu, ipiv, info, perm = fn(tiles)
    return MPFResult(
        lu=from_block_cyclic(tiles_lu, n, b), ipiv=ipiv, info=info, perm=perm
    )
