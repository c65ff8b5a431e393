"""HPL-AI-style iterative refinement (north-star addition; ABSENT in the
reference per SURVEY.md section 0).

The low-precision factors (bf16 trailing GEMMs under the default policy)
carry O(eps_bf16)-level backward error; Richardson iteration with fp32
residuals recovers O(eps_fp32) solution backward error in a few sweeps
(BASELINE.json gate: <= 3 sweeps).  For ill-conditioned systems
(kappa ~ 1e6, BASELINE.json config 5) GMRES-IR — GMRES preconditioned by the
LU solve — is the robust variant.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpf_tpu.precision import PrecisionPolicy, MPF_BF16
from mpf_tpu.models.mpf import mpf_factorize_traced, MPFResult
from mpf_tpu.models.solve import getrs


class IRResult(NamedTuple):
    x: jax.Array          # refined solution (best iterate under the guard)
    residual_norms: jax.Array  # (sweeps + 1,) ||b - A x||_2 per sweep (fp32)
    sweeps: jax.Array     # sweeps actually improving (for reporting)
    diverged: jax.Array   # bool: IR divergence detected (residual grew) —
                          # the failure-detection signal the north star asks
                          # for; callers should escalate to gmres_ir_solve or
                          # refactor under MPF_REF/PURE_FP32


@functools.partial(jax.jit, static_argnames=("sweeps",))
def ir_solve(
    a: jax.Array,
    lu: jax.Array,
    ipiv: jax.Array,
    b: jax.Array,
    sweeps: int = 3,
    perm: jax.Array | None = None,
) -> IRResult:
    """Richardson iterative refinement: x_{k+1} = x_k + solve(LU, b - A x_k).

    ``a`` is the original (working-precision) matrix; residuals are computed
    in fp32 with fp32 accumulation at HIGHEST precision.
    """
    a32 = a.astype(jnp.float32)
    b32 = b.astype(jnp.float32)
    x = getrs(lu, ipiv, b, perm).astype(jnp.float32)
    norms = []

    def resid(x):
        return b32 - jnp.dot(
            a32, x, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
        )

    r0 = resid(x)
    best_x, best_norm = x, jnp.linalg.norm(r0)
    norms.append(best_norm)
    for _ in range(sweeps):
        d = getrs(lu, ipiv, r0.astype(lu.dtype), perm).astype(jnp.float32)
        x = x + d
        r0 = resid(x)
        nrm = jnp.linalg.norm(r0)
        norms.append(nrm)
        better = nrm < best_norm
        best_x = jnp.where(better, x, best_x)
        best_norm = jnp.where(better, nrm, best_norm)
    norms = jnp.stack(norms)
    improving = jnp.sum((norms[1:] < norms[:-1]).astype(jnp.int32))
    diverged = norms[-1] > norms[0]
    return IRResult(x=best_x, residual_norms=norms, sweeps=improving, diverged=diverged)


@functools.partial(jax.jit, static_argnames=("restart", "maxiter"))
def gmres_ir_solve(
    a: jax.Array,
    lu: jax.Array,
    ipiv: jax.Array,
    b: jax.Array,
    restart: int = 10,
    maxiter: int = 3,
    perm: jax.Array | None = None,
) -> jax.Array:
    """GMRES-IR: GMRES on A x = b, right-preconditioned by the LU solve —
    for systems too ill-conditioned for plain Richardson sweeps."""
    a32 = a.astype(jnp.float32)
    b32 = b.astype(jnp.float32)

    def mv(v):
        return jnp.dot(
            a32, v, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST
        )

    def precond(v):
        return getrs(lu, ipiv, v.astype(lu.dtype), perm).astype(jnp.float32)

    x, _ = jax.scipy.sparse.linalg.gmres(
        mv, b32, M=precond, restart=restart, maxiter=maxiter, solve_method="batched"
    )
    return x


class SolveResult(NamedTuple):
    x: jax.Array
    factors: MPFResult
    residual_norms: jax.Array


def solve(
    a,
    b,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    sweeps: int = 3,
    auto_escalate: bool = True,
    equilibrate: bool = False,
):
    """Convenience driver with automatic precision escalation (host-side
    control): factor under ``policy`` + Richardson IR; if IR divergence is
    detected (kappa * eps_factors too large — the north-star failure signal)
    OR the refined solution's backward error still exceeds ``be_tol`` (a
    stalled-but-not-growing IR is just as inaccurate), retry with GMRES-IR on
    the same factors, and if that still stalls, refactor under the
    reference-faithful MPF_REF policy (mixed precision only in pivot
    selection) and GMRES-IR again.  Returns (x, info_dict).

    All heavy work runs jitted on device; only scalar quality metrics are
    fetched to the host for the escalation decisions.

    ``equilibrate=True`` preconditions with power-of-two row/column scales
    (:func:`mpf_tpu.ops.scaling.geequ`): the scaled system
    ``(R A C) y = R b`` is factored and refined, and ``x = C y`` is exact
    (power-of-two scaling changes exponents only).  Backward errors and
    escalation decisions are made on the ORIGINAL system."""
    from mpf_tpu.precision import MPF_REF
    from mpf_tpu.models.mpf import mpf_factorize

    be_tol = 1e-6

    a_orig, b_orig = a, b
    cs = None
    if equilibrate:
        from mpf_tpu.ops.scaling import equilibrate as _equ

        a, rs, cs = _equ(a)
        # scales apply along the ROW axis; multi-RHS b is (n, k)
        rs_b = rs if b.ndim == 1 else rs[:, None]
        b = (b.astype(jnp.float32) * rs_b.astype(jnp.float32)).astype(b.dtype)

    def _unscale(y):
        if cs is None:
            return y
        cs_y = cs if y.ndim == 1 else cs[:, None]
        return (y.astype(jnp.float32) * cs_y.astype(jnp.float32)).astype(y.dtype)

    res = mpf_factorize(a, r=r, policy=policy, pivot=True)
    ir = ir_solve(a.astype(policy.working), res.lu, res.ipiv, b,
                  sweeps=sweeps, perm=res.perm)
    path = "richardson"
    x = _unscale(ir.x)
    be = float(_backward_error(a_orig, x, b_orig))
    if auto_escalate and (bool(ir.diverged) or be > be_tol):
        x = _unscale(gmres_ir_solve(a, res.lu, res.ipiv, b, restart=20,
                                    maxiter=5, perm=res.perm))
        path = "gmres_ir"
        be = float(_backward_error(a_orig, x, b_orig))
        if be > be_tol and policy.name != MPF_REF.name:
            res = mpf_factorize(a, r=r, policy=MPF_REF, pivot=True)
            x = _unscale(gmres_ir_solve(a, res.lu, res.ipiv, b, restart=20,
                                        maxiter=5, perm=res.perm))
            path = "gmres_ir+mpf_ref_refactor"
            be = float(_backward_error(a_orig, x, b_orig))
    return x, {
        "path": path,
        "diverged": bool(ir.diverged),
        "info": int(res.info),
        "backward_error": be,
    }


@jax.jit
def _backward_error(a, x, b):
    """Normwise solution backward error ||Ax - b|| / (||A||_F ||x|| + ||b||),
    computed on device in fp32 (one scalar comes back to the host)."""
    a32 = a.astype(jnp.float32)
    x32 = x.astype(jnp.float32)
    b32 = b.astype(jnp.float32)
    r = jnp.dot(
        a32, x32, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ) - b32
    scale = jnp.linalg.norm(a32) * jnp.linalg.norm(x32) + jnp.linalg.norm(b32)
    return jnp.linalg.norm(r) / jnp.where(scale > 0, scale, 1.0)


@functools.partial(jax.jit, static_argnames=("r", "policy", "sweeps"))
def mpf_solve(
    a: jax.Array,
    b: jax.Array,
    r: int = 128,
    policy: PrecisionPolicy = MPF_BF16,
    sweeps: int = 3,
) -> SolveResult:
    """End-to-end mixed-precision solve: MPF factorization + IR — the
    flagship pipeline (factor fast in low precision, refine to fp32)."""
    res = mpf_factorize_traced(a, r=r, policy=policy, pivot=True)
    ir = ir_solve(a.astype(policy.working), res.lu, res.ipiv, b,
                  sweeps=sweeps, perm=res.perm)
    return SolveResult(x=ir.x, factors=res, residual_norms=ir.residual_norms)
