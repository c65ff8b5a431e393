"""Diagonal-block refactor with fused triangular inverses (Pallas, Triton).

The working-precision no-pivot refactor of each r x r diagonal block
(the reference's `dgetf2_native_npv`, `dgetf2_native_npv.cu:11-36`) is a
column loop of rank-1 updates on a tiny block: run by XLA it costs several
kernel launches per column.  This kernel keeps the whole block in registers
of one Triton program and runs the column loop inside it, together with the
two triangular inverses the driver's L21/U12 GEMMs need:

    (diag) -> (lu, inv(unit_lower(lu)), inv(upper(lu)), info)

``lu`` follows :func:`mpf_tpu.ops.getf2.getf2_npv` operation for operation.
The inverses are forward/backward substitutions against the identity; they
agree with `lax.linalg.triangular_solve` to fp32 rounding, not bit for bit.
``info`` is the 1-based column of the first exactly-zero pivot (0 if none):
a zero pivot leaves its diagonal entry at zero, so it is read off ``lu``.

Blocks whose size is not a power of two are factored as the identity-
extended ``[[A, 0], [0, I]]``, whose factors and inverses are those of
``A`` bordered by the identity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mpf_tpu.ops.blas3 import unit_lower_inv, upper_inv
from mpf_tpu.ops.getf2 import getf2_npv

_MIN_BLOCK = 16

#: Warps of the Triton program (H100: 8 is the measured choice, PERF.md).
NUM_WARPS = 8

#: Largest block the Triton kernel takes: three (r, r) fp32 tiles live in
#: the registers of one program, which at r = 256 no longer fit.
MAX_TRITON_BLOCK = 128


def _npv_inv_kernel(a_ref, lu_ref, linv_ref, uinv_ref):
    r = a_ref.shape[0]
    f32 = jnp.float32
    rows = jax.lax.broadcasted_iota(jnp.int32, (r, r), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (r, r), 1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (r,), 0)
    eye = jnp.where(rows == cols, f32(1), f32(0))

    # masked sums pick one row / column / entry exactly (all other terms 0)
    def row(x, j):
        return jnp.sum(jnp.where(rows == j, x, f32(0)), axis=0)

    def col(x, j):
        return jnp.sum(jnp.where(cols == j, x, f32(0)), axis=1)

    def elim(j, carry):
        b, linv = carry
        urow = row(b, j)
        pivval = jnp.sum(jnp.where(idx == j, urow, f32(0)))
        safe = jnp.where(pivval == 0, f32(1), pivval)
        mult = jnp.where(idx > j, col(b, j) / safe, f32(0))
        u = jnp.where(idx > j, urow, f32(0))
        b = b - mult[:, None] * u[None, :]
        b = jnp.where((cols == j) & (rows > j), mult[:, None], b)
        # forward substitution of L X = I: row j of X is final here and
        # column j of L is ``mult``
        linv = linv - mult[:, None] * row(linv, j)[None, :]
        return b, linv

    lu, linv = jax.lax.fori_loop(0, r, elim, (a_ref[...].astype(f32), eye))

    def back(t, x):
        j = r - 1 - t
        ujj = jnp.sum(jnp.where((rows == j) & (cols == j), lu, f32(0)))
        xj = row(x, j) / ujj
        x = jnp.where(rows == j, xj[None, :], x)
        ucol = jnp.where(idx < j, col(lu, j), f32(0))
        return x - ucol[:, None] * xj[None, :]

    uinv = jax.lax.fori_loop(0, r, back, eye)
    lu_ref[...] = lu
    linv_ref[...] = linv
    uinv_ref[...] = uinv


def _padded_size(r: int) -> int:
    return max(_MIN_BLOCK, 1 << (r - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("interpret", "num_warps"))
def getf2_npv_inv_triton(diag: jax.Array, interpret: bool = False,
                         num_warps: int = NUM_WARPS):
    """(r, r) fp32 block -> (lu, linv, uinv, info) in one Triton program
    of ``num_warps`` warps."""
    r = diag.shape[0]
    if diag.shape != (r, r) or diag.dtype != jnp.float32:
        raise ValueError(f"expected a square fp32 block, got {diag.shape} {diag.dtype}")
    p = _padded_size(r)
    a = diag
    if p != r:
        a = jnp.eye(p, dtype=jnp.float32).at[:r, :r].set(diag)
    spec = jax.ShapeDtypeStruct((p, p), jnp.float32)
    lu, linv, uinv = pl.pallas_call(
        _npv_inv_kernel,
        out_shape=(spec, spec, spec),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="mpf_diag_npv_inv",
    )(a)
    lu, linv, uinv = lu[:r, :r], linv[:r, :r], uinv[:r, :r]
    zero = jnp.diagonal(lu) == 0
    info = jnp.where(jnp.any(zero), jnp.argmax(zero) + 1, 0).astype(jnp.int32)
    return lu, linv, uinv, info


def getf2_npv_inv_jnp(diag: jax.Array):
    """The plain version of :func:`getf2_npv_inv_triton`: the jnp column
    loop plus two `lax.linalg.triangular_solve` inverses."""
    lu, info = getf2_npv(diag)
    return lu, unit_lower_inv(lu), upper_inv(lu), info


def diag_kernel(dtype, r: int, platform: str | None = None):
    """The diagonal refactor for an (r, r) block of ``dtype``: the Triton
    kernel for fp32 blocks up to :data:`MAX_TRITON_BLOCK` on the GPU, the
    jnp version everywhere else."""
    platform = jax.default_backend() if platform is None else platform
    if (platform == "gpu" and jnp.dtype(dtype) == jnp.float32
            and r <= MAX_TRITON_BLOCK):
        return getf2_npv_inv_triton
    return getf2_npv_inv_jnp
