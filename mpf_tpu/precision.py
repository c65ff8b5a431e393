"""L0: precision policies and cast utilities.

Replacement for the reference's fp16 precision utilities
(`fp16_utils.h:5-27` in the reference repo): the reference aliases
``fp16 = __half`` and converts fp64 -> fp16 with saturation to +-65504 and
flush-to-zero below the smallest normal 6.10352e-05 (`fp16_utils.h:15-23`).

The default low precision is **bfloat16** (tensor-core native, fp32-range
exponent), and the working precision is **fp32**.  A
:class:`PrecisionPolicy` captures the full dtype story of a factorization:

  * ``working``  — storage/working precision of the matrix (reference: fp64)
  * ``panel``    — precision of the pre-pivoting panel LU whose numeric
                   factors are discarded and only pivots kept (reference: fp16)
  * ``gemm_in``  — input precision of the trailing-update GEMM operands
                   (reference: fp64 via cublasDgemm, `MPF.cu:230-239`;
                   north star: bf16 inputs)
  * ``accum``    — accumulation precision of matrix products
                   (``preferred_element_type``)
  * ``residual`` — residual precision for iterative refinement

``saturate_panel=True`` reproduces the reference's explicit
saturate+flush-to-zero cast semantics for the panel dtype, parameterized by
that dtype's own finfo (for fp16 this is bit-identical to
`fp16_utils.h:15-23`; for bf16 the clamps are at bf16's max/tiny).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

DType = Any


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy for a mixed-precision LU factorization."""

    name: str
    working: DType
    panel: DType
    gemm_in: DType
    accum: DType
    residual: DType
    saturate_panel: bool = False

    def __repr__(self) -> str:  # compact, for logs / CSV
        return (
            f"PrecisionPolicy({self.name}: working={jnp.dtype(self.working).name}, "
            f"panel={jnp.dtype(self.panel).name}, gemm_in={jnp.dtype(self.gemm_in).name}, "
            f"accum={jnp.dtype(self.accum).name}, saturate={self.saturate_panel})"
        )


#: Default policy (the north-star MPF translation): fp32 working matrix,
#: bf16 pre-pivoting panel, bf16 trailing GEMM inputs with fp32
#: accumulation, fp32 residuals for iterative refinement.
MPF_BF16 = PrecisionPolicy(
    name="mpf_bf16",
    working=jnp.float32,
    panel=jnp.bfloat16,
    gemm_in=jnp.bfloat16,
    accum=jnp.float32,
    residual=jnp.float32,
)

#: Strict-parity policy mirroring the reference's fp16 panel semantics
#: (`fp16_utils.h:15-23`), with the working precision still fp32 (no fp64 on
#: fp64 policy yet).  Mainly for numerics experiments / differential tests.
MPF_FP16 = PrecisionPolicy(
    name="mpf_fp16",
    working=jnp.float32,
    panel=jnp.float16,
    gemm_in=jnp.float32,
    accum=jnp.float32,
    residual=jnp.float32,
    saturate_panel=True,
)

#: Reference-faithful policy: the ONLY mixed-precision element is pivot
#: selection (the reference's whole point, SURVEY.md section 0 — fp16 panel
#: factors are discarded, all numerics run in full working precision,
#: `MPF.cu:106-239`).  bf16 panel for pivots, fp32 everywhere else.  Use this
#: for ill-conditioned systems where bf16-GEMM factors stall IR.
MPF_REF = PrecisionPolicy(
    name="mpf_ref",
    working=jnp.float32,
    panel=jnp.bfloat16,
    gemm_in=jnp.float32,
    accum=jnp.float32,
    residual=jnp.float32,
)

#: Everything in fp32 — the accuracy reference point (analogous to the
#: reference's fp64 LAPACKE_dgetrf baseline, `benchmark.cpp:239-242`).
PURE_FP32 = PrecisionPolicy(
    name="pure_fp32",
    working=jnp.float32,
    panel=jnp.float32,
    gemm_in=jnp.float32,
    accum=jnp.float32,
    residual=jnp.float32,
)

#: Maximum-throughput policy: bf16 everywhere except fp32 accumulation.
ALL_BF16 = PrecisionPolicy(
    name="all_bf16",
    working=jnp.bfloat16,
    panel=jnp.bfloat16,
    gemm_in=jnp.bfloat16,
    accum=jnp.float32,
    residual=jnp.float32,
)

POLICIES = {p.name: p for p in (MPF_BF16, MPF_REF, MPF_FP16, PURE_FP32, ALL_BF16)}


def cast_to_panel(x: jnp.ndarray, policy: PrecisionPolicy) -> jnp.ndarray:
    """Cast a working-precision array to the policy's panel dtype.

    With ``saturate_panel`` this reproduces the reference's explicit cast
    (`fp16_utils.h:15-23`): clamp to the panel dtype's +-max (the reference's
    65504 for fp16) and flush magnitudes below its smallest positive normal
    (the reference's 6.10352e-05) to zero, then round-to-nearest-even — which
    is what a plain ``astype`` does for in-range values.
    """
    panel_dtype = jnp.dtype(policy.panel)
    if x.dtype == panel_dtype:
        return x
    if policy.saturate_panel:
        fi = jnp.finfo(panel_dtype)
        max_v = jnp.asarray(fi.max, dtype=x.dtype)
        tiny = jnp.asarray(fi.tiny, dtype=x.dtype)
        x = jnp.clip(x, -max_v, max_v)
        x = jnp.where(jnp.abs(x) < tiny, jnp.zeros_like(x), x)
    return x.astype(panel_dtype)


def widen_from_panel(x: jnp.ndarray, policy: PrecisionPolicy) -> jnp.ndarray:
    """Panel dtype -> working dtype (reference `fp16_to_double`,
    `fp16_utils.h:25-27`; like the reference's `fp16_to_double_block` kernel at
    `MPF.cu:28-33` this is unused by the factorization itself — the panel's
    numeric factors are discarded, only pivots survive)."""
    return x.astype(policy.working)
