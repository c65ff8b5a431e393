"""mpf_tpu — mixed-precision dense LU factorization in JAX, for the H100.

A JAX library with the capabilities of the CUDA reference
`Keyteer/Mixed-precision_LU_Factorization` (MPF: mixed-precision
pre-pivoting LU, reference entry point `MPF.cu:66` / `MPF.h:3`), extended
per the north star with iterative refinement, 2D block-cyclic multi-device
distribution, and batched factorizations.

Layer map (SURVEY.md section 1):
  L0 precision policy      -> mpf_tpu.precision
  L1 device kernels        -> mpf_tpu.ops (jnp versions + CUDA / Pallas Triton kernels)
  L2 blocked driver        -> mpf_tpu.models.mpf
  L3 harness / CLI         -> mpf_tpu.utils + benchmark.py / matrix_generator.py
  L4 environment tooling   -> mpf_tpu.parallel.mesh (device/mesh probe)
"""

from mpf_tpu.precision import (
    PrecisionPolicy,
    MPF_BF16,
    MPF_REF,
    MPF_FP16,
    PURE_FP32,
    ALL_BF16,
    cast_to_panel,
)
from mpf_tpu.models.mpf import MPFResult, mpf_factorize, make_mpf
from mpf_tpu.models.solve import gecon, getri, getrs, logdet, lu_solve
from mpf_tpu.models.refine import ir_solve, gmres_ir_solve, mpf_solve, solve
from mpf_tpu.models.batched import batched_factorize, batched_solve

__version__ = "0.1.0"

__all__ = [
    "PrecisionPolicy",
    "MPF_BF16",
    "MPF_REF",
    "MPF_FP16",
    "PURE_FP32",
    "ALL_BF16",
    "cast_to_panel",
    "MPFResult",
    "mpf_factorize",
    "make_mpf",
    "gecon",
    "getri",
    "getrs",
    "logdet",
    "lu_solve",
    "ir_solve",
    "gmres_ir_solve",
    "mpf_solve",
    "solve",
    "batched_factorize",
    "batched_solve",
]
