"""Correctness oracle: P*L*U reconstruction + backward error.

Behavioral port of the reference's entire test methodology
(`benchmark.cpp:59-144`, SURVEY.md section 3.2/4):

  * split the packed LU into unit-diagonal L and U (`get_LU`,
    `benchmark.cpp:59-75`)
  * form L@U (`multiply_sqrMatrices`, `benchmark.cpp:77-82`)
  * re-apply the pivot swaps to L@U in reverse row order to reconstruct
    P*L*U (`row_permute`, `benchmark.cpp:84-95`) — ipiv is 1-based global,
    LAPACK convention
  * compare elementwise to the original A (`check_sqrMatrix_equality`,
    `benchmark.cpp:97-104`, absolute tol 1e-10 in the fp64 reference).

Because our factors are genuinely low precision (fp32 working + bf16 GEMMs),
the primary gate here is the **normwise backward error**
``||P L U - A|| / (n ||A||)`` (north star: O(eps_fp32) after <= 3 IR sweeps,
BASELINE.json); the reference's absolute elementwise tolerance is kept as a
secondary measure, rescaled per precision.  Everything runs in fp64 numpy on
host, independent of the device code it checks.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def split_lu(lu: np.ndarray):
    """Packed LU -> (unit-diagonal L, U).  (`benchmark.cpp:59-75`)"""
    lu = np.asarray(lu, dtype=np.float64)
    l = np.tril(lu, -1) + np.eye(lu.shape[0])
    u = np.triu(lu)
    return l, u


def apply_ipiv_inverse(m: np.ndarray, ipiv: np.ndarray) -> np.ndarray:
    """Re-apply the pivot swaps in reverse order (i = n-1 .. 0), turning
    L@U into P*L*U (`row_permute`, `benchmark.cpp:84-95`).  ``ipiv`` is
    1-based global, LAPACK convention."""
    m = np.array(m, dtype=np.float64, copy=True)
    n = m.shape[0]
    ipiv = np.asarray(ipiv)
    for i in range(n - 1, -1, -1):
        p = int(ipiv[i]) - 1
        if p != i:
            m[[i, p], :] = m[[p, i], :]
    return m


def reconstruct(lu: np.ndarray, ipiv: np.ndarray) -> np.ndarray:
    """P * L * U from a packed factorization — should equal the original A."""
    l, u = split_lu(lu)
    return apply_ipiv_inverse(l @ u, ipiv)


@dataclasses.dataclass
class OracleReport:
    n: int
    max_abs_err: float          # reference metric (`benchmark.cpp:97-104`)
    normwise_backward_err: float  # ||PLU - A||_F / (n ||A||_F), north star
    ok: bool

    def __str__(self) -> str:
        return (
            f"n={self.n} max|PLU-A|={self.max_abs_err:.3e} "
            f"nbe={self.normwise_backward_err:.3e} ok={self.ok}"
        )


def check_factorization(
    a: np.ndarray,
    lu: np.ndarray,
    ipiv: np.ndarray,
    nbe_tol: float = 1e-5,
) -> OracleReport:
    """Full oracle.  ``nbe_tol`` gates the normwise backward error; the
    default 1e-5 is a few hundred eps_fp32 (eps_fp32 ~ 6e-8) scaled for the
    bf16-GEMM trailing updates of the default policy — tighten to ~1e-6 for
    PURE_FP32 runs."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    plu = reconstruct(lu, ipiv)
    diff = plu - a
    max_abs = float(np.max(np.abs(diff))) if n else 0.0
    a_norm = float(np.linalg.norm(a))
    nbe = float(np.linalg.norm(diff) / (n * a_norm)) if n and a_norm > 0 else 0.0
    return OracleReport(n=n, max_abs_err=max_abs, normwise_backward_err=nbe, ok=nbe <= nbe_tol)


def solve_residual(a: np.ndarray, x: np.ndarray, b: np.ndarray) -> float:
    """Normwise solution backward error ||b - A x|| / (||A|| ||x|| + ||b||)
    — the HPL-AI-style gate for iterative refinement."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    num = float(np.linalg.norm(b - a @ x))
    den = float(np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b))
    return num / den if den > 0 else 0.0
