"""Matrix corpus generation with the reference's exact semantics.

Replicates `matrix_generator.cpp` behaviorally (value distribution, PRNG
consumption order, size schedule) using the glibc-``rand()`` clone in
:mod:`mpf_tpu.utils.glibc_rand`, so Python- and C++-generated corpora are
bit-identical:

  * sizes start at 2 and grow ``*= step`` (exp) or ``+= step`` (lin)
    (`matrix_generator.cpp:55,74-78`)
  * per element: if ``sparsity > 0`` draw ``rand()/(RAND_MAX+1.0)`` first and
    emit 0.0 when it lands below ``sparsity`` (consuming only that one rand),
    otherwise consume a second rand for the value ``rand() % 100 / 10.0``
    (`matrix_generator.cpp:63-66`)
  * elements are emitted row by row (`matrix_generator.cpp:60-71`).

Also provides fast JAX-PRNG-based generators for benchmarks and tests
(uniform dense like the reference's distribution, plus controlled-condition
matrices for iterative-refinement sweeps, per BASELINE.json config 5).
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Tuple

import numpy as np

from mpf_tpu.utils.glibc_rand import GlibcRand


def corpus_sizes(max_size: int, step: int = 2, mode: str = "exp") -> List[int]:
    """The reference's size schedule (`matrix_generator.cpp:55-78`)."""
    if mode not in ("exp", "lin"):
        raise ValueError(f"mode must be 'exp' or 'lin', got {mode!r}")
    if step <= 0 or (mode == "exp" and step < 2):
        # step=1 with 'exp' would loop forever (size *= 1 never grows); the
        # reference shares this flaw (`matrix_generator.cpp:55,74-78`) — we
        # reject it instead.
        raise ValueError(f"step must be >= 2 for mode='exp' (got {step})")
    sizes = []
    size = 2
    while size <= max_size:
        sizes.append(size)
        size = size * step if mode == "exp" else size + step
    return sizes


def generate_matrix(n: int, rng: GlibcRand, sparsity: float = 0.0) -> np.ndarray:
    """One (n, n) fp64 matrix with the reference's element semantics."""
    a = np.empty((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if sparsity > 0.0 and rng.uniform() < sparsity:
                a[i, j] = 0.0
            else:
                a[i, j] = rng.ref_value()
    return a


def generate_corpus(
    max_size: int, step: int = 2, mode: str = "exp", sparsity: float = 0.0, seed: int = 1
) -> List[np.ndarray]:
    """Full corpus, PRNG-consumption-order-identical to the reference
    generator run with the same arguments (unseeded C = ``seed=1``)."""
    if not (0.0 <= sparsity < 1.0):
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    rng = GlibcRand(seed)
    return [generate_matrix(n, rng, sparsity) for n in corpus_sizes(max_size, step, mode)]


# ---------------------------------------------------------------------------
# Fast generators (not reference-parity; for benchmarks / large tests)
# ---------------------------------------------------------------------------


def random_dense(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Uniform [0, 9.9] dense matrix — the reference distribution's shape
    without the per-element PRNG cost.  Row-diagonally shifted the same way
    random matrices behave: uniform iid entries are almost surely
    well-conditioned enough for partial pivoting."""
    r = np.random.default_rng(seed)
    return (r.random((n, n)) * 9.9).astype(dtype)


def hpl_ai_matrix(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """HPL-AI / HPL-MxP-style benchmark matrix: centered uniform off-diagonal
    entries plus a dominant diagonal shift, keeping kappa(A) small so that
    low-precision factors + iterative refinement converge (the matrix class
    the mixed-precision LU benchmarks are defined on; with the reference's
    positive-mean uniform corpus, kappa grows past 1/eps_bf16 around n~1000
    and plain Richardson IR on bf16-GEMM factors legitimately diverges)."""
    r = np.random.default_rng(seed)
    a = (r.random((n, n)) - 0.5).astype(dtype)
    idx = np.arange(n)
    a[idx, idx] += n / 4.0
    return a


@functools.lru_cache(maxsize=None)
def _device_generator(n: int, kind: str):
    """One jitted generator per (n, kind), so repeated draws compile once."""
    import jax
    import jax.numpy as jnp

    def hpl(key):
        a = jax.random.uniform(key, (n, n), jnp.float32) - 0.5
        rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
        return jnp.where(rows == cols, a + n / 4.0, a)

    def uniform(key):
        return jax.random.uniform(key, (n, n), jnp.float32) * 9.9

    return jax.jit({"hpl": hpl, "uniform": uniform}[kind])


def hpl_ai_matrix_device(n: int, seed: int = 0):
    """Device-side HPL-AI-style matrix: the class of :func:`hpl_ai_matrix`,
    generated with the JAX PRNG directly on the device (fp32), so that
    benchmark-size matrices never cross the host."""
    import jax

    return _device_generator(n, "hpl")(jax.random.PRNGKey(seed))


def random_dense_device(n: int, seed: int = 0):
    """Device-side uniform [0, 9.9] matrix (fp32) — the reference corpus's
    value distribution (`matrix_generator.cpp:66`) at benchmark sizes.
    Unlike the diagonally-dominant HPL-AI class, pivots move on essentially
    EVERY column here, so this is the worst case for the row exchange."""
    import jax

    return _device_generator(n, "uniform")(jax.random.PRNGKey(seed))


def random_conditioned(n: int, kappa: float, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Matrix with prescribed 2-norm condition number ``kappa`` via
    U * diag(logspace(0, -log10(kappa))) * V^T — for IR convergence sweeps
    (BASELINE.json config 5: kappa = 1e6)."""
    r = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(r.standard_normal((n, n)))
    q2, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(kappa), n)
    return (q1 * s @ q2.T).astype(dtype)
