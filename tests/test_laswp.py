"""The driver's bounded LASWP (`ops/pivoting.laswp_bounded`) against numpy
sequential row swaps (`MPF.cu:42-59` semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpf_tpu.ops.pivoting import laswp_bounded


def _swap_scenario(rng, n, k, nr, mode):
    """Sequential partial-pivoting swaps -> (pivot rows, composed row map).

    ``mode``: 'uniform' picks each pivot anywhere below the diagonal
    (pivot-heavy, reference corpus semantics); 'diag' keeps most pivots on
    the diagonal (HPL-AI-like); 'inband' confines pivots to the band."""
    rows = np.arange(n)
    piv = np.empty(nr, np.int64)
    for j in range(nr):
        if mode == "uniform":
            p = rng.integers(k + j, n)
        elif mode == "inband":
            p = rng.integers(k + j, k + nr)
        else:
            p = k + j if rng.random() < 0.7 else rng.integers(k + j, n)
        piv[j] = p
        rows[k + j], rows[p] = rows[p], rows[k + j]
    return piv, rows


def _sequential(a, k, piv):
    a = np.array(a, copy=True)
    for j, p in enumerate(piv):
        a[[k + j, p]] = a[[p, k + j]]
    return a


def _run(a, k, piv, rows, skip=None):
    out = laswp_bounded(jnp.asarray(a), k, jnp.asarray(piv, jnp.int32),
                        jnp.asarray(rows, jnp.int32), skip=skip)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("mode", ["uniform", "diag", "inband"])
@pytest.mark.parametrize("k", [0, 16])
def test_matches_sequential_swaps(dtype, mode, k):
    rng = np.random.default_rng(hash((mode, k)) % 2**32)
    n, w, nr = 64, 128, 16
    a = rng.standard_normal((n, w)).astype(dtype)
    piv, rows = _swap_scenario(rng, n, k, nr, mode)
    exp = _sequential(np.asarray(a, np.float32), k, piv)
    np.testing.assert_array_equal(_run(a, k, piv, rows), exp)
    np.testing.assert_array_equal(exp, np.asarray(a, np.float32)[rows])


def test_identity():
    rng = np.random.default_rng(3)
    n, w, nr, k = 64, 128, 16, 8
    a = rng.standard_normal((n, w)).astype(np.float32)
    piv = np.arange(k, k + nr)
    np.testing.assert_array_equal(_run(a, k, piv, np.arange(n)), a)


def test_randomized_stress():
    """Many random scenarios, both dtypes, band at the top, middle and the
    last rows."""
    n, w, nr = 128, 96, 32
    for seed in range(10):
        rng = np.random.default_rng(100 + seed)
        dtype = np.float32 if seed % 2 == 0 else jnp.bfloat16
        k = [0, 32, n - nr][seed % 3]
        mode = ["uniform", "diag"][seed % 2]
        a = rng.standard_normal((n, w)).astype(dtype)
        piv, rows = _swap_scenario(rng, n, k, nr, mode)
        np.testing.assert_array_equal(
            _run(a, k, piv, rows), _sequential(np.asarray(a, np.float32), k, piv),
            err_msg=f"seed {seed}")


def test_skip_leaves_block_column():
    """``skip=(c0, c1)``: the driver's full-matrix LASWP around the block
    column it writes itself."""
    rng = np.random.default_rng(7)
    n, nr, k = 96, 16, 32
    a = rng.standard_normal((n, n)).astype(np.float32)
    piv, rows = _swap_scenario(rng, n, k, nr, "uniform")
    got = _run(a, k, piv, rows, skip=(k, k + nr))
    exp = a[rows]
    exp[:, k:k + nr] = a[:, k:k + nr]
    np.testing.assert_array_equal(got, exp)


def test_traced_offset():
    """The panel step passes its diagonal offset as a traced value."""
    rng = np.random.default_rng(9)
    n, w, nr, k = 64, 32, 8, 24
    a = rng.standard_normal((n, w)).astype(np.float32)
    piv, rows = _swap_scenario(rng, n, k, nr, "uniform")
    fn = jax.jit(lambda a, k, piv, rows: laswp_bounded(a, k, piv, rows))
    got = fn(jnp.asarray(a), jnp.int32(k), jnp.asarray(piv, jnp.int32),
             jnp.asarray(rows, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got), a[rows])
