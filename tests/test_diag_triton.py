"""Triton diagonal refactor (`ops/diag_triton.py`) in interpret mode against
its jnp version, and the choice between the two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpf_tpu.ops.diag_triton import (
    MAX_TRITON_BLOCK, diag_kernel, getf2_npv_inv_jnp, getf2_npv_inv_triton)
from mpf_tpu.ops.getf2 import panel_pivots_perm
from mpf_tpu.utils import matgen

TOL = 1e-5  # relative (Frobenius) error against the jnp version


def _diag_block(corpus, r, seed):
    """The pre-pivoted r x r diagonal block the driver hands the kernel."""
    n = 4 * r
    gen = matgen.hpl_ai_matrix if corpus == "hpl" else matgen.random_dense
    a = jnp.asarray(gen(n, seed=seed))
    _, perm = panel_pivots_perm(a[:, :r].astype(jnp.bfloat16))
    return a[perm][:r, :r]


def _reference(d):
    with jax.default_matmul_precision("highest"):
        return getf2_npv_inv_jnp(d)


def _rel(g, w):
    return float(jnp.linalg.norm(g - w) / jnp.linalg.norm(w))


@pytest.mark.parametrize("corpus", ["hpl", "uniform"])
@pytest.mark.parametrize("r", [8, 32, 64, 128])
def test_matches_jnp(r, corpus):
    d = _diag_block(corpus, r, seed=r)
    got = getf2_npv_inv_triton(d, interpret=True)
    want = _reference(d)
    for name, g, w in zip(("lu", "linv", "uinv"), got[:3], want[:3]):
        assert _rel(g, w) <= TOL, name
    assert int(got[3]) == int(want[3]) == 0


def test_zero_pivot_info():
    r = 32
    d = jnp.triu(jnp.ones((r, r), jnp.float32)).at[10, 10].set(0.0)
    got = getf2_npv_inv_triton(d, interpret=True)
    want = _reference(d)
    assert int(got[3]) == int(want[3]) == 11
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def test_non_power_of_two_block_is_padded():
    """r = 100 runs as the identity-extended 128 block; the result is the
    100 x 100 corner."""
    d = _diag_block("uniform", 100, seed=3)
    got = getf2_npv_inv_triton(d, interpret=True)
    want = _reference(d)
    assert all(g.shape == (100, 100) for g in got[:3])
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("platform,dtype,r,triton", [
    ("gpu", jnp.float32, 128, True),
    ("gpu", jnp.float32, 16, True),
    ("gpu", jnp.float32, 2 * MAX_TRITON_BLOCK, False),
    ("gpu", jnp.bfloat16, 128, False),
    ("cpu", jnp.float32, 128, False),
])
def test_selection(platform, dtype, r, triton):
    kern = diag_kernel(dtype, r, platform=platform)
    assert kern is (getf2_npv_inv_triton if triton else getf2_npv_inv_jnp)


def test_driver_asks_for_each_diagonal_block(monkeypatch):
    """The driver takes its diagonal refactor from the selector, per block
    size and working dtype (full panels and the ragged tail)."""
    import mpf_tpu.models.mpf as M

    asked = []

    def spy(dtype, r):
        asked.append((jnp.dtype(dtype), r))
        return getf2_npv_inv_jnp

    monkeypatch.setattr(M, "_select_diag_kernel", spy)
    M.mpf_factorize_traced(jnp.asarray(matgen.hpl_ai_matrix(72, seed=0)), r=16, block=48)
    assert set(asked) == {(jnp.dtype(jnp.float32), 16), (jnp.dtype(jnp.float32), 8)}


def test_override_skips_diag_selection(monkeypatch):
    import mpf_tpu.models.mpf as M

    monkeypatch.setattr(M, "_select_diag_kernel", lambda *a: pytest.fail("selector called"))
    a = jnp.asarray(matgen.hpl_ai_matrix(32, seed=0))
    M.mpf_factorize_traced(a, r=8, diag_kernel=getf2_npv_inv_jnp)


@pytest.mark.parametrize("mode", ["owner", "replicated"])
def test_dist_asks_for_each_diagonal_block(mode, monkeypatch):
    """The distributed driver takes its diagonal refactor from the same
    selector as the single-device driver."""
    import mpf_tpu.parallel.dist_lu as D
    from mpf_tpu.parallel.mesh import make_mesh

    asked = []

    def spy(dtype, r):
        asked.append((jnp.dtype(dtype), r))
        return getf2_npv_inv_jnp

    monkeypatch.setenv("MPF_DIST_PANEL", mode)
    monkeypatch.setattr(D, "diag_kernel", spy)
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    D.dist_factorize(jnp.asarray(matgen.hpl_ai_matrix(64, seed=0)), mesh, b=8)
    assert set(asked) == {(jnp.dtype(jnp.float32), 8)}
