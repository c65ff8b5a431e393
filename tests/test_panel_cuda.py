"""The CUDA pivot panel (`ops/panel_cuda.py`): the Python that chooses it,
its wiring into the driver, and — on a Hopper GPU only — the library's
launch sizing and the kernel itself against its jnp version."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mpf_tpu.models.mpf as M
from mpf_tpu import MPF_BF16
from mpf_tpu.ops import panel_cuda
from mpf_tpu.ops.getf2 import panel_pivots_perm
from mpf_tpu.utils import matgen
from mpf_tpu.utils.oracle import check_factorization


def _device(platform="gpu", capability="9.0"):
    return SimpleNamespace(platform=platform, compute_capability=capability)


class _FakeLib:
    """Stands in for libmpf_cuda.so: answers MpfPanelFits from a rule."""

    def __init__(self, rule):
        self.rule = rule
        self.asked = []

    def MpfPanelFits(self, m, r, itemsize):
        self.asked.append((m, r, itemsize))
        return self.rule(m, r, itemsize)


def test_cpu_selects_jnp():
    assert panel_cuda.panel_kernel(32768, 128, jnp.bfloat16) is panel_pivots_perm
    assert panel_cuda.panel_kernel(
        32768, 128, jnp.bfloat16, _device("cpu", None)) is panel_pivots_perm


@pytest.mark.parametrize("m,r,dtype,capability,lib_fits,cuda", [
    (32768, 128, jnp.bfloat16, "9.0", 1, True),
    (32768, 128, jnp.float32, "9.0", 1, True),
    (32768, 128, jnp.float16, "9.0", 1, True),
    (65536, 128, jnp.float32, "9.0", 0, False),   # the library says it does not fit
    (32768, 128, jnp.float64, "9.0", 1, False),   # no fp64 panel kernel
    (32768, 128, jnp.bfloat16, "8.0", 1, False),  # sm_90a code runs on Hopper only
    (32768, 128, jnp.bfloat16, "10.0", 1, False),
])
def test_gpu_selection_by_shape_and_dtype(m, r, dtype, capability, lib_fits, cuda,
                                          monkeypatch):
    lib = _FakeLib(lambda *_: lib_fits)
    monkeypatch.setattr(panel_cuda, "_register", lambda: lib)
    kern = panel_cuda.panel_kernel(m, r, dtype, _device(capability=capability))
    assert kern is (panel_cuda.panel_pivots_cuda if cuda else panel_pivots_perm)
    asks = capability == panel_cuda.CAPABILITY and jnp.dtype(dtype) != jnp.float64
    assert lib.asked == ([(m, r, jnp.dtype(dtype).itemsize)] if asks else [])


def test_fits_raises_when_the_device_cannot_be_queried(monkeypatch):
    monkeypatch.setattr(panel_cuda, "_register", lambda: _FakeLib(lambda *_: -1))
    with pytest.raises(RuntimeError, match="cannot query"):
        panel_cuda.panel_kernel(32768, 128, jnp.bfloat16, _device())


def test_prev_perm_composition():
    """The composed map the driver carries is ``prev_perm[perm]``."""
    rng = np.random.default_rng(0)
    m, r = 64, 8
    p = jnp.asarray(rng.random((m, r)), jnp.bfloat16)
    prev = jnp.asarray(rng.permutation(m), jnp.int32)
    piv, perm, comp = panel_pivots_perm(p, row_offset=5, prev_perm=prev)
    piv2, perm2 = panel_pivots_perm(p, row_offset=5)
    np.testing.assert_array_equal(np.asarray(piv), np.asarray(piv2))
    np.testing.assert_array_equal(np.asarray(comp), np.asarray(prev)[np.asarray(perm2)])


def test_driver_asks_for_each_panel(monkeypatch):
    """The driver asks the selector for every panel shape it factors (full
    panels and the ragged tail) with the policy's panel dtype."""
    asked = []

    def spy(m, r, dtype):
        asked.append((m, r, jnp.dtype(dtype)))
        return panel_pivots_perm

    monkeypatch.setattr(M, "_select_panel_kernel", spy)
    n = 80
    a = matgen.random_dense(n, seed=1)
    res = M.mpf_factorize_traced(jnp.asarray(a), r=16, policy=MPF_BF16, block=48)
    assert set(asked) == {(n, 16, jnp.dtype(jnp.bfloat16))}
    rep = check_factorization(a, np.asarray(res.lu), np.asarray(res.ipiv), nbe_tol=1e-3)
    assert rep.ok, str(rep)


def test_override_skips_selection(monkeypatch):
    monkeypatch.setattr(M, "_select_panel_kernel", lambda *a: pytest.fail("selector called"))
    a = jnp.asarray(matgen.hpl_ai_matrix(32, seed=0))
    M.mpf_factorize_traced(a, r=8, panel_kernel=panel_pivots_perm)


@pytest.mark.gpu
def test_launch_geometry(gpu):
    """On an H100 (132 SMs, 227 KB per block): a 32768-row panel fits in
    every dtype, a 65536-row bf16 panel fits, a 65536-row fp32 one does not
    (497 rows of 129 words per block)."""
    if gpu.compute_capability != panel_cuda.CAPABILITY:
        pytest.skip(f"the library is built for compute capability {panel_cuda.CAPABILITY}")
    for dtype in (jnp.bfloat16, jnp.float16, jnp.float32):
        assert panel_cuda.fits(32768, 128, dtype)
    assert panel_cuda.fits(65536, 128, jnp.bfloat16)
    assert not panel_cuda.fits(65536, 128, jnp.float32)
    assert panel_cuda.panel_kernel(32768, 128, jnp.bfloat16) is panel_cuda.panel_pivots_cuda


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32])
def test_kernel_matches_jnp_on_gpu(gpu, dtype):
    if gpu.compute_capability != panel_cuda.CAPABILITY:
        pytest.skip(f"the library is built for compute capability {panel_cuda.CAPABILITY}")
    m, r = 32768, 128
    p = (jax.random.uniform(jax.random.PRNGKey(0), (m, r)) * 9.9).astype(dtype)
    prev = jnp.arange(m, dtype=jnp.int32)[::-1]
    for off in (0, m // 2):
        got = jax.jit(panel_cuda.panel_pivots_cuda)(p, off, prev)
        want = jax.jit(panel_pivots_perm)(p, off, None, prev)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
