"""Three-level (superblock) driver blocking: far trailing updates are
deferred to once per superblock (one wide k=S GEMM) instead of once per
block, cutting the dominant A22 read-modify-write memory traffic ~S/block x.
Results must stay oracle-correct and (in fp32) pivot-identical to the
two-level driver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpf_tpu import mpf_factorize, MPF_BF16, PURE_FP32
from mpf_tpu.models.mpf import _resolve_super
from mpf_tpu.utils import matgen
from mpf_tpu.utils.oracle import check_factorization

pytestmark = pytest.mark.slow


@pytest.mark.parametrize(
    "n,r,block,S",
    [
        (512, 64, 64, 256),     # full superblocks
        (640, 64, 128, 256),    # partial last superblock
        (300, 32, 64, 128),     # non-aligned n
    ],
)
def test_superblock_oracle(n, r, block, S):
    a = matgen.random_dense(n, seed=n)
    for pol, tol in ((PURE_FP32, 1e-6), (MPF_BF16, 1e-3)):
        res = mpf_factorize(
            jnp.asarray(a, jnp.float32), r=r, policy=pol, block=block,
            super_block=S,
        )
        rep = check_factorization(
            a.astype(np.float64), np.asarray(res.lu), np.asarray(res.ipiv),
            nbe_tol=tol,
        )
        assert rep.ok, str(rep)


def test_superblock_fp32_pivot_invariance():
    """fp32 pivots are invariant to the update deferral window (the update
    CONTENT is identical; only fp32 GEMM accumulation grouping differs)."""
    a = matgen.random_dense(512, seed=3)
    r1 = mpf_factorize(jnp.asarray(a, jnp.float32), r=64, policy=PURE_FP32,
                       block=64, super_block=256)
    r0 = mpf_factorize(jnp.asarray(a, jnp.float32), r=64, policy=PURE_FP32,
                       block=64, super_block=None)
    np.testing.assert_array_equal(np.asarray(r1.ipiv), np.asarray(r0.ipiv))
    np.testing.assert_allclose(
        np.asarray(r1.lu), np.asarray(r0.lu), rtol=1e-3, atol=5e-3
    )


def test_resolve_super():
    # auto resolves to DISABLED; explicit values still work
    assert _resolve_super(32768, 1024, "auto") is None
    assert _resolve_super(8192, 1024, "auto") is None
    assert _resolve_super(2048, 1024, "auto") is None
    # explicit
    assert _resolve_super(32768, 1024, None) is None
    assert _resolve_super(32768, 1024, 8192) == 8192
    # invalid explicit values degrade to disabled, never crash
    assert _resolve_super(32768, 1024, 1536) is None   # not a block multiple
    assert _resolve_super(32768, 1024, 1024) is None   # == block
    assert _resolve_super(4096, 1024, 4096) is None    # n < 2*S


def test_resolve_super_env(monkeypatch):
    monkeypatch.setenv("MPF_SUPER", "0")
    assert _resolve_super(32768, 1024, "auto") is None
    monkeypatch.setenv("MPF_SUPER", "8192")
    assert _resolve_super(32768, 1024, "auto") == 8192
    monkeypatch.setenv("MPF_SUPER", "auto")
    assert _resolve_super(32768, 1024, None) is None
