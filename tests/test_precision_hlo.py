"""Every fp32 product on the working path names HIGHEST precision: at the
default precision the GPU runs fp32 products in TF32.  Checked on the
lowered StableHLO of the factorization and the blocked solve."""

import re

import jax
import jax.numpy as jnp
import pytest

import mpf_tpu.models.solve as S
from mpf_tpu import MPF_BF16, MPF_FP16, MPF_REF, PURE_FP32, ALL_BF16, mpf_factorize
from mpf_tpu.utils import matgen


def _fp32_dots(text):
    """(all fp32 dot_generals, those without HIGHEST) of a StableHLO text."""
    dots = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    f32 = [l for l in dots if re.search(r":\s*\(tensor<[0-9x]*xf32>, tensor<[0-9x]*xf32>\)", l)]
    return f32, [l for l in f32 if "HIGHEST" not in l]


@pytest.mark.parametrize("policy", [MPF_BF16, MPF_REF, MPF_FP16, PURE_FP32, ALL_BF16],
                         ids=lambda p: p.name)
def test_factorization_fp32_dots_are_highest(policy):
    a = jnp.zeros((64, 64), jnp.float32)
    text = mpf_factorize.lower(a, r=8, policy=policy, block=32).as_text()
    f32, bad = _fp32_dots(text)
    if jnp.dtype(policy.working) == jnp.float32:
        assert f32, "the fp32-working driver has fp32 products"
    assert not bad, bad[:3]


@pytest.mark.parametrize("trans", [False, True])
def test_blocked_getrs_fp32_dots_are_highest(monkeypatch, trans):
    monkeypatch.setattr(S, "_BLOCKED_SOLVE_MIN", 64)
    monkeypatch.setattr(S, "_SOLVE_NB", 32)
    n = 128
    lu = jnp.asarray(matgen.hpl_ai_matrix(n, seed=0))
    ipiv = jnp.arange(1, n + 1, dtype=jnp.int32)
    b = jnp.ones((n, 2), jnp.float32)
    fn = jax.jit(lambda lu, ipiv, b: S.getrs.__wrapped__(lu, ipiv, b, None, trans))
    f32, bad = _fp32_dots(fn.lower(lu, ipiv, b).as_text())
    assert len(f32) >= 2 * (n // 32 - 1)
    assert not bad, bad[:3]
