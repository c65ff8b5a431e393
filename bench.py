"""Headline benchmark: single-device LU TFLOP/s (2n^3/3) with the default
mixed-precision policy, vs XLA's built-in LU on the same device.

Prints ONE JSON line (< 2 KB) as the LAST stdout line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The reference publishes no numbers (BASELINE.md) — its benchmark harness
times MPF vs LAPACKE_dgetrf per matrix (`benchmark.cpp:219-242`).  Here the
baseline is ``jax.scipy.linalg.lu_factor`` (XLA's own LU, cuSOLVER on the
GPU) on identical hardware, input and n: vs_baseline > 1 means this library
factors faster.  Rates are also given as a share of a large bf16 GEMM
measured in the same process.

Every leg runs in this one process and either yields its number or raises:
a failed leg prints its error and the process exits non-zero.  Timings end
in ``block_until_ready``; compile time is excluded (warm-up) and matrices
are generated on the device outside the timed region.  Needs a GPU.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import mpf_tpu
from mpf_tpu.precision import ALL_BF16, MPF_BF16
from mpf_tpu.utils import matgen
from mpf_tpu.utils.compile_cache import enable_compile_cache
from mpf_tpu.utils.oracle import check_factorization, solve_residual
from mpf_tpu.utils.timing import time_fn, tflops

IR_TOL = 1e-6  # fp64 backward error of the refined solution


def _measure_factor(n, r, block, policy, gen):
    """Seconds per factorization (median of 3, input donated and
    regenerated on the device before each run)."""
    fac = mpf_tpu.make_mpf(n, r=r, policy=policy, block=block, donate=True)
    return time_fn(fac, setup=lambda: (gen(n, seed=0),), warmup=1, iters=3)


def _measure_gemm_rate(k=8192, iters=24):
    """bf16 GEMM rate (TFLOP/s) of this device, measured in-run: a chained
    y := y @ I bf16 product (runtime identity — XLA cannot fold it) of
    2k^3 flops per iteration."""
    x = jnp.eye(k, dtype=jnp.bfloat16)
    y0 = jnp.full((k, k), 0.5, jnp.bfloat16)

    @jax.jit
    def loop(y):
        def body(i, y):
            return jax.lax.dot(y, x, preferred_element_type=jnp.float32
                               ).astype(jnp.bfloat16)
        return jax.lax.fori_loop(0, iters, body, y)

    secs = time_fn(loop, y0, warmup=1, iters=2)
    return 2 * k**3 * iters / secs / 1e12


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found '{dev.platform}'", file=sys.stderr)
        return 1
    enable_compile_cache()
    n = int(os.environ.get("BENCH_N", "32768"))
    r = int(os.environ.get("BENCH_R", "128"))
    block = int(os.environ["BENCH_BLOCK"]) if os.environ.get("BENCH_BLOCK") else None
    policy = MPF_BF16

    secs = _measure_factor(n, r, block, policy, matgen.hpl_ai_matrix_device)
    ours = tflops(n, secs)
    uni_secs = _measure_factor(n, r, block, policy, matgen.random_dense_device)

    # correctness gate on a smaller instance (full oracle is O(n^3) on host)
    n_chk = 2048
    a_chk = matgen.hpl_ai_matrix(n_chk, seed=1)
    res_chk = mpf_tpu.mpf_factorize(jnp.asarray(a_chk), r=r, policy=policy, block=block)
    rep = check_factorization(
        a_chk, np.asarray(res_chk.lu), np.asarray(res_chk.ipiv), nbe_tol=1e-3
    )

    # IR gate (BASELINE.json config 3): solution backward error after <=3
    # Richardson sweeps on the bf16-GEMM factors must reach O(eps_fp32)
    b_chk = np.ones(n_chk, np.float32)
    ir = mpf_tpu.ir_solve(jnp.asarray(a_chk), res_chk.lu, res_chk.ipiv,
                          jnp.asarray(b_chk), sweeps=3, perm=res_chk.perm)
    ir_be = solve_residual(a_chk, np.asarray(ir.x), b_chk)

    # baseline: XLA's built-in LU at the same n on the same device
    base_fn = jax.jit(jax.scipy.linalg.lu_factor)
    bsecs = time_fn(base_fn, matgen.hpl_ai_matrix_device(n, seed=0))
    base = tflops(n, bsecs)

    # north star (BASELINE.md): ALL_BF16 at n=65536 on both corpora
    ns_n = int(os.environ.get("BENCH_NORTHSTAR_N", "65536"))
    ns_block = int(os.environ.get("BENCH_NORTHSTAR_BLOCK", "1024"))
    ns_tflops = ns_uni_tflops = None
    if ns_n:
        ns_tflops = tflops(ns_n, _measure_factor(
            ns_n, r, ns_block, ALL_BF16, matgen.hpl_ai_matrix_device))
        ns_uni_tflops = tflops(ns_n, _measure_factor(
            ns_n, r, ns_block, ALL_BF16, matgen.random_dense_device))

    # flagship-size end-to-end solve: factor + 3-sweep Richardson IR
    solve_secs = None
    if os.environ.get("BENCH_SOLVE", "1") == "1":
        rhs = jnp.ones((n,), jnp.float32)
        solve_secs = time_fn(
            lambda a: mpf_tpu.mpf_solve(a, rhs, r=r, policy=policy).x,
            matgen.hpl_ai_matrix_device(n, seed=0), warmup=1, iters=2)

    gemm_tflops = _measure_gemm_rate()

    out = {
        "metric": f"LU TFLOP/s/device (2n^3/3), n={n}, r={r}, policy={policy.name}",
        "value": round(ours, 3),
        "unit": "TFLOP/s",
        "seconds": round(secs, 4),
        "uniform_seconds": round(uni_secs, 4),
        "pct_of_bf16_gemm": round(100.0 * ours / gemm_tflops, 1),
        "bf16_gemm_tflops": round(gemm_tflops, 1),
        "vs_baseline": round(ours / base, 3),
        "baseline": f"jax.scipy.linalg.lu_factor same device n={n}: {round(base, 3)} TFLOP/s",
        "northstar_n": ns_n or None,
        "northstar_tflops": round(ns_tflops, 3) if ns_tflops else None,
        "northstar_uniform_tflops": round(ns_uni_tflops, 3) if ns_uni_tflops else None,
        "solve_seconds_flagship": round(solve_secs, 4) if solve_secs else None,
        "oracle_nbe_n2048": rep.normwise_backward_err,
        "oracle_ok": rep.ok,
        "ir_backward_error_3sweeps": ir_be,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    sys.stdout.flush()
    print(json.dumps(out))
    failed = [msg for ok, msg in (
        (rep.ok, f"oracle nbe {rep.normwise_backward_err:.3e} > 1e-3"),
        (ir_be <= IR_TOL, f"IR backward error {ir_be:.3e} > {IR_TOL:g}"),
    ) if not ok]
    for msg in failed:
        print(f"bench.py: gate failed: {msg}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
