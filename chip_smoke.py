#!/usr/bin/env python3
"""Smoke run of mpf_tpu's main path on an NVIDIA GPU.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --chips 4    # only the four-card path (2x2 mesh)

One card, in this order (each phase checks its own results):

  device   platform, device kind and count, nvidia-smi name and power limit
  kernels  the CUDA pivot panel and the Triton diagonal refactor at their
           real widths (m=32768, r=128) against their jnp versions
  oracle   fp64 host oracle of make_mpf at n=4096 on both corpora
  ir       3-sweep refinement at n=8192 (hpl): fp64 backward error
  factor   make_mpf(32768, r=128, MPF_BF16) on both corpora: compile time,
           steady median of 3, peak device memory
  solve    mpf_solve at n=32768, 3 sweeps
  equil    solve(equilibrate=True) on a kappa=1e6 matrix at n=4096
  batched  batched_factorize on 512 x 256^2, oracle on a few members

``--chips 4`` runs only dist_factorize on a 2x2 mesh of four cards and what
it is compared with.  Any failed check raises, so the process exits non-zero;
the last line of a passing run is one JSON object naming the device.  The
script refuses to run where JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time

NBE_TOL = 1e-3    # fp64 oracle ||PLU - A|| / (n ||A||) for bf16-GEMM factors
IR_TOL = 1e-6     # fp64 backward error of the refined solution
K2_TOL = 1e-5     # relative error of the Triton diagonal refactor vs jnp


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def gpu_info() -> str:
    """nvidia-smi's name and power limit of every card, read without JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (out.stdout or out.stderr).strip()


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def _peak_bytes(dev) -> int | None:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _panels(m: int, r: int, seed: int = 0):
    """(m, r) fp32 panels of both corpora: hpl (diagonal dominant) and the
    reference's uniform [0, 9.9] distribution."""
    import jax
    import jax.numpy as jnp

    ku, kh = jax.random.split(jax.random.PRNGKey(seed))
    uni = jax.random.uniform(ku, (m, r), jnp.float32) * 9.9
    hpl = jax.random.uniform(kh, (m, r), jnp.float32) - 0.5
    eye = jax.lax.broadcasted_iota(jnp.int32, (m, r), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (m, r), 1)
    return {"hpl": jnp.where(eye, hpl + m / 4.0, hpl), "uniform": uni}


def phase_kernels(m: int = 32768, r: int = 128) -> dict:
    """Each hand-written kernel at its real widths against its jnp version:
    the CUDA pivot panel must give identical pivots and row maps for every
    panel dtype, both corpora and two diagonal offsets; the Triton diagonal
    refactor must agree to K2_TOL (relative, Frobenius) and give the same
    ``info``.  On the GPU the kernels must be the ones selected."""
    import jax
    import jax.numpy as jnp

    from mpf_tpu.ops.diag_triton import (
        diag_kernel, getf2_npv_inv_jnp, getf2_npv_inv_triton)
    from mpf_tpu.ops.getf2 import panel_pivots_perm
    from mpf_tpu.ops.panel_cuda import panel_kernel, panel_pivots_cuda

    gpu = jax.default_backend() == "gpu"
    panels = _panels(m, r)
    prev = jnp.arange(m, dtype=jnp.int32)[::-1]
    ref = jax.jit(lambda p, o, pp: panel_pivots_perm(p, row_offset=o, prev_perm=pp))
    out = {}
    for dt in (jnp.bfloat16, jnp.float16, jnp.float32):
        kern = panel_kernel(m, r, dt)
        check(kern is (panel_pivots_cuda if gpu else panel_pivots_perm),
              f"pivot panel selection for ({m}, {r}) {jnp.dtype(dt).name}")
        kj = jax.jit(lambda p, o, pp, kern=kern: kern(p, row_offset=o, prev_perm=pp))
        for corpus, pan in panels.items():
            for off in (0, m // 2):
                p = pan.astype(dt)
                got = kj(p, jnp.int32(off), prev)
                want = ref(p, jnp.int32(off), prev)
                same = all(bool(jnp.array_equal(g, w)) for g, w in zip(got, want))
                log(f"K1 pivot panel {jnp.dtype(dt).name} {corpus} m={m} r={r} "
                    f"offset={off}: pivots and row maps identical={same} "
                    "(tolerance: exact)")
                check(same, f"K1 {jnp.dtype(dt).name} {corpus} offset {off}")
                out[f"k1_{jnp.dtype(dt).name}_{corpus}_{off}"] = same

    check(diag_kernel(jnp.float32, r) is (
        getf2_npv_inv_triton if gpu else getf2_npv_inv_jnp), "diag refactor selection")
    k2 = jax.jit(functools.partial(getf2_npv_inv_triton, interpret=not gpu))

    @jax.jit
    def k2_ref(d):
        with jax.default_matmul_precision("highest"):
            return getf2_npv_inv_jnp(d)

    for corpus, pan in panels.items():
        _, perm = ref(pan.astype(jnp.bfloat16), jnp.int32(0), jnp.arange(m, dtype=jnp.int32))[:2]
        diag = jnp.take(pan, perm, axis=0)[:r]  # the pre-pivoted diagonal block
        got, want = k2(diag), k2_ref(diag)
        rel = [float(jnp.linalg.norm(g - w) / jnp.linalg.norm(w))
               for g, w in zip(got[:3], want[:3])]
        log(f"K2 diag refactor r={r} {corpus}: rel err lu={rel[0]:.3e} "
            f"linv={rel[1]:.3e} uinv={rel[2]:.3e} (tolerance {K2_TOL:g}, "
            f"jnp at Precision.HIGHEST), info {int(got[3])} vs {int(want[3])}")
        check(max(rel) <= K2_TOL and int(got[3]) == int(want[3]), f"K2 {corpus}")
        out[f"k2_{corpus}_rel"] = max(rel)
    zero = jnp.triu(jnp.ones((r, r), jnp.float32)).at[r // 3, r // 3].set(0.0)
    zi = (int(k2(zero)[3]), int(k2_ref(zero)[3]))
    log(f"K2 zero-pivot block: info {zi[0]} vs {zi[1]} (tolerance: exact)")
    check(zi[0] == zi[1] == r // 3 + 1, "K2 zero-pivot info")
    out["k2_zero_info"] = zi[0]
    return out


def phase_oracle(n: int = 4096, r: int = 128) -> dict:
    """make_mpf on both corpora, checked by the fp64 host oracle."""
    import numpy as np

    from mpf_tpu import MPF_BF16, make_mpf
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.oracle import check_factorization

    fac = make_mpf(n, r=r, policy=MPF_BF16, donate=False)
    out = {}
    for corpus, gen in (("hpl", matgen.hpl_ai_matrix_device),
                        ("uniform", matgen.random_dense_device)):
        a = gen(n, seed=1)
        res = fac(a)
        rep = check_factorization(np.asarray(a), np.asarray(res.lu),
                                  np.asarray(res.ipiv), nbe_tol=NBE_TOL)
        log(f"oracle n={n} {corpus} MPF_BF16: nbe={rep.normwise_backward_err:.3e} "
            f"(tolerance {NBE_TOL:g}, fp64 host) info={int(res.info)}")
        check(rep.ok and int(res.info) == 0, f"oracle {corpus}")
        out[corpus] = rep.normwise_backward_err
    return out


def phase_ir(n: int = 8192, r: int = 128) -> dict:
    """Three Richardson sweeps on the MPF_BF16 factors of an hpl matrix:
    fp64 backward error of the refined solution, and no divergence."""
    import jax.numpy as jnp
    import numpy as np

    from mpf_tpu import MPF_BF16, ir_solve, make_mpf
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.oracle import solve_residual

    a = matgen.hpl_ai_matrix_device(n, seed=2)
    res = make_mpf(n, r=r, policy=MPF_BF16, donate=False)(a)
    b = jnp.ones((n,), jnp.float32)
    ir = ir_solve(a, res.lu, res.ipiv, b, sweeps=3, perm=res.perm)
    be = solve_residual(np.asarray(a), np.asarray(ir.x), np.asarray(b))
    log(f"IR n={n} hpl MPF_BF16 3 sweeps: backward error {be:.3e} (tolerance "
        f"{IR_TOL:g}, fp64 host; residuals fp32 at HIGHEST) diverged="
        f"{bool(ir.diverged)} residual norms {np.asarray(ir.residual_norms).tolist()}")
    check(be <= IR_TOL and not bool(ir.diverged), "IR backward error")
    return {"be": be}


def phase_factor(n: int = 32768, r: int = 128, runs: int = 3) -> dict:
    """make_mpf(n, r, MPF_BF16) on both corpora: compile time (set-up),
    steady median of ``runs`` donated runs, peak device memory."""
    import jax
    import jax.numpy as jnp

    from mpf_tpu import MPF_BF16, make_mpf
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.timing import tflops

    dev = jax.devices()[0]
    fac = make_mpf(n, r=r, policy=MPF_BF16)
    t0 = time.perf_counter()
    compiled = fac.lower(jax.ShapeDtypeStruct((n, n), jnp.float32)).compile()
    compile_s = time.perf_counter() - t0
    log(f"factor n={n} r={r} MPF_BF16: compile {compile_s:.2f} s (set-up); "
        f"memory_analysis: {compiled.memory_analysis()}")
    out = {"compile_s": compile_s}
    iota = jnp.arange(n, dtype=jnp.int32)
    for corpus, gen in (("hpl", matgen.hpl_ai_matrix_device),
                        ("uniform", matgen.random_dense_device)):
        times = []
        for seed in range(runs):
            a = jax.block_until_ready(gen(n, seed=seed))
            dt, res = _timed(compiled, a)
            times.append(dt)
        ok = (int(res.info) == 0 and bool(jnp.isfinite(res.lu).all())
              and bool(jnp.array_equal(jnp.sort(res.perm), iota)))
        med = statistics.median(times)
        log(f"factor n={n} {corpus}: steady median {med:.4f} s of {runs} runs "
            f"{[round(t, 4) for t in times]} ({tflops(n, med):.2f} TFLOP/s by 2n^3/3), "
            f"peak_bytes_in_use {_peak_bytes(dev)}, info={int(res.info)}")
        check(ok, f"factor {corpus}: info 0, finite factors, perm a permutation")
        out[corpus] = med
    return out


def phase_solve(n: int = 32768, r: int = 128) -> dict:
    """mpf_solve (factor + 3 Richardson sweeps) at n on an hpl matrix."""
    import jax.numpy as jnp
    import numpy as np

    from mpf_tpu import MPF_BF16, mpf_solve
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.oracle import solve_residual

    a = matgen.hpl_ai_matrix_device(n, seed=3)
    b = jnp.ones((n,), jnp.float32)
    first, _ = _timed(lambda: mpf_solve(a, b, r=r, policy=MPF_BF16, sweeps=3))
    steady, out = _timed(lambda: mpf_solve(a, b, r=r, policy=MPF_BF16, sweeps=3))
    norms = np.asarray(out.residual_norms)
    be = solve_residual(np.asarray(a), np.asarray(out.x), np.asarray(b))
    log(f"solve n={n} hpl MPF_BF16 3 sweeps: first call {first:.2f} s (compile + run), "
        f"steady {steady:.4f} s, backward error {be:.3e} (tolerance {IR_TOL:g}, fp64 "
        f"host), residual norms {norms.tolist()}")
    check(np.isfinite(norms).all() and norms[-1] < norms[0] and be <= IR_TOL,
          "solve: refinement reduces the residual to the tolerance")
    return {"be": be, "steady_s": steady}


def phase_equilibrate(n: int = 4096, kappa: float = 1e6) -> dict:
    """solve(equilibrate=True) on a kappa=1e6 matrix; the backward error
    must reach solve()'s own target, after escalation if needed."""
    import jax.numpy as jnp
    import numpy as np

    from mpf_tpu import solve
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.oracle import solve_residual

    a = matgen.random_conditioned(n, kappa, seed=4)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    x, info = solve(jnp.asarray(a), jnp.asarray(b), equilibrate=True)
    be = solve_residual(a, np.asarray(x), b)
    log(f"equilibrated solve n={n} kappa={kappa:g}: path {info['path']}, backward "
        f"error {be:.3e} (tolerance {IR_TOL:g}, fp64 host), diverged={info['diverged']}")
    check(np.isfinite(np.asarray(x)).all() and be <= IR_TOL, "equilibrated solve")
    return {"be": be, "path": info["path"]}


def phase_batched(batch: int = 512, n: int = 256, r: int = 128, members=(0, 1, -1)) -> dict:
    """batched_factorize on (batch, n, n) uniform matrices, oracle on a few."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpf_tpu import MPF_BF16, batched_factorize
    from mpf_tpu.utils.oracle import check_factorization

    a = jax.random.uniform(jax.random.PRNGKey(5), (batch, n, n), jnp.float32) * 9.9
    fn = functools.partial(batched_factorize, r=r, policy=MPF_BF16)
    first, _ = _timed(fn, a)
    steady, res = _timed(fn, a)
    a_h, lu, ipiv = np.asarray(a), np.asarray(res.lu), np.asarray(res.ipiv)
    nbes = [check_factorization(a_h[i], lu[i], ipiv[i], nbe_tol=NBE_TOL) for i in members]
    log(f"batched {batch} x {n}^2 MPF_BF16: first call {first:.2f} s, steady "
        f"{steady:.4f} s, oracle nbe of members {list(members)}: "
        f"{[f'{x.normwise_backward_err:.3e}' for x in nbes]} (tolerance {NBE_TOL:g})")
    check(all(x.ok for x in nbes), "batched oracle")
    return {"nbe": [x.normwise_backward_err for x in nbes], "steady_s": steady}


def phase_dist(n: int = 16384, b: int = 256, n_small: int = 4096, cards: int = 4) -> dict:
    """dist_factorize on a 2x2 mesh over ``cards`` devices against the
    single-device driver: placement, fp64 oracle at n_small on both corpora,
    3-sweep distributed refinement at n, and pivot agreement."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpf_tpu import MPF_BF16, PURE_FP32, mpf_factorize
    from mpf_tpu.parallel.block_cyclic import from_block_cyclic, shard_block_cyclic
    from mpf_tpu.parallel.dist_lu import dist_factorize, make_dist_lu
    from mpf_tpu.parallel.dist_solve import make_dist_ir_solve
    from mpf_tpu.parallel.mesh import make_mesh
    from mpf_tpu.utils import matgen
    from mpf_tpu.utils.oracle import check_factorization, solve_residual

    devs = jax.devices()[:cards]
    check(len(devs) == 4, f"four devices for a 2x2 mesh, found {len(devs)}")
    mesh = make_mesh((2, 2), devices=devs)
    out = {}

    a = matgen.hpl_ai_matrix_device(n, seed=6)
    tiles = shard_block_cyclic(a, mesh, b)
    fn = make_dist_lu(n, b, mesh, MPF_BF16)
    first, (t_lu, ipiv, info, perm) = _timed(fn, tiles)
    steady, _ = _timed(fn, tiles)
    placed = sorted(str(s.device) for s in t_lu.addressable_shards)
    peaks = [_peak_bytes(d) for d in devs]
    log(f"dist n={n} b={b} 2x2 MPF_BF16 hpl: first call {first:.2f} s, steady "
        f"{steady:.4f} s, shards on {placed}, peak_bytes_in_use per card {peaks}")
    # memory statistics exist on the GPU (the CPU backend reports none)
    check(len(set(placed)) == 4 and all(p > 0 for p in peaks if p is not None),
          "one shard on each of the four cards")
    out.update(first_s=first, steady_s=steady, placed=placed)

    rhs = jnp.ones((n,), jnp.float32)
    x, _, _ = make_dist_ir_solve(n, b, mesh, sweeps=3)(tiles, t_lu, perm, rhs)
    be = solve_residual(np.asarray(a), np.asarray(x), np.asarray(rhs))
    log(f"dist IR n={n} 3 sweeps: backward error {be:.3e} (tolerance {IR_TOL:g}, fp64 host)")
    check(be <= IR_TOL, "dist IR backward error")
    out["ir_be"] = be

    single = mpf_factorize(a, block=b, policy=MPF_BF16)
    share = float(jnp.mean(single.ipiv == ipiv))
    log(f"pivot agreement dist vs one card (mpf_factorize block={b}) n={n} hpl "
        f"MPF_BF16: {share:.4f} of pivots identical")
    out["share_bf16_hpl"] = share

    for corpus, gen in (("hpl", matgen.hpl_ai_matrix_device),
                        ("uniform", matgen.random_dense_device)):
        a_s = gen(n_small, seed=7)
        res = dist_factorize(a_s, mesh, b=b, policy=MPF_BF16)
        rep = check_factorization(np.asarray(a_s), np.asarray(res.lu),
                                  np.asarray(res.ipiv), nbe_tol=NBE_TOL)
        log(f"dist oracle n={n_small} {corpus} MPF_BF16: nbe "
            f"{rep.normwise_backward_err:.3e} (tolerance {NBE_TOL:g}, fp64 host)")
        check(rep.ok, f"dist oracle {corpus}")
        out[f"nbe_{corpus}"] = rep.normwise_backward_err
        d32 = dist_factorize(a_s, mesh, b=b, policy=PURE_FP32)
        s32 = mpf_factorize(a_s, r=b, block=b, policy=PURE_FP32)
        share = float(jnp.mean(d32.ipiv == s32.ipiv))
        log(f"pivot agreement dist vs one card (mpf_factorize r=block={b}) "
            f"n={n_small} {corpus} PURE_FP32: {share:.4f} of pivots identical "
            "(tolerance: exact)")
        check(share == 1.0, f"PURE_FP32 {corpus} pivots identical to one card")
        out[f"share_fp32_{corpus}"] = share
    tl = from_block_cyclic(t_lu, n, b)
    check(bool(jnp.isfinite(tl).all()) and int(info) == 0, "dist factors finite, info 0")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card dist_factorize path")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU, JAX found '{dev.platform}'", file=sys.stderr)
        return 1

    from mpf_tpu.utils.compile_cache import enable_compile_cache

    t_start = time.perf_counter()
    log(f"compile cache: {enable_compile_cache()}")
    log(f"device: {dev.platform} {dev.device_kind}, {len(jax.devices())} device(s)")
    log(f"nvidia-smi name, power.limit: {gpu_info()}")
    if args.chips == 4:
        phases = [("dist", phase_dist)]
    else:
        phases = [("kernels", phase_kernels), ("oracle", phase_oracle), ("ir", phase_ir),
                  ("factor", phase_factor), ("solve", phase_solve),
                  ("equil", phase_equilibrate), ("batched", phase_batched)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    count = 4 if args.chips == 4 else len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
