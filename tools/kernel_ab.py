#!/usr/bin/env python3
"""A/B measurements of the two hand-written kernels on one NVIDIA GPU, and
the optimized-HLO counts, that PERF.md reports.

    python3 tools/kernel_ab.py kernels         # K1, K2 against jnp, kernel level
    python3 tools/kernel_ab.py e2e             # make_mpf(32768) with each kernel on/off
    python3 tools/kernel_ab.py warps 8 4 8     # K2 at these warp counts, in this order
    python3 tools/kernel_ab.py hlo             # cuBLAS calls, copies, scatters (n=8192)
    python3 tools/kernel_ab.py agree           # dist_factorize on a 1x1 mesh vs one card

K1 is the CUDA pivot panel (`ops/panel_cuda.py`), K2 the Triton diagonal
refactor (`ops/diag_triton.py`).  Every variant of one command is timed in
this one process, in the order A, B, B, A, so that drift of the card's
clock shows as disagreement between the two copies.  A time is the median
of repeated calls, each ending in ``block_until_ready``, after one untimed
call that compiles.  Every line printed is one JSON object and carries
nvidia-smi's name, power limit and SM clock at that moment.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpf_tpu import MPF_BF16, PURE_FP32, make_mpf, mpf_factorize  # noqa: E402
from mpf_tpu.ops.diag_triton import getf2_npv_inv_jnp, getf2_npv_inv_triton  # noqa: E402
from mpf_tpu.ops.getf2 import panel_pivots_perm  # noqa: E402
from mpf_tpu.ops.panel_cuda import panel_pivots_cuda  # noqa: E402
from mpf_tpu.utils import matgen  # noqa: E402
from mpf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def emit(**rec) -> None:
    print(json.dumps({**rec, "smi": smi()}), flush=True)


def median_s(fn, *args, iters: int) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def cmd_kernels(args) -> None:
    m, r = 32768, 128
    key = jax.random.PRNGKey(0)
    panel = (jax.random.uniform(key, (m, r)) * 9.9).astype(jnp.bfloat16)
    impls = {
        "jnp": jax.jit(lambda p, o: panel_pivots_perm(p, row_offset=o)),
        "k1": jax.jit(lambda p, o: panel_pivots_cuda(p, row_offset=o)),
    }
    for off in (0, m // 2, m - 2048):
        for name in ("jnp", "k1", "k1", "jnp"):
            ms = 1e3 * median_s(impls[name], panel, jnp.int32(off), iters=args.iters)
            emit(kernel="K1", impl=name, m=m, r=r, dtype="bfloat16", offset=off, ms=ms)
    diag = jax.random.uniform(key, (r, r), jnp.float32) + r * jnp.eye(r, dtype=jnp.float32)
    impls = {"jnp": jax.jit(getf2_npv_inv_jnp), "k2": getf2_npv_inv_triton}
    for name in ("jnp", "k2", "k2", "jnp") * 2:
        ms = 1e3 * median_s(impls[name], diag, iters=args.iters)
        emit(kernel="K2", impl=name, r=r, dtype="float32", ms=ms)


def cmd_e2e(args) -> None:
    n, r = args.n, 128
    configs = {  # (panel_kernel, diag_kernel); None picks the kernel
        "jnp": (panel_pivots_perm, getf2_npv_inv_jnp),
        "k1": (None, getf2_npv_inv_jnp),
        "k2": (panel_pivots_perm, None),
        "both": (None, None),
    }
    compiled = {}
    for name, (pk, dk) in configs.items():
        fac = make_mpf(n, r=r, policy=MPF_BF16, panel_kernel=pk, diag_kernel=dk)
        t0 = time.perf_counter()
        compiled[name] = fac.lower(jax.ShapeDtypeStruct((n, n), jnp.float32)).compile()
        emit(e2e="compile", cfg=name, n=n, compile_s=time.perf_counter() - t0)
    for corpus, gen in (("hpl", matgen.hpl_ai_matrix_device),
                        ("uniform", matgen.random_dense_device)):
        for name in ("jnp", "both", "k1", "k2", "k2", "k1", "both", "jnp"):
            runs = []
            for seed in range(args.runs):
                a = jax.block_until_ready(gen(n, seed=seed))
                t0 = time.perf_counter()
                jax.block_until_ready(compiled[name](a))
                runs.append(time.perf_counter() - t0)
            emit(e2e="time", cfg=name, n=n, corpus=corpus, runs_s=runs,
                 median_s=statistics.median(runs))


def cmd_warps(args) -> None:
    r = 128
    key = jax.random.PRNGKey(1)
    diag = jax.random.uniform(key, (r, r), jnp.float32) + r * jnp.eye(r, dtype=jnp.float32)
    want = jax.jit(getf2_npv_inv_jnp)(diag)
    for w in args.warps:
        t0 = time.perf_counter()
        got = jax.block_until_ready(getf2_npv_inv_triton(diag, num_warps=w))
        first_s = time.perf_counter() - t0
        ms = 1e3 * median_s(lambda d: getf2_npv_inv_triton(d, num_warps=w), diag,
                            iters=args.iters)
        rel = max(float(jnp.linalg.norm(g - x) / jnp.linalg.norm(x))
                  for g, x in zip(got[:3], want[:3]))
        emit(kernel="K2", num_warps=w, order=args.warps, first_call_s=first_s, ms=ms,
             rel_err_vs_jnp=rel)


def cmd_hlo(args) -> None:
    n = args.n
    fac = make_mpf(n, r=128, policy=MPF_BF16)
    text = fac.lower(jax.ShapeDtypeStruct((n, n), jnp.float32)).compile().as_text()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    gemms = [ln for ln in text.splitlines()
             if re.search(r'custom_call_target="__cublas\$(gemm|lt\$matmul)"', ln)]
    betas = {}
    for ln in gemms:
        beta = re.search(r'"beta":([-0-9.e]+)', ln)
        betas[beta.group(1) if beta else "none"] = betas.get(
            beta.group(1) if beta else "none", 0) + 1
    full = re.compile(rf"= f32\[{n},{n}\]\{{[0-9,]*\}} ([a-z-]+)\(")
    producers = {}
    for ln in text.splitlines():
        hit = full.search(ln)
        if hit:
            producers[hit.group(1)] = producers.get(hit.group(1), 0) + 1
    emit(hlo="make_mpf", n=n, policy="MPF_BF16", cublas_gemms=len(gemms),
         gemm_beta=betas, full_matrix_ops=producers,
         full_matrix_copies=producers.get("copy", 0))


def cmd_agree(args) -> None:
    """Pivot agreement of the distributed driver on a 1x1 mesh of this card
    with the single-device driver (same r = block = b), PURE_FP32."""
    from mpf_tpu.parallel.dist_lu import dist_factorize
    from mpf_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    for b in (128, 256):
        for corpus, gen in (("hpl", matgen.hpl_ai_matrix_device),
                            ("uniform", matgen.random_dense_device)):
            a = gen(args.n, seed=7)
            d = dist_factorize(a, mesh, b=b, policy=PURE_FP32)
            s = mpf_factorize(a, r=b, block=b, policy=PURE_FP32)
            emit(agree="dist 1x1 vs one card", n=args.n, b=b, corpus=corpus,
                 pivots_identical=float(jnp.mean(d.ipiv == s.ipiv)),
                 lu_bit_identical=bool(jnp.array_equal(d.lu, s.lu)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("kernels")
    p.add_argument("--iters", type=int, default=20)
    p = sub.add_parser("e2e")
    p.add_argument("--n", type=int, default=32768)
    p.add_argument("--runs", type=int, default=2)
    p = sub.add_parser("warps")
    p.add_argument("warps", type=int, nargs="+")
    p.add_argument("--iters", type=int, default=50)
    p = sub.add_parser("hlo")
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--out", default="")
    p = sub.add_parser("agree")
    p.add_argument("--n", type=int, default=4096)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("kernel_ab.py: needs a CUDA GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    {"kernels": cmd_kernels, "e2e": cmd_e2e, "warps": cmd_warps, "hlo": cmd_hlo,
     "agree": cmd_agree}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
