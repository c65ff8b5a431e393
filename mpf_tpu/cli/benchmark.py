"""Benchmark harness CLI — behavioral equivalent of the reference's
`benchmark.cpp:146-270`:

    python -m mpf_tpu.cli.benchmark file [-v] [--no-check] [--r R] [--policy NAME]

Per matrix in the corpus file: time the MPF factorization, time the host
LAPACK baseline (``scipy.linalg.lu_factor``, the reference's
`LAPACKE_dgetrf` at `benchmark.cpp:239-242`), check both against the P*L*U
reconstruction oracle, and append ``matrix_size,mpf_time,lapack_time`` to
``benchmark_times.csv`` (the reference CSV schema, `benchmark.cpp:168-169`)
extended with TFLOP/s and backward-error columns (SURVEY.md section 5).

``-v`` prints matrices (gated to n < 10 like the reference pretty-printers,
`benchmark.cpp:14-57`); ``--no-check`` skips the oracle.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _print_matrix(name, m):
    print(f"{name}:")
    for row in np.asarray(m):
        print("  " + " ".join(f"{v:7.3f}" for v in row))



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mpf-benchmark")
    ap.add_argument("file", help="corpus file (matrix_generator format)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--r", type=int, default=32,
                    help="panel width (reference hardcodes 32, benchmark.cpp:220)")
    ap.add_argument("--policy", default="mpf_bf16")
    ap.add_argument("--csv", default="benchmark_times.csv")
    ap.add_argument("--block", type=int, default=None,
                    help="outer block-column width (default: driver auto)")
    ap.add_argument("--super-block", default="auto",
                    help="superblock width for three-level blocking: "
                    "'auto' (default), '0' to disable, or an integer")
    ap.add_argument("--dist", metavar="PxQ", default=None,
                    help="factor on a PxQ device mesh (2D block-cyclic "
                    "distributed driver) instead of the single-chip driver; "
                    "needs P*Q visible devices (virtual CPU devices via "
                    "XLA_FLAGS=--xla_force_host_platform_device_count)")
    args = ap.parse_args(argv)

    from mpf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import scipy.linalg

    from mpf_tpu import mpf_factorize
    from mpf_tpu.precision import POLICIES
    from mpf_tpu.utils import matio
    from mpf_tpu.utils.oracle import check_factorization
    from mpf_tpu.utils.timing import time_fn, tflops

    if args.policy not in POLICIES:
        print(f"Unknown policy {args.policy!r}; choose from {sorted(POLICIES)}")
        return -1
    policy = POLICIES[args.policy]

    mesh = None
    if args.dist:
        import jax
        from mpf_tpu.parallel.mesh import make_mesh

        try:
            gp, gq = (int(v) for v in args.dist.lower().split("x"))
        except ValueError:
            print(f"--dist expects PxQ (e.g. 2x4), got {args.dist!r}")
            return -1
        if len(jax.devices()) < gp * gq:
            print(
                f"--dist {gp}x{gq} needs {gp * gq} devices, "
                f"have {len(jax.devices())}"
            )
            return -1
        mesh = make_mesh((gp, gq), devices=jax.devices()[: gp * gq])
    try:
        matrices = matio.read_matrix_file(args.file)
    except (OSError, ValueError) as e:
        print(f"Failed to read {args.file}: {e}")  # `benchmark.cpp:163-166` style
        return -1
    print(f"{len(matrices)} matrices from {args.file}; policy={policy.name} r={args.r}")

    # truncate per run like the reference (`benchmark.cpp:168`) so accumulated
    # files never carry repeated header rows
    with open(args.csv, "w") as csv:
        csv.write("matrix_size,mpf_time,lapack_time,mpf_tflops,mpf_nbe,lapack_nbe\n")
        for a in matrices:
            n = a.shape[0]
            a32 = jnp.asarray(a, dtype=jnp.float32)
            if args.verbose and n < 10:
                _print_matrix(f"A ({n}x{n})", a)

            r = min(args.r, n)
            if mesh is not None:
                from mpf_tpu.parallel.block_cyclic import (
                    check_dims, shard_block_cyclic, from_block_cyclic,
                )
                from mpf_tpu.parallel.dist_lu import make_dist_lu
                from mpf_tpu.models.mpf import MPFResult

                try:
                    check_dims(n, r, *[int(s) for s in mesh.devices.shape])
                except ValueError as e:
                    print(f"n={n}: skipped under --dist ({e})")
                    continue
                dfn = make_dist_lu(n, r, mesh, policy)
                tiles = shard_block_cyclic(a32, mesh, r)
                mpf_time = time_fn(dfn, tiles, warmup=1, iters=3)
                tl, ipiv, info, perm = dfn(tiles)
                res = MPFResult(
                    lu=from_block_cyclic(tl, n, r), ipiv=ipiv, info=info,
                    perm=perm,
                )
            else:
                sb = (None if args.super_block in ("0", "none")
                      else args.super_block if args.super_block == "auto"
                      else int(args.super_block))
                fn = lambda x: mpf_factorize(
                    x, r=r, policy=policy, block=args.block, super_block=sb)
                mpf_time = time_fn(fn, a32, warmup=1, iters=3)
                res = fn(a32)

            t0 = time.perf_counter()
            lu_ref, piv_ref = scipy.linalg.lu_factor(a)
            lapack_time = time.perf_counter() - t0

            mpf_nbe = lapack_nbe = float("nan")
            if not args.no_check:
                rep = check_factorization(
                    a, np.asarray(res.lu), np.asarray(res.ipiv), nbe_tol=1e-3
                )
                mpf_nbe = rep.normwise_backward_err
                if not rep.ok:
                    print("MPF produced incorrect results.")  # `benchmark.cpp:231`
                ipiv_l = piv_ref + 1  # scipy 0-based -> LAPACK 1-based
                rep_l = check_factorization(a, lu_ref, ipiv_l, nbe_tol=1e-3)
                lapack_nbe = rep_l.normwise_backward_err
                if args.verbose and n < 10:
                    _print_matrix("LU (mpf)", res.lu)

            print(
                f"n={n:6d}  mpf={mpf_time:.6f}s ({tflops(n, mpf_time):8.3f} TF/s)  "
                f"lapack={lapack_time:.6f}s  nbe={mpf_nbe:.2e}"
            )
            csv.write(
                f"{n},{mpf_time},{lapack_time},{tflops(n, mpf_time)},{mpf_nbe},{lapack_nbe}\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
