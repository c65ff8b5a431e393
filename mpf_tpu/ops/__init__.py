"""L1: device kernels.

``getf2``       — unblocked panel factorizations (jnp versions of the
                  reference's cooperative CUDA kernels
                  `hgetf2_kernel.cu:15-120` and `dgetf2_native_npv.cu:11-36`)
``panel_cuda``  — the pivot panel as a CUDA kernel for Hopper (XLA FFI)
``diag_triton`` — the diagonal refactor + triangular inverses as a Pallas
                  Triton kernel
``pivoting``    — LASWP-style sequential row swaps (`MPF.cu:42-59`)
``blas3``       — TRSM + trailing GEMM (the reference's cuBLAS calls,
                  `MPF.cu:215-239`)
"""
