// Pre-pivoting panel LU for Hopper, called from JAX through the XLA FFI.
//
// The low-precision panel factorization of the MPF scheme (the reference's
// HGETF2_kernel, hgetf2_kernel.cu:15-120): partial-pivoted LU of an (m, r)
// panel in the panel dtype, of which only the pivots escape.  It mirrors
// mpf_tpu.ops.getf2.panel_pivots_perm operation for operation, so the pivots
// are identical to it:
//   * |column j| over rows >= d = row_offset + j, ties to the lowest row;
//   * rows d and the pivot row are swapped and the row map is updated;
//   * multipliers are fp32 quotients rounded to the panel dtype;
//   * the rank-1 update rounds the product and then the difference to the
//     panel dtype, as XLA computes the two panel-dtype operations.
//
// One persistent cooperative kernel per panel, one block per SM.  Each block
// keeps a contiguous slice of the active rows [row_offset, m) in shared
// memory for the whole panel.  Per column: a block-local argmax, one grid
// barrier, a redundant reduction of the per-block candidates in every block,
// the two swapped rows staged through global memory, a second grid barrier,
// and the block-local rank-1 update.
//
// Build: make -C native cuda   (see native/Makefile).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;   // candidate slots in the scratch buffer
constexpr int kMinRowsPerBlock = 32;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
};

// Row stride in elements: an odd number of 32-bit words, so that a column
// walk over consecutive rows hits distinct shared-memory banks.
__host__ __device__ inline int row_stride(int r, int elem_bytes) {
  int words = (r * elem_bytes + 3) / 4;
  if (words % 2 == 0) words += 1;
  return words * 4 / elem_bytes;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

inline size_t smem_bytes(int rows_cap, int r, int elem_bytes) {
  return align16(size_t(rows_cap) * row_stride(r, elem_bytes) * elem_bytes) +
         size_t(r + rows_cap + 2 * kWarps) * 4;
}

// Launch geometry: one block per SM (fewer for short panels), each keeping
// rows_cap rows of the panel in shared memory.  The Python selection asks
// MpfPanelFits, which uses the same function, whether a panel fits.
struct Geometry {
  int blocks;
  int rows_cap;
  size_t smem;
};

inline Geometry geometry(int m, int r, int elem_bytes, int sms) {
  int nblk = (m + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  nblk = nblk < sms ? nblk : sms;
  nblk = nblk < kMaxBlocks ? nblk : kMaxBlocks;
  nblk = nblk > 1 ? nblk : 1;
  const int rows_cap = (m + nblk - 1) / nblk;
  return {nblk, rows_cap, smem_bytes(rows_cap, r, elem_bytes)};
}

inline size_t scratch_bytes(int r) { return size_t(2 * kMaxBlocks + 2 * r) * 4; }

// SM count and the shared memory one block may opt in to, of the current device.
inline cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Larger |value| wins; equal values go to the lower row.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, o);
    int oi = __shfl_down_sync(0xffffffffu, i, o);
    better(v, i, ov, oi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_pivots_kernel(const T* __restrict__ panel, int m, int r,
                    const int* __restrict__ off_ptr, int* __restrict__ piv,
                    int* __restrict__ perm, float* cand_val, int* cand_idx,
                    float* pivrow, float* drow, int rows_cap) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_pj;
  const int ld = row_stride(r, sizeof(T));
  T* tile = reinterpret_cast<T*>(smem);
  float* urow = reinterpret_cast<float*>(smem + align16(size_t(rows_cap) * ld * sizeof(T)));
  float* mult = urow + r;
  float* red_val = mult + rows_cap;
  int* red_idx = reinterpret_cast<int*>(red_val + kWarps);

  const int nblk = gridDim.x;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int d0 = *off_ptr;
  const int active = m - d0 > 0 ? m - d0 : 0;
  const int rpb = (active + nblk - 1) / nblk;
  const int lo = d0 + blk * rpb;
  const int hi = min(lo + rpb, m);
  const int nrows = hi > lo ? hi - lo : 0;

  for (int e = tid; e < nrows * r; e += kThreads) {
    const int i = e / r, c = e - i * r;
    tile[i * ld + c] = panel[size_t(lo + i) * r + c];
  }
  for (int g = blk * kThreads + tid; g < m; g += nblk * kThreads) perm[g] = g;
  if (blk == 0)
    for (int c = tid; c < r; c += kThreads) piv[c] = d0 + c;
  __syncthreads();

  const int ncols = min(r, active);
  for (int j = 0; j < ncols; ++j) {
    const int d = d0 + j;
    // -- block-local argmax of |column j| over rows >= d
    float bv = -2.f;
    int bi = INT_MAX;
    for (int i = max(d - lo, 0) + tid; i < nrows; i += kThreads) {
      const float v = fabsf(Cvt<T>::to_f(tile[i * ld + j]));
      if (v > bv) { bv = v; bi = lo + i; }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { red_val[warp] = bv; red_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_val[lane] : -2.f;
      bi = lane < kWarps ? red_idx[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) { cand_val[blk] = bv; cand_idx[blk] = bi; }
    }
    grid.sync();

    // -- every block reduces the candidates (L2 reads: L1 is not coherent)
    if (warp == 0) {
      bv = -2.f;
      bi = INT_MAX;
      for (int q = lane; q < nblk; q += 32) better(bv, bi, __ldcg(cand_val + q), __ldcg(cand_idx + q));
      warp_argmax(bv, bi);
      if (lane == 0) s_pj = bi;
    }
    __syncthreads();
    const int pj = s_pj;
    const int own_d = (d - d0) / rpb;
    const int own_p = (pj - d0) / rpb;
    if (blk == own_p)
      for (int c = tid; c < r; c += kThreads) pivrow[c] = Cvt<T>::to_f(tile[(pj - lo) * ld + c]);
    if (blk == own_d)
      for (int c = tid; c < r; c += kThreads) drow[c] = Cvt<T>::to_f(tile[(d - lo) * ld + c]);
    if (blk == 0 && tid == 0) {
      piv[j] = pj;
      const int a = __ldcg(perm + d), b = __ldcg(perm + pj);
      perm[d] = b;
      perm[pj] = a;
    }
    grid.sync();

    // -- swap, then multipliers and the rank-1 update on local rows > d
    for (int c = tid; c < r; c += kThreads) urow[c] = __ldcg(pivrow + c);
    __syncthreads();
    if (blk == own_d)
      for (int c = tid; c < r; c += kThreads) tile[(d - lo) * ld + c] = Cvt<T>::from_f(urow[c]);
    if (blk == own_p && pj != d)
      for (int c = tid; c < r; c += kThreads) tile[(pj - lo) * ld + c] = Cvt<T>::from_f(__ldcg(drow + c));
    __syncthreads();
    const float pivval = urow[j];
    const float safe = pivval == 0.f ? 1.f : pivval;
    const int first = max(d + 1 - lo, 0);
    for (int i = first + tid; i < nrows; i += kThreads) {
      const T mt = Cvt<T>::from_f(__fdiv_rn(Cvt<T>::to_f(tile[i * ld + j]), safe));
      mult[i] = Cvt<T>::to_f(mt);
      tile[i * ld + j] = mt;
    }
    __syncthreads();
    for (int i = first + warp; i < nrows; i += kWarps) {
      const float mv = mult[i];
      for (int c = j + 1 + lane; c < r; c += 32) {
        // product and difference each rounded to the panel dtype, as XLA
        // computes the reference's two panel-dtype ops (no fused
        // multiply-add: it would change the pivots of bf16/fp16 panels)
        const float prod = Cvt<T>::to_f(Cvt<T>::from_f(__fmul_rn(mv, urow[c])));
        tile[i * ld + c] = Cvt<T>::from_f(__fsub_rn(Cvt<T>::to_f(tile[i * ld + c]), prod));
      }
    }
    __syncthreads();
  }
}

template <typename T>
ffi::Error launch(cudaStream_t stream, const ffi::AnyBuffer& panel, int m, int r,
                  const int* off, int* piv, int* perm, void* scratch) {
  int sms = 0, optin = 0;
  if (device_limits(&sms, &optin) != cudaSuccess)
    return ffi::Error::Internal("mpf panel kernel: cannot query the device");
  const Geometry g = geometry(m, r, sizeof(T), sms);
  const int nblk = g.blocks;
  const size_t bytes = g.smem;
  if (bytes > size_t(optin))
    return ffi::Error::InvalidArgument("mpf panel kernel: panel of " + std::to_string(m) + " x " +
                                       std::to_string(r) + " needs " + std::to_string(bytes) +
                                       " bytes of shared memory per block");
  auto kern = panel_pivots_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  if (per_sm < 1) return ffi::Error::Internal("mpf panel kernel: no block fits on an SM");

  const T* a = reinterpret_cast<const T*>(panel.untyped_data());
  float* cand_val = reinterpret_cast<float*>(scratch);
  int* cand_idx = reinterpret_cast<int*>(cand_val + kMaxBlocks);
  float* pivrow = reinterpret_cast<float*>(cand_idx + kMaxBlocks);
  float* drow = pivrow + r;
  int rc = g.rows_cap;
  void* args[] = {&a, &m, &r, &off, &piv, &perm, &cand_val, &cand_idx, &pivrow, &drow, &rc};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(nblk), dim3(kThreads), args,
                                    bytes, stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error panel_pivots_impl(cudaStream_t stream, ffi::AnyBuffer panel, ffi::Buffer<ffi::S32> off,
                             ffi::Result<ffi::Buffer<ffi::S32>> piv,
                             ffi::Result<ffi::Buffer<ffi::S32>> perm,
                             ffi::Result<ffi::AnyBuffer> scratch) {
  const auto dims = panel.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("mpf panel kernel: panel must be 2-D");
  const int m = int(dims[0]), r = int(dims[1]);
  if (scratch->size_bytes() < scratch_bytes(r))
    return ffi::Error::InvalidArgument("mpf panel kernel: scratch buffer too small");
  const int* o = off.typed_data();
  int* pv = piv->typed_data();
  int* pm = perm->typed_data();
  void* s = scratch->untyped_data();
  switch (panel.element_type()) {
    case ffi::DataType::BF16: return launch<__nv_bfloat16>(stream, panel, m, r, o, pv, pm, s);
    case ffi::DataType::F16: return launch<__half>(stream, panel, m, r, o, pv, pm, s);
    case ffi::DataType::F32: return launch<float>(stream, panel, m, r, o, pv, pm, s);
    default: return ffi::Error::InvalidArgument("mpf panel kernel: panel dtype must be bf16, f16 or f32");
  }
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MpfPanelPivots, panel_pivots_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::AnyBuffer>());

// Launch sizing for the Python side (ctypes), from the functions above.
// 1 if an (m, r) panel of elem_bytes-wide elements fits the kernel on the
// current device, 0 if it does not, -1 if the device cannot be queried.
extern "C" int MpfPanelFits(int m, int r, int elem_bytes) {
  int sms = 0, optin = 0;
  if (m < 1 || r < 1 || device_limits(&sms, &optin) != cudaSuccess) return -1;
  return geometry(m, r, elem_bytes, sms).smem <= size_t(optin) ? 1 : 0;
}

// Bytes of the scratch buffer a launch for r-wide panels needs.
extern "C" long long MpfPanelScratchBytes(int r) { return (long long)scratch_bytes(r); }
