// Fused RMSNorm(+scale) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm_2d
// (its _kernel): per row, y = x * rsqrt(mean(x^2) + eps) * w, computed in
// f32 and stored in x's dtype (f32 or bf16; w has x's dtype).
//
// Bound: memory.  The kernel reads x and writes y once each, rows*d*bytes
// apiece, plus w; about 4 flops per element is far below the card's
// compute rate.  At the H100's 3.35 TB/s a [8192, 4096] bf16 call moves
// 2 * 64 MiB and is bounded near 40 us.
//
// Design: one block per row (a single warp when the row is short).  Each
// thread walks the row with 16-byte vector loads (4 f32 or 8 bf16) when the
// row and the pointers are 16-byte aligned, else element by element (any
// d; the ragged tail needs no mask beyond the loop bound).  The sum of
// squares is accumulated in f32, reduced with warp shuffles and then
// across warps in shared memory; rsqrtf(sum/d + eps) is applied in a
// second pass over the row, which re-reads x (from L1/L2 for rows of a few
// tens of KiB) and scales by w.  Making it fast (keeping the row in
// registers or shared memory, several rows per block for small d) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the block; red holds 33 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T, bool VEC>
__global__ void rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w,
                             T* __restrict__ y, int64_t d, float eps) {
  __shared__ float red[33];
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;
  using V = typename Vec16<T>::type;
  constexpr int n = Vec16<T>::n;

  float ss = 0.f;
  if (VEC) {
    const V* xv = reinterpret_cast<const V*>(xr);
    for (int64_t i = threadIdx.x; i < d / n; i += blockDim.x) {
      V p = xv[i];
      const T* e = reinterpret_cast<const T*>(&p);
#pragma unroll
      for (int k = 0; k < n; ++k) {
        const float f = to_f32(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);

  if (VEC) {
    const V* xv = reinterpret_cast<const V*>(xr);
    const V* wv = reinterpret_cast<const V*>(w);
    V* yv = reinterpret_cast<V*>(yr);
    for (int64_t i = threadIdx.x; i < d / n; i += blockDim.x) {
      V px = xv[i];
      V pw = wv[i];
      V po;
      const T* ex = reinterpret_cast<const T*>(&px);
      const T* ew = reinterpret_cast<const T*>(&pw);
      T* eo = reinterpret_cast<T*>(&po);
#pragma unroll
      for (int k = 0; k < n; ++k)
        eo[k] = from_f32<T>(to_f32(ex[k]) * r * to_f32(ew[k]));
      yv[i] = po;
    }
  } else {
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int64_t d, float eps, cudaStream_t stream) {
  constexpr int n = Vec16<T>::n;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const bool vec = aligned && d % n == 0;
  const int64_t units = vec ? d / n : d;
  const int threads =
      units >= 256 ? 256 : static_cast<int>(((units + 31) / 32) * 32);
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    rmsnorm_rows<T, true><<<grid, threads, 0, stream>>>(xt, wt, yt, d, eps);
  else
    rmsnorm_rows<T, false><<<grid, threads, 0, stream>>>(xt, wt, yt, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  rows in [1, 2^31), d >= 1; the wrapper
// checks shapes, dtypes, devices and contiguity before calling.
extern "C" cudaError_t rmsnorm_fwd(const void* x, const void* w, void* y,
                                   int64_t rows, int64_t d, float eps,
                                   int dtype, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, y, rows, d, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
