// The first version of csrc/ssd_scan.cu, kept unchanged beside the redesigned
// kernel only so that chip_smoke.py (phase 7) can build both and time
// them in one call.  Nothing in the port calls it.  Its own note follows.
//
// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (its _kernel).  For one (bh, chunk) cell with chunk length Q, head dim P
// and state dim N, in f32 (expf, not __expf):
//
//   a = dt * A,  acum = cumsum(a)                      (a block scan)
//   L[q, k]    = exp(acum[q] - acum[k]) for k <= q, else 0
//   y[q, p]    = sum_k ((C_q . B_k) * L[q, k] * dt[k]) * x[k, p]
//   state[p,n] = sum_q x[q, p] * (B[q, n] * (dt[q] * exp(acum[Q-1] - acum[q])))
//   decay      = exp(acum[Q-1])
//
// Inputs x, dt, A, B, C may each be f32 or bf16 (each is widened to f32 as
// it is read); the three outputs are f32.  Flag bit 5 rounds C_q . B_k to
// bf16 before the decay, as the model's ssd_chunked rounds its scores.
//
// Bound: about even.  At mamba2-1.3b's shape (BH 64, 32 chunks of Q 128,
// P 64, N 128) the cell reads and writes ~0.47 GB (x, B, C, y, state in
// f32) and does ~11 GFLOP of products on the lower triangle: 0.14 ms of
// bytes against 0.16 ms of f32 operations at the CUDA cores' peak.  This
// first version runs its products from shared memory on the CUDA cores and
// does not reach either; tensor-core products (C B^T and W x are small
// GEMMs) are later work.
//
// Design: one block of 256 threads per (bh, chunk).  x, B and C are staged
// whole into shared memory as f32 (B's rows padded by one float so that a
// warp reading B[k][n] at consecutive k is free of bank conflicts), plus
// dt, acum and the per-row state weights.  The weight matrix
// W = (C B^T) o L o dt_k is never held whole: it is built 2048 / Q rows at
// a time (16 at Q 128) in a small buffer, and those rows of y = W x are
// written before the next rows are built.  At Q 128, P 64, N 128 the block
// uses 171 KiB (opted in as dynamic shared memory above 48 KiB); the
// wrapper refuses shapes that do not fit the 227 KiB a block may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int W_ELEMS = 2048;           // floats in the W row buffer

// dtype flags: bit 0 x, bit 1 dt, bit 2 A, bit 3 B, bit 4 C (1 = bf16);
// bit 5: round the scores C_q . B_k to bf16
__device__ __forceinline__ float ld(const void* p, bool bf16, int64_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__host__ __device__ inline int w_rows(int Q) {
  const int r = W_ELEMS / Q;
  return r < 1 ? 1 : (r > Q ? Q : r);
}

__global__ void __launch_bounds__(THREADS)
    ssd_intra(const void* __restrict__ x, const void* __restrict__ dt,
              const void* __restrict__ A, const void* __restrict__ B,
              const void* __restrict__ C, float* __restrict__ y,
              float* __restrict__ st, float* __restrict__ dc, int chunks,
              int Q, int P, int N, int flags) {
  extern __shared__ float smem[];
  const int LDB = N + 1;
  const int G = w_rows(Q);
  float* xs = smem;                     // [Q][P]
  float* Bs = xs + Q * P;               // [Q][LDB]
  float* Cs = Bs + Q * LDB;             // [Q][N]
  float* Ws = Cs + Q * N;               // [G][Q]
  float* dts = Ws + G * Q;              // [Q]
  float* acum = dts + Q;                // [Q]
  float* coef = acum + Q;               // [Q]
  float* scr = coef + Q;                // [THREADS]

  const int cell = blockIdx.x;          // bh * chunks + chunk
  const int bh = cell / chunks;
  const int tid = threadIdx.x;
  const bool xb = flags & 1, dtb = flags & 2, ab = flags & 4,
             bb = flags & 8, cb = flags & 16;
  const int64_t base_qp = static_cast<int64_t>(cell) * Q * P;
  const int64_t base_qn = static_cast<int64_t>(cell) * Q * N;
  const int64_t base_q = static_cast<int64_t>(cell) * Q;

  for (int i = tid; i < Q * P; i += THREADS) xs[i] = ld(x, xb, base_qp + i);
  for (int i = tid; i < Q * N; i += THREADS) {
    Bs[(i / N) * LDB + i % N] = ld(B, bb, base_qn + i);
    Cs[i] = ld(C, cb, base_qn + i);
  }
  for (int i = tid; i < Q; i += THREADS) dts[i] = ld(dt, dtb, base_q + i);
  const float a_rate = ld(A, ab, bh);
  __syncthreads();

  // inclusive scan of a = dt * A, THREADS entries at a time
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += THREADS) {
    const int i = q0 + tid;
    scr[tid] = i < Q ? dts[i] * a_rate : 0.f;
    __syncthreads();
    for (int off = 1; off < THREADS; off <<= 1) {
      const float t = tid >= off ? scr[tid - off] : 0.f;
      __syncthreads();
      scr[tid] += t;
      __syncthreads();
    }
    if (i < Q) acum[i] = carry + scr[tid];
    carry += scr[THREADS - 1];
    __syncthreads();
  }
  const float a_last = acum[Q - 1];
  for (int i = tid; i < Q; i += THREADS)
    coef[i] = dts[i] * expf(a_last - acum[i]);
  if (tid == 0) dc[cell] = expf(a_last);
  __syncthreads();

  // y = W x, G rows of W at a time
  for (int r0 = 0; r0 < Q; r0 += G) {
    const int rows = min(G, Q - r0);
    for (int i = tid; i < rows * Q; i += THREADS) {
      const int qi = r0 + i / Q, kj = i % Q;
      float w = 0.f;
      if (kj <= qi) {
        const float* cr = Cs + qi * N;
        const float* br = Bs + kj * LDB;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
        if (flags & 32) dot = __bfloat162float(__float2bfloat16_rn(dot));
        w = dot * expf(acum[qi] - acum[kj]) * dts[kj];
      }
      Ws[i] = w;
    }
    __syncthreads();
    for (int i = tid; i < rows * P; i += THREADS) {
      const int ri = i / P, p = i % P;
      const float* wr = Ws + ri * Q;
      float acc = 0.f;
      for (int k = 0; k <= r0 + ri; ++k) acc = fmaf(wr[k], xs[k * P + p], acc);
      y[base_qp + static_cast<int64_t>(r0 + ri) * P + p] = acc;
    }
    __syncthreads();
  }

  // state = x^T (B o coef)
  const int64_t base_pn = static_cast<int64_t>(cell) * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i % N;
    float acc = 0.f;
    for (int q = 0; q < Q; ++q)
      acc = fmaf(xs[q * P + p], Bs[q * LDB + n] * coef[q], acc);
    st[base_pn + i] = acc;
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for (Q, P, N).
extern "C" int64_t ssd_intra_chunk_smem(int64_t Q, int64_t P, int64_t N) {
  if (Q < 1 || P < 1 || N < 1 || Q > 0x7fffffffLL) return -1;
  const int64_t G = w_rows(static_cast<int>(Q));
  return static_cast<int64_t>(sizeof(float)) *
         (Q * P + Q * (N + 1) + Q * N + G * Q + 3 * Q + THREADS);
}

// x [BH, c, Q, P], dt [BH, c, Q], A [BH], B/C [BH, c, Q, N] -> y [BH, c, Q,
// P], st [BH, c, P, N], dc [BH, c], all contiguous.  flags: see ld().  The
// wrapper checks devices, shapes, dtypes, contiguity and the shared-memory
// size before calling.  Returns the launch's cudaError_t.
extern "C" cudaError_t ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* st, void* dc, int64_t BH, int64_t chunks,
    int64_t Q, int64_t P, int64_t N, int flags, void* stream) {
  const int64_t smem = ssd_intra_chunk_smem(Q, P, N);
  if (BH < 1 || chunks < 1 || BH * chunks > 0x7fffffffLL || smem < 0 ||
      smem > 232448 || P * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_intra<<<static_cast<unsigned>(BH * chunks), THREADS,
              static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, B, C, static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(dc), static_cast<int>(chunks),
      static_cast<int>(Q), static_cast<int>(P), static_cast<int>(N), flags);
  return cudaGetLastError();
}
