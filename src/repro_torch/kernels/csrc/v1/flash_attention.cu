// The first version of csrc/flash_attention.cu, kept unchanged beside the redesigned
// kernel only so that chip_smoke.py (phase 6) can build both and time
// them in one call.  Nothing in the port calls it.  Its own note follows.
//
// Flash-attention forward for Hopper (sm_90a): GQA, causal, sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (its _kernel): online-softmax attention over
// q [BH, Sq, hd] and k, v [BHkv, Skv, hd], query head bh reading kv head
// bh / (BH / BHkv) without repeating K/V.  Masks: causal
// (kpos <= qpos), sliding window (kpos > qpos - window) and padding
// (kpos < Skv), with qpos = row + q_offset.  Masked scores are -1e30, not
// -inf.  The score scale hd^-0.5 is applied after the dot product, m, l and
// the accumulator are f32, the denominator is clamped at 1e-30 and the
// output is cast to q's dtype (f32 or bf16; k and v share it).
//
// Bound: operations.  At granite-8b's shape (B 2, S 4096, 32 heads, hd 128,
// causal) the kernel does ~275 GFLOP of products against ~0.2 GB of
// inputs and outputs, far above the card's ops-per-byte line.  This first
// version runs its products in f32 on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores (989 TFLOP/s bf16): it cannot come near the
// bound, and moving the two products to wgmma with TMA-fed tiles is later
// work.
//
// Design: one block of 256 threads per (bh, tile of 64 query rows); a loop
// over 64-key tiles takes the place of the TPU's sequential kv grid axis.
// The Q tile stays in shared memory as f32 for the whole loop; each K tile
// is staged, used for S = Q K^T, and then overwritten by the V tile of the
// same keys for O += P V, so shared memory holds Q, one K/V tile and P
// (145 KiB at hd 256, opted in as dynamic shared memory above 48 KiB).
// Thread t owns rows 4*(t/16) .. +3 and the columns t%16 + 16j of both S
// and O: the 16 threads of a row group are one half-warp, so the row max
// and row sum of the online softmax reduce with four shuffles.  Rows are
// padded by one float so that the column walks are free of bank
// conflicts.  hd is padded up to the next of 16, 32, 64, 128, 256 with
// zeros, which leave the products unchanged.  Ragged Sq and Skv are
// masked at the edge; nothing is padded in device memory.
//
// Tiles that are masked for every row of the block (above the causal
// diagonal, or wholly before the window) are skipped.  That is exact for
// every row with at least one unmasked key: in the reference such a tile
// only ever meets a row whose running max m is already a real score (then
// p = exp(-1e30 - m) = 0) or is still -1e30 (then its p = 1 terms are wiped
// by alpha = exp(-1e30 - m_new) = 0 when the first real key arrives).  A
// row with no unmasked key at all (possible only when q_offset or the
// window puts a row past every key) gets the average of V over the keys of
// the tiles it visited; the Pallas kernel averages over its padded 128-key
// blocks instead, and neither equals its own plain version there.  No
// model path makes such rows.
// The heaviest query tiles (last under a causal mask) are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 256;    // 16 row groups x 16 column lanes
constexpr int LDP = BKV + 1;    // padded row stride of P
constexpr float NEG = -1e30f;
static_assert(BQ == BKV, "stage() copies 64-row tiles of Q, K and V alike");

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

// Copy rows [row0, row0 + 64) of a [rows, hd] matrix into a [64][HD + 1]
// f32 tile, with zeros past the last row and past column hd.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows, int hd) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BKV * HD; i += THREADS) {
    const int r = i / HD, col = i % HD;
    float val = 0.f;
    if (row0 + r < rows && col < hd)
      val = to_f32(src[static_cast<int64_t>(row0 + r) * hd + col]);
    dst[r * LD + col] = val;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
              int hd, int group, int causal, int window, int q_offset,
              float scale) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][LD]
  float* KVs = Qs + BQ * LD;            // [BKV][LD]: K tile, then V tile
  float* Ps = KVs + BKV * LD;           // [BQ][LDP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int rg = threadIdx.x >> 4;      // rows 4*rg .. 4*rg + 3
  const int cl = threadIdx.x & 15;      // columns cl + 16 j
  const T* qb = q + static_cast<int64_t>(bh) * Sq * hd;
  const int64_t kv_off = static_cast<int64_t>(bh / group) * Skv * hd;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  stage<T, HD>(Qs, qb, q0, Sq, hd);

  // keys that some row of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + q_offset + 1);
  if (window) k_begin = max(0, q0 + q_offset - window + 1);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = (k_begin / BKV) * BKV; kt < k_end; kt += BKV) {
    __syncthreads();                    // Q staged / last V tile consumed
    stage<T, HD>(KVs, kb, kt, Skv, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * rg + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i + q_offset;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + cl + 16 * j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * rg + i) * LDP + cl + 16 * j] = s[i][j];
    }
    __syncthreads();                    // K tile consumed, P written
    stage<T, HD>(KVs, vb, kt, Skv, hd);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = KVs[kk * LD + cl + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + static_cast<int64_t>(bh) * Sq * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = cl + 16 * j;
      if (col < hd)
        ob[static_cast<int64_t>(row) * hd + col] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int hd, int group, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * (BQ * LD + BKV * LD + BQ * LDP);
  // above 48 KiB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, hd, group,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int BH, int Sq, int Skv, int hd, int group, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t s) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, o, BH, Sq, Skv, hd, group, causal, window,
                         q_offset, scale, s);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, BH, Sq, Skv, hd, group, causal, window,
                         q_offset, scale, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, BH, Sq, Skv, hd, group, causal, window,
                         q_offset, scale, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, BH, Sq, Skv, hd, group, causal,
                          window, q_offset, scale, s);
  return launch<T, 256>(q, k, v, o, BH, Sq, Skv, hd, group, causal, window,
                        q_offset, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  The wrapper
// checks devices, shapes, dtypes and contiguity before calling; the limits
// below are checked again here.  Returns the launch's cudaError_t.
extern "C" cudaError_t flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t BH,
    int64_t BHkv, int64_t Sq, int64_t Skv, int64_t hd, int causal,
    int64_t window, int64_t q_offset, float scale, int dtype,
    void* stream) {
  const int64_t lim = 1LL << 30;
  if (BH < 1 || BHkv < 1 || BH % BHkv != 0 || BH > 0x7fffffffLL ||
      Sq < 1 || Skv < 1 || Sq >= lim || Skv >= lim ||
      (Sq + 63) / 64 > 65535 || hd < 1 || hd > 256 || window < 0 ||
      window >= lim || q_offset <= -lim || q_offset >= lim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = static_cast<int>(BH / BHkv);
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, static_cast<int>(BH),
                             static_cast<int>(Sq), static_cast<int>(Skv),
                             static_cast<int>(hd), group, causal,
                             static_cast<int>(window),
                             static_cast<int>(q_offset), scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(
          q, k, v, o, static_cast<int>(BH), static_cast<int>(Sq),
          static_cast<int>(Skv), static_cast<int>(hd), group, causal,
          static_cast<int>(window), static_cast<int>(q_offset), scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
