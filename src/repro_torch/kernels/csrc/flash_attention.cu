// Flash-attention forward for Hopper (sm_90a) on the CUDA cores: GQA,
// causal, sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (its _kernel): online-softmax attention over
// q [BH, Sq, hd] and k, v [BHkv, Skv, hd], query head bh reading kv head
// bh / (BH / BHkv) without repeating K/V.  Masks: causal
// (kpos <= qpos), sliding window (kpos > qpos - window) and padding
// (kpos < Skv), with qpos = row + q_offset.  Masked scores are -1e30, not
// -inf.  The score scale hd^-0.5 is applied after the dot product, m, l and
// the accumulator are f32, the denominator is clamped at 1e-30 and the
// output is cast to q's dtype (f32 or bf16; k and v share it).  This
// kernel takes f32 (whose 2e-5 tolerance TF32 would break) and the bf16
// head dims the tensor-core kernel (flash_attention_tc.cu) refuses; every
// product is an exact f32 FMA, every exponential expf.
//
// Bound: operations.  At granite-8b's shape (B 2, S 4096, 32 heads, hd 128,
// causal) the call does ~275 GFLOP of products against ~0.2 GB of inputs
// and outputs: 4.1 ms at the CUDA cores' 67 TFLOP/s, against 0.06 ms of
// bytes.  Each scheduler of an SM starts one warp instruction a clock and
// an FFMA is one of them, so the kernel reaches the bound only as far as
// FFMAs fill those slots: the design keeps shared loads, exponentials,
// address arithmetic and barriers few per FFMA, and keeps enough warps
// resident to hide their latency.
//
// Design: one block per (bh, tile of 64 query rows); a loop over 64-key
// tiles takes the place of the TPU's sequential kv grid axis.  The threads
// form 8 row groups of KG (16 below hd 256, 32 at hd 256: 128 or 256
// threads); thread (rg, cg) owns rows rg + 8 i (i < 8) of S and O, keys
// cg + KG j of S (8 x 4 scores; 8 x 2 at hd 256) and KG-strided vectors of
// O's columns (8 x 8 at hd 128 and 256).  A row group is one half-warp (or
// warp), so the row max reduces with shuffles and P travels between the
// threads of a row through shared memory that only their warp touches.
//   S = Q K^T: inner products over 16-byte runs of d.  Q and K tiles are
//   stored "chunk-major", the 16 bytes of row r, columns 4c..4c+3 at
//   float4 index c * 64 + r, so a half-warp reading 16 rows at one c reads
//   256 contiguous bytes (no bank conflict) and each thread's addresses are
//   one base register plus constants.  Per 4 d: 12 16-byte loads (8 of Q,
//   broadcast in the half-warp; 4 of K) for 128 FFMAs.
//   O += P V: P is stored chunk-major too (rows rg + 8 i, 4 keys a float4);
//   per 4 keys: 8 16-byte loads of P and 8 of V (16-byte rows of V, a
//   half-warp's 16 vectors contiguous) for 256 FFMAs at hd 128.
//   The online softmax keeps the reference's order: scale, mask, row max
//   (shuffles), alpha = exp(m - m_new), p = exp(s - m_new); each thread
//   keeps its partial row sum l (alpha is uniform over the row) and the
//   row's threads add theirs at the end.  Tiles no row of the block masks
//   skip the masking.
//   K and V have buffers of their own, filled with 16-byte cp.async (f32,
//   hd % 4 == 0, 16-byte aligned q, k, v; otherwise, as for bf16, the
//   threads widen and store): V(t) is requested as S(t) starts and K(t+1) as
//   soon as S(t) is done, so each copy overlaps the other product (three
//   barriers a tile).  Shared memory is 4 (3 * 64 * hd + 64 * 64) bytes,
//   112 KiB at hd 128: two blocks (8 warps) an SM; three at hd <= 64; one
//   block of 8 warps at hd 256 (208 KiB).
// hd is padded up to the next of 16, 32, 64, 128, 256 with zeros, which
// leave the products unchanged.  Ragged Sq and Skv are masked at the edge;
// nothing is padded in device memory.
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

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BKV = 64;         // keys per tile (the tile loads copy 64 rows)
constexpr float NEG = -1e30f;
static_assert(BQ == BKV, "load_tile copies 64-row tiles of Q, K and V alike");

// The thread layout at padded head dim HD (see the head note).
template <int HD>
struct Tile {
  static constexpr int THREADS = HD > 128 ? 256 : 128;
  static constexpr int KG = THREADS / 8;    // threads of a row group
  static constexpr int KJ = BKV / KG;       // keys of S per thread
  static constexpr int OC = HD / KG;        // columns of O per thread
  static constexpr int VW = OC < 4 ? OC : 4;  // ... read VW at a time
  static constexpr int NC = HD / 4;         // 16-byte runs of a row
  static constexpr int MIN_BLOCKS = HD > 128 ? 1 : (HD > 64 ? 2 : 3);
  static constexpr size_t SMEM = sizeof(float) * (3 * BQ * HD + BQ * BKV);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [rows, hd] matrix into a 64 x HD f32 tile,
// zeros past the last row and past column hd.  CHUNKED: chunk-major (the
// 16 bytes of row r, columns 4c..4c+3, at float4 index c * 64 + r), else
// row-major.  ASYNC: 16-byte cp.async (f32, hd % 4 == 0, 16-byte aligned
// rows), a warp taking 8 rows x 4 runs of a chunk-major tile (64-byte
// global runs, stores free of bank conflicts); otherwise the threads load,
// widen and store.
template <typename T, int HD, bool ASYNC, bool CHUNKED>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int rows, int hd) {
  constexpr int THREADS = Tile<HD>::THREADS, NC = HD / 4;
  if constexpr (ASYNC) {
    static_assert(std::is_same<T, float>::value, "cp.async copies f32");
#pragma unroll 2
    for (int it = 0; it < BKV * NC / THREADS; ++it) {
      const int e = it * THREADS + static_cast<int>(threadIdx.x);
      int r, c;
      if constexpr (CHUNKED) {
        const int lane = e & 31, blk = e >> 5;
        r = (blk / (NC / 4)) * 8 + (lane & 7);
        c = (blk % (NC / 4)) * 4 + (lane >> 3);
      } else {
        r = e / NC;
        c = e % NC;
      }
      const bool in = row0 + r < rows && 4 * c < hd;
      const float* g =
          src + (in ? static_cast<int64_t>(row0 + r) * hd + 4 * c : 0);
      cp_async16(dst + (CHUNKED ? (c * BKV + r) * 4 : r * HD + 4 * c), g,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BKV * HD; e += THREADS) {
      const int r = e / HD, col = e % HD;
      float val = 0.f;
      if (row0 + r < rows && col < hd)
        val = to_f32(src[static_cast<int64_t>(row0 + r) * hd + col]);
      dst[CHUNKED ? ((col >> 2) * BKV + r) * 4 + (col & 3) : r * HD + col] =
          val;
    }
  }
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VW consecutive floats from shared memory (16, 8 or 4 bytes aligned)
template <int VW>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <typename T, int HD, bool ASYNC>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
              int hd, int group, int causal, int window, int q_offset,
              float scale) {
  using C = Tile<HD>;
  constexpr int KG = C::KG, KJ = C::KJ, OC = C::OC, VW = C::VW, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // chunk-major [NC][BQ] float4
  float* Ks = Qs + BQ * HD;             // chunk-major [NC][BKV] float4
  float* Vs = Ks + BKV * HD;            // row-major [BKV][HD]
  float* Ps = Vs + BKV * HD;            // chunk-major [BKV / 4][BQ] float4

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int rg = threadIdx.x / KG;      // rows rg + 8 i
  const int cg = threadIdx.x % KG;      // keys cg + KG j, O columns below
  const T* qb = q + static_cast<int64_t>(bh) * Sq * hd;
  const int64_t kv_off = static_cast<int64_t>(bh / group) * Skv * hd;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // keys that some row of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + q_offset + 1);
  if (window) k_begin = max(0, q0 + q_offset - window + 1);
  const int kt0 = (k_begin / BKV) * BKV;

  load_tile<T, HD, ASYNC, true>(Qs, qb, q0, Sq, hd);
  if (kt0 < k_end) load_tile<T, HD, ASYNC, true>(Ks, kb, kt0, Skv, hd);
  cp_async_commit();

  float m[8], l[8], acc[8][OC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }
  const float4* Q4 = reinterpret_cast<const float4*>(Qs) + rg;
  const float4* K4 = reinterpret_cast<const float4*>(Ks) + cg;
  const float4* P4 = reinterpret_cast<const float4*>(Ps) + rg;
  const float* Vt = Vs + cg * VW;

  for (int kt = kt0; kt < k_end; kt += BKV) {
    cp_async_wait<0>();
    __syncthreads();          // K(kt) (and Q) in; every warp past P V(kt-1)
    load_tile<T, HD, ASYNC, false>(Vs, vb, kt, Skv, hd);
    cp_async_commit();

    // S = Q K^T over 16-byte runs of d, d in order
    float s[8][KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < NC; ++c) {
      float4 a[8], b[KJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = Q4[c * BQ + 8 * i];
#pragma unroll
      for (int j = 0; j < KJ; ++j) b[j] = K4[c * BKV + KG * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float t = fmaf(a[i].x, b[j].x, s[i][j]);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          s[i][j] = fmaf(a[i].w, b[j].w, t);
        }
    }
    __syncthreads();                    // every warp done with K(kt)
    if (kt + BKV < k_end)
      load_tile<T, HD, ASYNC, true>(Ks, kb, kt + BKV, Skv, hd);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] *= scale;
    // a tile that masks no row of the block skips the masks
    const bool full = kt + BKV <= Skv &&
                      (!causal || kt + BKV - 1 <= q0 + q_offset) &&
                      (!window || kt > q0 + BQ - 1 + q_offset - window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qpos = q0 + rg + 8 * i + q_offset;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kpos = kt + cg + KG * j;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && kpos > qpos - window;
          if (!ok) s[i][j] = NEG;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) mx = fmaxf(mx, s[i][j]);
      mx = group_max<KG>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        const int key = cg + KG * j, row = rg + 8 * i;
        Ps[((key >> 2) * BQ + row) * 4 + (key & 3)] = p;
      }
      l[i] = l[i] * alpha + rs;         // this thread's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait<1>();
    __syncthreads();                    // V(kt) in, P written

    // O += P V, keys in order
#pragma unroll 1
    for (int kc = 0; kc < BKV / 4; ++kc) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = P4[kc * BQ + 8 * i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[OC];
#pragma unroll
        for (int u = 0; u < OC / VW; ++u)
          lds<VW>(Vt + (kc * 4 + e) * HD + KG * VW * u, vv + u * VW);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pe = e == 0 ? p[i].x
                           : e == 1 ? p[i].y
                           : e == 2 ? p[i].z
                                    : p[i].w;
#pragma unroll
          for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pe, vv[c], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* ob = o + static_cast<int64_t>(bh) * Sq * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float den = fmaxf(group_sum<KG>(l[i]), 1e-30f);
    const int row = q0 + rg + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = cg * VW + KG * VW * (c / VW) + c % VW;
      if (col < hd)
        ob[static_cast<int64_t>(row) * hd + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HD, bool ASYNC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int hd, int group, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using C = Tile<HD>;
  // above 48 KiB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_fwd<T, HD, ASYNC><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, hd, group,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(bool async, const void* q, const void* k,
                      const void* v, void* o, int BH, int Sq, int Skv, int hd,
                      int group, int causal, int window, int q_offset,
                      float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (async)
      return launch<float, HD, true>(q, k, v, o, BH, Sq, Skv, hd, group,
                                     causal, window, q_offset, scale, s);
  }
  return launch<T, HD, false>(q, k, v, o, BH, Sq, Skv, hd, group, causal,
                              window, q_offset, scale, s);
}

template <typename T>
cudaError_t dispatch(bool async, const void* q, const void* k, const void* v,
                     void* o, int BH, int Sq, int Skv, int hd, int group,
                     int causal, int window, int q_offset, float scale,
                     cudaStream_t s) {
  if (hd <= 16)
    return launch_hd<T, 16>(async, q, k, v, o, BH, Sq, Skv, hd, group,
                            causal, window, q_offset, scale, s);
  if (hd <= 32)
    return launch_hd<T, 32>(async, q, k, v, o, BH, Sq, Skv, hd, group,
                            causal, window, q_offset, scale, s);
  if (hd <= 64)
    return launch_hd<T, 64>(async, q, k, v, o, BH, Sq, Skv, hd, group,
                            causal, window, q_offset, scale, s);
  if (hd <= 128)
    return launch_hd<T, 128>(async, q, k, v, o, BH, Sq, Skv, hd, group,
                             causal, window, q_offset, scale, s);
  return launch_hd<T, 256>(async, q, k, v, o, BH, Sq, Skv, hd, group, causal,
                           window, q_offset, scale, s);
}

template <int HD>
int blocks_per_sm(bool async) {
  int n = 0;
  const cudaError_t err =
      async ? cudaFuncSetAttribute(flash_fwd<float, HD, true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(Tile<HD>::SMEM))
            : cudaFuncSetAttribute(flash_fwd<float, HD, false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(Tile<HD>::SMEM));
  if (err != cudaSuccess) return -1;
  const cudaError_t occ =
      async ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, flash_fwd<float, HD, true>, Tile<HD>::THREADS,
                  Tile<HD>::SMEM)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &n, flash_fwd<float, HD, false>, Tile<HD>::THREADS,
                  Tile<HD>::SMEM);
  return occ == cudaSuccess ? n : -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  The wrapper
// checks devices, shapes, dtypes and contiguity before calling; the limits
// below are checked again here.  f32 with hd % 4 == 0 and 16-byte aligned
// q, k, v fills its tiles with cp.async.  Returns the launch's cudaError_t.
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
  const bool async =
      dtype == 0 && hd % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  switch (dtype) {
    case 0:
      return dispatch<float>(async, q, k, v, o, static_cast<int>(BH),
                             static_cast<int>(Sq), static_cast<int>(Skv),
                             static_cast<int>(hd), group, causal,
                             static_cast<int>(window),
                             static_cast<int>(q_offset), scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(
          false, q, k, v, o, static_cast<int>(BH), static_cast<int>(Sq),
          static_cast<int>(Skv), static_cast<int>(hd), group, causal,
          static_cast<int>(window), static_cast<int>(q_offset), scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks of the f32 kernel resident on one SM at head dim hd (the
// occupancy calculator's answer for its threads, registers and shared
// memory), with cp.async fills (async != 0) or without; -1 on an error.
extern "C" int flash_attention_blocks_per_sm(int64_t hd, int async) {
  if (hd < 1 || hd > 256) return -1;
  if (hd <= 16) return blocks_per_sm<16>(async);
  if (hd <= 32) return blocks_per_sm<32>(async);
  if (hd <= 64) return blocks_per_sm<64>(async);
  if (hd <= 128) return blocks_per_sm<128>(async);
  return blocks_per_sm<256>(async);
}
