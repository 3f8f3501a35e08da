// Mamba2 SSD intra-chunk block for Hopper (sm_90a) on the CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (its _kernel).  For one (bh, chunk) cell with chunk length Q, head dim P
// and state dim N, in f32 (expf, not __expf):
//
//   a = dt * A,  acum = cumsum(a)                      (a warp scan)
//   L[q, k]    = exp(acum[q] - acum[k]) for k <= q, else 0
//   y[q, p]    = sum_k ((C_q . B_k) * L[q, k] * dt[k]) * x[k, p]
//   state[p,n] = sum_q x[q, p] * (B[q, n] * (dt[q] * exp(acum[Q-1] - acum[q])))
//   decay      = exp(acum[Q-1])
//
// Inputs x, dt, A, B, C may each be f32 or bf16 (each is widened to f32 as
// it is read); the three outputs are f32.  Head bh reads group bh / heads
// of B and C (B and C are [BH / heads, c, Q, N]), as the model gives them.
// Flag bit 5 rounds C_q . B_k to bf16 before the decay, as the model's
// ssd_chunked rounds its scores.  This kernel takes f32 (whose 1e-4
// tolerance TF32 would break) and the bf16 shapes the tensor-core kernel
// (ssd_scan_tc.cu) refuses; every product is an exact f32 FMA.
//
// Bound: about even.  At mamba2-1.3b's cell (BH 64, 32 chunks of Q 128,
// P 64, N 128, B and C per head) a call reads and writes ~0.47 GB and does
// ~10.8 GFLOP of products on the lower triangle: 0.14 ms of bytes against
// 0.16 ms of f32 operations at the CUDA cores' peak.  So the products must
// run near the FFMA rate while the next copies stream underneath.
//
// Design (ssd_chunk, Q <= 128 and P <= 128): one block of 128 threads per
// (bh, chunk); Q is padded to QP (a multiple of 32) and P to PP (32, 64 or
// 128) with zeros, which leave every sum unchanged.  x stays in shared
// memory as f32 (16-byte cp.async where its rows allow, else 4-byte, or
// the threads widen bf16).  B and C stream through a ring of two slots in
// chunks of 32 state columns, one TMA box each ([QP][32] f32 in the 128-byte
// swizzle: the 16 bytes n4 of row q at float4 8 q + (n4 ^ (q & 7)), so 8
// rows read at one n4, or 8 n4 of one row, fall in 8 different banks; out
// of range rows and columns read zeros), chunk c + 1 in flight while chunk
// c is used; shapes TMA cannot take (bf16, N % 4 != 0) are copied into the
// same layout by the threads.  Per chunk:
//   S += C B^T on the lower triangle only: 32 x 16 tiles (qb, kh) with
//   kh <= 2 qb + 1, QB (QB + 1) of them (20 at Q 128) dealt round-robin to
//   the 4 warps, which hold them in registers across the chunks (4 x 4 per
//   thread: per 4 n, 8 16-byte loads, each a single wavefront, for 64
//   FFMAs);
//   the chunk's state columns, state = x^T (B o coef) with coef = dt *
//   exp(acum[Q-1] - acum), are written (4 x 4 per thread at P 64: per q a
//   16-byte load of x and of B for 16 FFMAs).
// Then W = S o L o dt (scores rounded first where asked) goes into the
// ring's space as W^T, and y = W x runs as 32 x 32 tiles whose k loop
// stops at the tile's diagonal, dealt to the warps heaviest first in a
// snake so that each warp sums as many terms (8 x 4 per thread: per k 3
// 16-byte loads for 32 FFMAs).  The scan of a = dt * A is one warp's:
// each lane sums its run of QP / 32 entries, shuffles add the runs.
// Shared memory is 4 (QP PP + 128 QP + 3 QP) + 1040 bytes: 99 KiB at
// Q 128, P 64, so two blocks (8 warps, ~250 registers a thread) share an
// SM and one block's copies overlap the other's products.  What still
// holds it back (per-block %globaltimer stamps at mamba2-1.3b's cell): the
// wait for x and the first chunk at the start of each block, W's
// exponentials, and the chunk loop's latency with 2 warps a scheduler.
//
// Chunks longer than 128 or heads wider than 128 (no model path) take
// ssd_rows instead, the row-blocked kernel this file first held: x, B and C
// staged whole, W built 2048 / Q rows at a time, one thread per dot.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;            // ssd_chunk: four warps
constexpr int NCOL = 32;                // state columns of a chunk of B, C
constexpr int MAX_Q = 128;              // ssd_chunk's longest chunk
constexpr int MAX_P = 128;              // ... and widest head
constexpr int ROWS_THREADS = 256;       // ssd_rows
constexpr int W_ELEMS = 2048;           // ssd_rows: floats in the W buffer
// how ssd_chunk copies x: 16-byte cp.async (f32 whose rows and base are
// whole 16 bytes), 4-byte cp.async (other f32), or loads, widening and
// stores by the threads (bf16); B and C: TMA (f32, N % 4 == 0, 16-byte
// aligned) or the threads
constexpr int HOW_THREADS = 0, HOW_4 = 1, HOW_16 = 2, HOW_TMA = 3;

// dtype flags: bit 0 x, bit 1 dt, bit 2 A, bit 3 B, bit 4 C (1 = bf16);
// bit 5: round the scores C_q . B_k to bf16
__device__ __forceinline__ float ld(const void* p, bool bf16, int64_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of the given parity.  A
// wait of more than ~2^35 cycles (~17 s) is a deadlock: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t n = 1; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && n % 1024 == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 35)) __trap();
    }
  }
}
// One box of a 3-D tensor map at (c0, c1, c2) into shared memory at dst;
// completion (its bytes) is reported to bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// acum[i] = a[0] + ... + a[i] for a[i] = dts[i] * rate, i < n, by one warp:
// each lane sums a run of ceil(n / 32) entries in order, and the lanes' sums
// are scanned with shuffles.
__device__ void warp_scan(const float* dts, float rate, float* acum, int n) {
  const int lane = threadIdx.x & 31, per = (n + 31) / 32, i0 = lane * per;
  const int i1 = min(i0 + per, n);
  float run = 0.f;
  for (int i = i0; i < i1; ++i) {
    run += dts[i] * rate;
    acum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int i = i0; i < i1; ++i) acum[i] += before;
}

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory of ssd_chunk in bytes: x [QP][PP] f32; the ring, two slots
// of a (B, C) chunk pair, each matrix [QP][32] f32 (W^T [QP][QP] after the
// chunks); dt, acum, coef [QP] each; two mbarriers; 1024 bytes to align
// the ring to the swizzle's 1024-byte atom.
__host__ __device__ constexpr int chunk_smem_bytes(int QP, int PP) {
  return 4 * (QP * PP + 128 * QP + 3 * QP) + 16 + 1024;
}

template <int QB, int PP>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_chunk(const __grid_constant__ CUtensorMap mb,
              const __grid_constant__ CUtensorMap mc,
              const void* __restrict__ x, const void* __restrict__ dt,
              const void* __restrict__ A, const void* __restrict__ B,
              const void* __restrict__ C, float* __restrict__ y,
              float* __restrict__ st, float* __restrict__ dc, int heads,
              int chunks, int Q, int P, int N, int flags, int how) {
  constexpr int QP = QB * 32, PB = PP / 32, PT = PP / 16;
  constexpr int SLOT = QP * 8;                    // float4 of one matrix
  constexpr int NS = QB * (QB + 1);               // S tiles (qb, kh)
  constexpr int SPW = (NS + 3) / 4;               // ... per warp, at most
  extern __shared__ float smem_raw[];
  float* xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  float4* ring = reinterpret_cast<float4*>(xs + QP * PP);   // 1024-aligned
  float* Wt = reinterpret_cast<float*>(ring);     // [QP][QP] after the chunks
  float* dts = reinterpret_cast<float*>(ring + 4 * SLOT);
  float* acum = dts + QP;
  float* coef = acum + QP;
  const uint32_t bar0 = smem_u32(coef + QP);      // two mbarriers, one a slot

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cell = blockIdx.x;                    // bh * chunks + chunk
  const int bh = cell / chunks;
  const int64_t gcell = static_cast<int64_t>(bh / heads) * chunks +
                        cell % chunks;            // B and C by group
  const bool xb = flags & 1, dtb = flags & 2, ab = flags & 4,
             bb = flags & 8, cb = flags & 16, round_scores = flags & 32;
  const int64_t base_qp = static_cast<int64_t>(cell) * Q * P;
  const int64_t base_qn = gcell * Q * N;
  const int nchunks = (N + NCOL - 1) / NCOL;
  // how x and B, C are copied (HOW_*) and whether y and the state rows
  // take 16-byte stores
  const int x_how = how & 3, bc_how = (how >> 2) & 3;
  const bool y_vec = how & 16, st_vec = how & 32;

  // Chunk j of B and C (rows q < Q, columns [32 j, 32 j + 32) < N) into
  // ring slot j & 1, zeros past Q and N.  Each matrix is [QP][32] f32 in
  // TMA's 128-byte swizzle: the 16 bytes n4 of row q at float4 index
  // 8 q + (n4 ^ (q & 7)), so 8 rows read at one n4, or 8 n4 of one row,
  // fall in 8 different banks.
  auto load_chunk = [&](int j) {
    float4* Bd = ring + (j & 1) * 2 * SLOT;
    float4* Cd = Bd + SLOT;
    if (bc_how == HOW_TMA) {
      if (tid == 0) {
        const uint32_t bar = bar0 + 8 * (j & 1);
        // the slot's last reads (generic) before the copy (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, 2 * QP * 128);
        tma_load(smem_u32(Bd), &mb, bar, j * NCOL, 0, static_cast<int>(gcell));
        tma_load(smem_u32(Cd), &mc, bar, j * NCOL, 0, static_cast<int>(gcell));
      }
      return;
    }
    float* Bf = reinterpret_cast<float*>(Bd);
    float* Cf = reinterpret_cast<float*>(Cd);
    for (int e = tid; e < QP * NCOL; e += THREADS) {
      const int q = e / NCOL, nl = e % NCOL, n = j * NCOL + nl;
      const bool in = q < Q && n < N;
      const int64_t i = base_qn + (in ? static_cast<int64_t>(q) * N + n : 0);
      const int d = (q * 8 + ((nl >> 2) ^ (q & 7))) * 4 + (nl & 3);
      Bf[d] = in ? ld(B, bb, i) : 0.f;
      Cf[d] = in ? ld(C, cb, i) : 0.f;
    }
  };

  if (bc_how == HOW_TMA && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_chunk(0);             // S(0) needs only this; x follows
  cp_async_commit();
  if (x_how == HOW_16) {
    const float* xg = static_cast<const float*>(x) + base_qp;
#pragma unroll
    for (int it = 0; it < QP * PP / 4 / THREADS; ++it) {
      const int e = it * THREADS + tid, q = e / (PP / 4), p = 4 * (e % (PP / 4));
      const bool in = q < Q && p < P;
      cp_async16(xs + q * PP + p,
                 xg + (in ? static_cast<int64_t>(q) * P + p : 0), in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < QP * PP; e += THREADS) {
      const int q = e / PP, p = e % PP;
      const bool in = q < Q && p < P;
      const int64_t i = base_qp + (in ? static_cast<int64_t>(q) * P + p : 0);
      if (x_how == HOW_4)
        cp_async4(xs + e, static_cast<const float*>(x) + i, in ? 4 : 0);
      else
        xs[e] = in ? ld(x, xb, i) : 0.f;
    }
  }
  cp_async_commit();

  if (warp == 0) {            // the scan, coef and the chunk's decay
    for (int q = lane; q < QP; q += 32)
      dts[q] = q < Q ? ld(dt, dtb, static_cast<int64_t>(cell) * Q + q) : 0.f;
    __syncwarp();
    warp_scan(dts, ld(A, ab, bh), acum, QP);  // padded rows add 0
    __syncwarp();
    const float a_last = acum[Q - 1];
    for (int q = lane; q < QP; q += 32)
      coef[q] = dts[q] * expf(a_last - acum[q]);
    if (lane == 0) dc[cell] = expf(a_last);
  }

  // this warp's S tiles, (qb, kh) = tile t = warp + 4 u, t = qb (qb + 1) + kh
  const int qg = lane >> 2, kg = lane & 3;
  int tqb[SPW], tkh[SPW];
  float s[SPW][4][4];
#pragma unroll
  for (int u = 0; u < SPW; ++u) {
    const int t = warp + 4 * u;
    int qb = 0;
    while ((qb + 1) * (qb + 2) <= t) ++qb;
    tqb[u] = qb;
    tkh[u] = t - qb * (qb + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[u][i][j] = 0.f;
  }
  const int pg = tid >> 3, ng = tid & 7;  // state: p pg*PT + e, n 4 ng + u

  for (int c = 0; c < nchunks; ++c) {
    if (c == 0)
      cp_async_wait<1>();     // chunk 0 in (x may still be on its way)
    else
      cp_async_wait<0>();
    if (bc_how == HOW_TMA) mbar_wait(bar0 + 8 * (c & 1), (c >> 1) & 1);
    __syncthreads();          // chunk c in; every warp done with c-1
    if (c + 1 < nchunks) load_chunk(c + 1);
    cp_async_commit();
    const float4* Bc = ring + (c & 1) * 2 * SLOT;
    const float4* Cc = Bc + SLOT;

    // S += C B^T over this chunk's 32 columns, n in order
#pragma unroll
    for (int u = 0; u < SPW; ++u) {
      if (warp + 4 * u >= NS) break;
      // rows tqb*32 + qg + 8 i (row & 7 = qg), tkh*16 + kg + 4 j (row & 7 =
      // kg + 4 (j & 1))
      const float4* cr = Cc + (tqb[u] * 32 + qg) * 8;
      const float4* br = Bc + (tkh[u] * 16 + kg) * 8;
#pragma unroll
      for (int n4 = 0; n4 < 8; ++n4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cr[i * 64 + (n4 ^ qg)];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = br[j * 32 + (n4 ^ (kg + 4 * (j & 1)))];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float t = fmaf(cv[i].x, bv[j].x, s[u][i][j]);
            t = fmaf(cv[i].y, bv[j].y, t);
            t = fmaf(cv[i].z, bv[j].z, t);
            s[u][i][j] = fmaf(cv[i].w, bv[j].w, t);
          }
      }
    }
    if (c == 0) {
      cp_async_wait<1>();               // x in
      __syncthreads();
    }

    // state columns [32 c, 32 c + 32) = x^T (B o coef), q in order
    {
      float acc[PT][4];
#pragma unroll
      for (int e = 0; e < PT; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[e][u] = 0.f;
      const float* xr = xs + pg * PT;
#pragma unroll 8
      for (int q = 0; q < QP; ++q) {
        float xv[PT];
#pragma unroll
        for (int e = 0; e < PT; e += 4 < PT ? 4 : PT) {
          if constexpr (PT >= 4) {
            const float4 t = *reinterpret_cast<const float4*>(xr + q * PP + e);
            xv[e] = t.x; xv[e + 1] = t.y; xv[e + 2] = t.z; xv[e + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(xr + q * PP + e);
            xv[e] = t.x; xv[e + 1] = t.y;
          }
        }
        float4 b = Bc[q * 8 + (ng ^ (q & 7))];
        const float w = coef[q];
        b.x *= w; b.y *= w; b.z *= w; b.w *= w;
#pragma unroll
        for (int e = 0; e < PT; ++e) {
          acc[e][0] = fmaf(xv[e], b.x, acc[e][0]);
          acc[e][1] = fmaf(xv[e], b.y, acc[e][1]);
          acc[e][2] = fmaf(xv[e], b.z, acc[e][2]);
          acc[e][3] = fmaf(xv[e], b.w, acc[e][3]);
        }
      }
      const int n0 = c * NCOL + 4 * ng;
      float* sr = st + static_cast<int64_t>(cell) * P * N;
#pragma unroll
      for (int e = 0; e < PT; ++e) {
        const int p = pg * PT + e;
        if (p >= P) continue;
        float* dst = sr + static_cast<int64_t>(p) * N + n0;
        if (st_vec && n0 < N) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (n0 + u < N) dst[u] = acc[e][u];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // every warp done with the ring

  // W = S o L o dt_k on the lower triangle, as W^T
#pragma unroll
  for (int u = 0; u < SPW; ++u) {
    if (warp + 4 * u >= NS) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tqb[u] * 32 + qg + 8 * i;
      const float aq = acum[q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tkh[u] * 16 + kg + 4 * j;
        float w = 0.f;
        if (k <= q) {
          float dot = s[u][i][j];
          if (round_scores) dot = __bfloat162float(__float2bfloat16_rn(dot));
          w = dot * expf(aq - acum[k]) * dts[k];
        }
        Wt[k * QP + q] = w;
      }
    }
  }
  __syncthreads();

  // y = W x: tiles (qb, pb) heaviest first, dealt to the warps in a snake
  {
    const int yq = lane >> 3, yp = lane & 7;
    float* yc = y + base_qp;
#pragma unroll 1
    for (int r = 0; 4 * r < QB * PB; ++r) {
      const int t = 4 * r + ((r & 1) ? 3 - warp : warp);
      if (t >= QB * PB) continue;
      const int qb = QB - 1 - t / PB, pb = t % PB;
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      const float* wc = Wt + qb * 32 + yq * 8;
      const float* xr = xs + pb * 32 + yp * 4;
#pragma unroll 4
      for (int k = 0; k < 32 * (qb + 1); ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wc + k * QP);
        const float4 w1 = *reinterpret_cast<const float4*>(wc + k * QP + 4);
        const float4 xv = *reinterpret_cast<const float4*>(xr + k * PP);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(wv[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(wv[i], xv.y, acc[i][1]);
          acc[i][2] = fmaf(wv[i], xv.z, acc[i][2]);
          acc[i][3] = fmaf(wv[i], xv.w, acc[i][3]);
        }
      }
      const int p0 = pb * 32 + yp * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = qb * 32 + yq * 8 + i;
        if (q >= Q) continue;
        float* dst = yc + static_cast<int64_t>(q) * P + p0;
        if (y_vec && p0 < P) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (p0 + e < P) dst[e] = acc[i][e];
        }
      }
    }
  }
}

__host__ __device__ inline int w_rows(int Q) {
  const int r = W_ELEMS / Q;
  return r < 1 ? 1 : (r > Q ? Q : r);
}

// ssd_rows: the whole cell staged, one thread per dot (chunks longer than
// 128 or heads wider than 128).
__global__ void __launch_bounds__(ROWS_THREADS)
    ssd_rows(const void* __restrict__ x, const void* __restrict__ dt,
             const void* __restrict__ A, const void* __restrict__ B,
             const void* __restrict__ C, float* __restrict__ y,
             float* __restrict__ st, float* __restrict__ dc, int heads,
             int chunks, int Q, int P, int N, int flags) {
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

  const int cell = blockIdx.x;          // bh * chunks + chunk
  const int bh = cell / chunks;
  const int tid = threadIdx.x;
  const bool xb = flags & 1, dtb = flags & 2, ab = flags & 4,
             bb = flags & 8, cb = flags & 16;
  const int64_t base_qp = static_cast<int64_t>(cell) * Q * P;
  const int64_t base_qn =
      (static_cast<int64_t>(bh / heads) * chunks + cell % chunks) * Q * N;
  const int64_t base_q = static_cast<int64_t>(cell) * Q;

  for (int i = tid; i < Q * P; i += ROWS_THREADS)
    xs[i] = ld(x, xb, base_qp + i);
  for (int i = tid; i < Q * N; i += ROWS_THREADS) {
    Bs[(i / N) * LDB + i % N] = ld(B, bb, base_qn + i);
    Cs[i] = ld(C, cb, base_qn + i);
  }
  for (int i = tid; i < Q; i += ROWS_THREADS) dts[i] = ld(dt, dtb, base_q + i);
  __syncthreads();
  if (tid < 32) warp_scan(dts, ld(A, ab, bh), acum, Q);
  __syncthreads();
  const float a_last = acum[Q - 1];
  for (int i = tid; i < Q; i += ROWS_THREADS)
    coef[i] = dts[i] * expf(a_last - acum[i]);
  if (tid == 0) dc[cell] = expf(a_last);
  __syncthreads();

  // y = W x, G rows of W at a time
  for (int r0 = 0; r0 < Q; r0 += G) {
    const int rows = min(G, Q - r0);
    for (int i = tid; i < rows * Q; i += ROWS_THREADS) {
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
    for (int i = tid; i < rows * P; i += ROWS_THREADS) {
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
  for (int i = tid; i < P * N; i += ROWS_THREADS) {
    const int p = i / N, n = i % N;
    float acc = 0.f;
    for (int q = 0; q < Q; ++q)
      acc = fmaf(xs[q * P + p], Bs[q * LDB + n] * coef[q], acc);
    st[base_pn + i] = acc;
  }
}

bool takes_chunk(int64_t Q, int64_t P) {
  return Q >= 1 && Q <= MAX_Q && P >= 1 && P <= MAX_P;
}

int pad_p(int64_t P) { return P <= 32 ? 32 : (P <= 64 ? 64 : 128); }

typedef void (*ChunkKernel)(CUtensorMap, CUtensorMap, const void*,
                            const void*, const void*, const void*,
                            const void*, float*, float*, float*, int, int,
                            int, int, int, int, int);

template <int QB>
ChunkKernel chunk_kernel_p(int PP) {
  return PP == 32 ? ssd_chunk<QB, 32>
                  : (PP == 64 ? ssd_chunk<QB, 64> : ssd_chunk<QB, 128>);
}

ChunkKernel chunk_kernel(int64_t Q, int64_t P) {
  const int QB = static_cast<int>((Q + 31) / 32), PP = pad_p(P);
  switch (QB) {
    case 1: return chunk_kernel_p<1>(PP);
    case 2: return chunk_kernel_p<2>(PP);
    case 3: return chunk_kernel_p<3>(PP);
    default: return chunk_kernel_p<4>(PP);
  }
}

// cuTensorMapEncodeTiled, fetched from libcuda at run time so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [cells, Q, N] f32 as the 3-D tensor (N, Q, cells), boxes of (32, QP, 1)
// in the 128-byte swizzle; out of bounds (rows past Q, columns past N)
// reads zeros.
bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                int64_t cells, int64_t Q, int64_t N, int QP) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(Q),
                              static_cast<cuuint64_t>(cells)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N * 4),
                                 static_cast<cuuint64_t>(Q * N * 4)};
  const cuuint32_t box[3] = {NCOL, static_cast<cuuint32_t>(QP), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Bytes of dynamic shared memory the kernel needs for (Q, P, N).
extern "C" int64_t ssd_intra_chunk_smem(int64_t Q, int64_t P, int64_t N) {
  if (Q < 1 || P < 1 || N < 1 || Q > 0x7fffffffLL) return -1;
  if (takes_chunk(Q, P))
    return chunk_smem_bytes(round_up(static_cast<int>(Q), 32), pad_p(P));
  const int64_t G = w_rows(static_cast<int>(Q));
  return static_cast<int64_t>(sizeof(float)) *
         (Q * P + Q * (N + 1) + Q * N + G * Q + 3 * Q);
}

// x [BH, c, Q, P], dt [BH, c, Q], A [BH], B/C [BH / heads, c, Q, N] -> y
// [BH, c, Q, P], st [BH, c, P, N], dc [BH, c], all contiguous.  flags: see
// ld().  The wrapper checks devices, shapes, dtypes, contiguity and the
// shared-memory size before calling.  Returns the launch's cudaError_t.
extern "C" cudaError_t ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* st, void* dc, int64_t BH, int64_t heads,
    int64_t chunks, int64_t Q, int64_t P, int64_t N, int flags,
    void* stream) {
  const int64_t smem = ssd_intra_chunk_smem(Q, P, N);
  if (BH < 1 || heads < 1 || BH % heads != 0 || chunks < 1 ||
      BH * chunks > 0x7fffffffLL || smem < 0 || smem > 232448 ||
      P * N > 0x7fffffffLL || Q * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(BH * chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_chunk(Q, P)) {
    const int QP = round_up(static_cast<int>(Q), 32);
    CUtensorMap mb = {}, mc = {};
    int bc_how = HOW_THREADS;
    const EncodeTiled enc = encode_tiled();
    if (!(flags & 24) && N % 4 == 0 && aligned16(B) && aligned16(C) &&
        enc != nullptr &&
        tensor_map(&mb, enc, B, BH / heads * chunks, Q, N, QP) &&
        tensor_map(&mc, enc, C, BH / heads * chunks, Q, N, QP))
      bc_how = HOW_TMA;
    const int x_how = flags & 1 ? HOW_THREADS
                                : (P % 4 == 0 && aligned16(x) ? HOW_16 : HOW_4);
    const int how = x_how | bc_how << 2 | (P % 4 == 0 && aligned16(y)) << 4 |
                    (N % 4 == 0 && aligned16(st)) << 5;
    const ChunkKernel k = chunk_kernel(Q, P);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    k<<<grid, THREADS, static_cast<size_t>(smem), s>>>(
        mb, mc, x, dt, A, B, C, static_cast<float*>(y),
        static_cast<float*>(st), static_cast<float*>(dc),
        static_cast<int>(heads), static_cast<int>(chunks),
        static_cast<int>(Q), static_cast<int>(P), static_cast<int>(N), flags,
        how);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_rows<<<grid, ROWS_THREADS, static_cast<size_t>(smem), s>>>(
      x, dt, A, B, C, static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(dc), static_cast<int>(heads),
      static_cast<int>(chunks), static_cast<int>(Q), static_cast<int>(P),
      static_cast<int>(N), flags);
  return cudaGetLastError();
}

// Blocks of the kernel that takes (Q, P, N) resident on one SM (the
// occupancy calculator's answer); -1 on an error.
extern "C" int ssd_intra_chunk_blocks_per_sm(int64_t Q, int64_t P,
                                             int64_t N) {
  const int64_t smem = ssd_intra_chunk_smem(Q, P, N);
  if (smem < 0 || smem > 232448) return -1;
  const void* k = takes_chunk(Q, P)
                      ? reinterpret_cast<const void*>(chunk_kernel(Q, P))
                      : reinterpret_cast<const void*>(ssd_rows);
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, k, takes_chunk(Q, P) ? THREADS : ROWS_THREADS,
             static_cast<size_t>(smem)) == cudaSuccess
             ? n
             : -1;
}
