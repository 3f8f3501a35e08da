// Mamba2 SSD intra-chunk block on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (its _kernel) for bf16 x [BH, c, Q, P] and B, C [BH / heads, c, Q, N]
// with f32 dt [BH, c, Q] and A [BH]: head bh reads group bh / heads of B
// and C (a Mamba2 layer has one group, shared by all its heads), so B and
// C are never expanded per head.  For one (bh, chunk) cell, in f32:
//
//   acum = cumsum(dt * A)
//   S[q, k]    = C_q . B_k  (rounded to bf16 when asked: round_scores,
//                the model's ssd_chunked rounds its bf16 scores so)
//   W[q, k]    = S[q, k] * exp(acum[q] - acum[k]) * dt[k]  for k <= q
//   y[q, p]    = sum_k W[q, k] x[k, p]
//   state[p,n] = sum_q x[q, p] (B[q, n] * dt[q] * exp(acum[Q-1] - acum[q]))
//   decay      = exp(acum[Q-1])
//
// The three products run on the tensor cores (wgmma, f32 accumulate):
// - S = C B^T from bf16 C and B (bf16 products are exact): both operands
//   from shared memory, K-major, one m64n64 tile per 64 rows and 64 keys;
//   tiles wholly above the diagonal are skipped.
// - W is formed in registers from S's accumulator fragment, the masks and
//   exp(acum_q - acum_k) (expf); y = W x takes W as the A operand from
//   registers (the m64n64 accumulator layout is the A-fragment layout of
//   four k16 steps) split into two bf16 terms, W = W_hi + W_lo (error
//   ~2^-17 W): one bf16 rounding of W errs by ~2^-9 of each term, which
//   misses 1e-4 of the outputs' largest entry.  x is the B operand,
//   MN-major (transpose bit).
// - state = x^T (B o w): B o w is formed in f32 and stored as bf16
//   hi + lo over the shared copies of B and C (done with by then); x^T and
//   B o w are both MN-major operands from shared memory.
//
// Bound: bytes.  At mamba2-1.3b's shape (BH 128 = B 2 x 64 heads, 32
// chunks of Q 128, P 64, N 128) the cell reads x (bf16), dt and B, C once
// per group and writes y and the states in f32: ~0.34 GB, 0.10 ms at
// 3.35 TB/s, against ~22 GFLOP (0.02 ms) at the bf16 tensor-core peak;
// at hymba-1.5b's (the same cells, P 50, N 16) ~0.17 GB, 0.05 ms.
// So the kernel keeps every product on the tensor cores and its inputs in
// shared memory, reads B and C per group (the heads of one group are
// adjacent in the launch order, so all but the first read come from L2),
// and does nothing else to the bytes; two blocks share an SM at the
// model's shape, so one block's loads overlap the other's products.
//
// Design: one block of two warpgroups per (bh, chunk), blocks ordered
// (group, chunk, head) with the head fastest.  One thread issues TMA loads
// of C and B (one barrier) with the 128-byte swizzle wgmma reads: rows of
// 64 bf16, a wider N as several such boxes, zero-filled by TMA up to a
// whole box.  x is filled into the same layout in one of two ways (the
// template flag XTMA):
// - by TMA (another barrier), for P % 16 == 0 (the threads' fill is
//   ~19% slower at mamba2-1.3b's cell on an H100);
// - by the block's threads, for any other even P (hymba-1.5b's P 50): a
//   tensor map needs row strides that are multiples of 16 bytes, and a row
//   of P 50 bf16 is 100 bytes.  The cell's Q x P values are contiguous and
//   16-byte aligned (Q % 64 == 0), so each thread reads 16 bytes at a time
//   (four bf16 pairs; with P even no pair straddles two rows), stores each
//   pair at its swizzled place and zeroes the columns P .. 64 PB - 1; a
//   proxy fence and the block barrier then order these writes before the
//   first wgmma reads them.  TMA still brings B and C meanwhile.
// Meanwhile warp 0 computes acum and the per-row state weights.  The
// Q / 64 row blocks of y are dealt to the two warpgroups to balance the
// lower triangle; then the (P / 64) x (N / 64) state tiles.  y and the
// states are stored from the accumulator fragments.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WGS = 2;                    // warpgroups per block
constexpr int THREADS = 128 * WGS;
constexpr int BOX = 64;                   // bf16 per 128-byte swizzled row
constexpr int ATOM = 1024;                // 8 rows x 128 bytes
constexpr int SMEM_MAX = 232448;          // bytes a block may use

__host__ __device__ inline int boxes(int n) { return (n + BOX - 1) / BOX; }

// PHASE(k): a phase boundary of a block.  Empty unless built with
// -DSSD_PHASE_STAMPS (benchmarks_torch/ssd_phases.py), where the calling
// thread writes %globaltimer to stamp k of its block (k 0 also the SM's
// id to stamp 6): 0 start, 1 set-up done, 2 + wg warpgroup wg's rows of
// y done, 4 B o w done, 5 end.
#ifdef SSD_PHASE_STAMPS
constexpr int STAMPS = 8;                 // per block
__device__ unsigned long long g_stamps[STAMPS << 14];
__device__ __forceinline__ void phase_stamp(int k) {
  if (blockIdx.x >= (1u << 14)) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[blockIdx.x * STAMPS + k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blockIdx.x * STAMPS + 6] = sm;
  }
}
#define PHASE(k) phase_stamp(k)
#else
#define PHASE(k) do {} while (0)
#endif

// Dynamic shared memory: C, B, x tiles (atom-aligned, plus slack for the
// alignment), then dt, acum and the state weights, then two barriers.
__host__ __device__ inline int64_t smem_of(int64_t Q, int64_t P, int64_t N) {
  return ATOM + Q * 128 * (2 * boxes(static_cast<int>(N))
                           + boxes(static_cast<int>(P)))
         + 3 * Q * 4 + 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.  A
// wait of more than ~2^35 cycles (~17 s) is a deadlock: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t n = 1; !done; ++n) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
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
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo, sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma accumulators across the
// wait that makes them valid, or their definitions (the zeroing) past the
// fence that starts the products.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// ... and from reusing a wgmma's A registers before that wait.
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

#define ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])
#define D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory,
// both K-major (transpose bits 0); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A and B from shared memory, both
// MN-major (transpose bits 1).
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A (bf16x2 pairs) from registers,
// B from shared memory, MN-major (transpose bit 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Which warpgroup takes row block rb: 0, 1, 1, 0 (the row blocks' key
// counts are 1, 2, 3, 4 tiles).
__device__ __forceinline__ int owner(int rb) {
  return ((rb / 2) % 2) ? 1 - rb % 2 : rb % 2;
}

// Byte offset of bf16 element (r, col) in boxes of 64 columns (box_bytes
// apart, each 1024-byte aligned) under the 128-byte swizzle, as TMA
// writes it: the 16-byte chunk (col % 64) / 8 of row r sits at chunk
// ((col % 64) / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int r, int col,
                                             uint32_t box_bytes) {
  return (col / BOX) * box_bytes + r * 128
         + ((((col % BOX) / 8) ^ (r % 8)) << 4) + (col % 8) * 2;
}

// x's cell [Q, P] (bf16, contiguous, 16-byte aligned, P even) into the
// PB boxes at sx, by all the block's threads, columns P .. 64 PB - 1
// zeroed.  Each thread first loads up to FILL 16-byte pieces, then stores
// them, so that its loads are in flight together.
constexpr int FILL = 4;
template <int PB>
__device__ __forceinline__ void fill_x(uint8_t* sx, const uint4* xc, int Q,
                                       int P, uint32_t box_bytes) {
  const int pieces = Q * P / 8;
  for (int i0 = threadIdx.x; i0 < pieces; i0 += FILL * THREADS) {
    uint4 v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u)
      if (i0 + u * THREADS < pieces) v[u] = __ldg(xc + i0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= pieces) break;
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&v[u]);
      int r = 8 * i / P, col = 8 * i - r * P;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<uint32_t*>(sx + swizzled(r, col, box_bytes)) = e[m];
        col += 2;
        if (col == P) {
          col = 0;
          ++r;
        }
      }
    }
  }
  const int pad = (BOX * PB - P) / 2;              // zero pairs per row
  for (int i = threadIdx.x; i < Q * pad; i += THREADS) {
    const int r = i / pad;
    *reinterpret_cast<uint32_t*>(
        sx + swizzled(r, P + 2 * (i - r * pad), box_bytes)) = 0u;
  }
}

// Accumulator fragment of wgmma m64n64 (f32), thread t of the warpgroup,
// warp w = t / 32, lane: element i is row 16 w + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2.
// XTMA: x by TMA through mx; else by the threads from xg (mx unused).
template <int PB, bool XTMA>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_intra_tc(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ CUtensorMap mc,
                 const uint4* __restrict__ xg,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ y, float* __restrict__ st,
                 float* __restrict__ dc, int chunks, int heads, int Q, int P,
                 int N, int round_scores) {
  extern __shared__ uint8_t smem_raw[];
  const int NB = boxes(N);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t box_bytes = static_cast<uint32_t>(Q) * 128;
  const uint32_t sC = (raw + ATOM - 1) & ~uint32_t(ATOM - 1);
  const uint32_t sB = sC + NB * box_bytes;
  const uint32_t sX = sB + NB * box_bytes;
  const uint32_t sF = sX + PB * box_bytes;          // dts, acum, coef
  const uint32_t bar_bc = sF + 3 * Q * 4;
  const uint32_t bar_x = bar_bc + 8;
  float* dts = reinterpret_cast<float*>(smem_raw + (sF - raw));
  float* acum = dts + Q;
  float* coef = acum + Q;

  // blocks ordered (group, chunk, head), head fastest
  const int h = blockIdx.x % heads;
  const int gc = blockIdx.x / heads;               // group * chunks + chunk
  const int bh = (gc / chunks) * heads + h;
  const int64_t cell = static_cast<int64_t>(bh) * chunks + gc % chunks;
  if (threadIdx.x == 0) PHASE(0);

  if (threadIdx.x == 0) {
    mbar_init(bar_bc, 1);
    mbar_init(bar_x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_bc, 2 * NB * box_bytes);
    for (int j = 0; j < NB; ++j) {
      tma_load(sC + j * box_bytes, &mc, bar_bc, j * BOX, 0, gc);
      tma_load(sB + j * box_bytes, &mb, bar_bc, j * BOX, 0, gc);
    }
    if constexpr (XTMA) {
      mbar_expect_tx(bar_x, PB * box_bytes);
#pragma unroll
      for (int j = 0; j < PB; ++j)
        tma_load(sX + j * box_bytes, &mx, bar_x, j * BOX, 0,
                 static_cast<int>(cell));
    }
  }
  if constexpr (!XTMA)
    fill_x<PB>(smem_raw + (sX - raw), xg + cell * Q * P / 8, Q, P,
               box_bytes);

  // warp 0, while the tiles arrive: acum = cumsum(dt * A) (each lane a
  // run of Q / 32 rows, then a scan of the runs), the state weights
  // dt_q exp(acum_last - acum_q) and the chunk's decay
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = Q / 32;
    const float a_rate = A[bh];
    const float* dtc = dt + cell * Q;
    float run = 0.f;
    for (int i = 0; i < per; ++i) {
      const float d = dtc[lane * per + i];
      dts[lane * per + i] = d;
      run += d * a_rate;
      acum[lane * per + i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float excl = incl - run;
    for (int i = 0; i < per; ++i) acum[lane * per + i] += excl;
    __syncwarp();
    const float a_last = acum[Q - 1];
    for (int i = lane; i < Q; i += 32)
      coef[i] = dts[i] * expf(a_last - acum[i]);
    if (lane == 0) dc[cell] = expf(a_last);
  }
  // x's generic-proxy writes (thread-filled), before wgmma reads them
  if constexpr (!XTMA)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) PHASE(1);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;           // rows r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);

  // ---- y = W x, row block by row block ----
  mbar_wait(bar_bc, 0);
  bool x_ready = false;
  for (int rb = 0; rb < Q / 64; ++rb) {
    if (owner(rb) != wg) continue;
    float acc[PB][32];
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    const int q_lo = 64 * rb + r_lo;
    const float aq_lo = acum[q_lo], aq_hi = acum[q_lo + 8];
    for (int kt = 0; kt <= rb; ++kt) {
      // S = C B^T for 64 rows and 64 keys, 16 state columns per wgmma,
      // N / 16 of them (the box's zero fill beyond N is not multiplied)
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      keep(sc);
      wg_fence();
      for (int s = 0; s < N / 16; ++s) {
        const uint32_t off = (s / 4) * box_bytes + (s % 4) * 32;
        wgmma_ss_kk(sc, desc(sC + off + rb * 64 * 128, 16, ATOM),
                    desc(sB + off + kt * 64 * 128, 16, ATOM), s != 0);
      }
      wg_commit();
      wg_wait_all();
      keep(sc);
      if (round_scores) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = __bfloat162float(__float2bfloat16_rn(sc[i]));
      }

      // W = (S * L) * dt_k, zero above the diagonal, as W_hi + W_lo
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kl = 8 * (i / 4) + cq + (i % 2);
        const bool hi = (i / 2) % 2;
        const int k = 64 * kt + kl;
        float w = 0.f;
        if (kt < rb || kl <= r_lo + 8 * hi)
          w = sc[i] * expf((hi ? aq_hi : aq_lo) - acum[k]) * dts[k];
        sc[i] = w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
          const float2 hf = __bfloat1622float2(hv);
          wh[kk][r] = *reinterpret_cast<const uint32_t*>(&hv);
          wl[kk][r] = pack_bf16(a - hf.x, b - hf.y);
        }

      if (XTMA && !x_ready) {
        mbar_wait(bar_x, 0);
        x_ready = true;
      }
      keep(wh);
      keep(wl);
#pragma unroll
      for (int j = 0; j < PB; ++j) keep(acc[j]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const uint64_t dx = desc(sX + j * box_bytes
                                   + (64 * kt + 16 * kk) * 128,
                                   box_bytes, ATOM);
          wgmma_rs(acc[j], wh[kk], dx);
          wgmma_rs(acc[j], wl[kk], dx);
        }
      wg_commit();
      wg_wait_all();
      keep(wh);
      keep(wl);
#pragma unroll
      for (int j = 0; j < PB; ++j) keep(acc[j]);
    }
    float* yc = y + cell * Q * P;
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int col = j * BOX + 8 * n8 + cq;      // even, as P is
        if (col >= P) continue;
        *reinterpret_cast<float2*>(yc + static_cast<int64_t>(q_lo) * P
                                   + col) =
            make_float2(acc[j][4 * n8], acc[j][4 * n8 + 1]);
        *reinterpret_cast<float2*>(yc + static_cast<int64_t>(q_lo + 8) * P
                                   + col) =
            make_float2(acc[j][4 * n8 + 2], acc[j][4 * n8 + 3]);
      }
  }

  if (tid == 0) PHASE(2 + wg);

  // ---- B o w as bf16 hi (over B) + lo (over C): no product reads C or
  // B any more once every warpgroup is past here ----
  __syncthreads();
  uint8_t* gB = smem_raw + (sB - raw);
  uint8_t* gC = smem_raw + (sC - raw);
  for (int ch = threadIdx.x; ch < NB * Q * 8; ch += THREADS) {
    // 16 bytes of one row: the swizzle permutes chunks within a row only
    const float w = coef[(ch / 8) % Q];
    uint4 v = *reinterpret_cast<const uint4*>(gB + 16 * ch);
    uint32_t* e = reinterpret_cast<uint32_t*>(&v);
    uint4 hi, lo;
    uint32_t* eh = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* el = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&e[r]));
      const float a0 = b.x * w, a1 = b.y * w;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(a0, a1);
      const float2 hf = __bfloat1622float2(hv);
      eh[r] = *reinterpret_cast<const uint32_t*>(&hv);
      el[r] = pack_bf16(a0 - hf.x, a1 - hf.y);
    }
    *reinterpret_cast<uint4*>(gB + 16 * ch) = hi;
    *reinterpret_cast<uint4*>(gC + 16 * ch) = lo;
  }
  // the generic-proxy writes above, before wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if constexpr (XTMA) mbar_wait(bar_x, 0);
  if (threadIdx.x == 0) PHASE(4);

  // ---- state = x^T (B o w), one 64 x 64 tile at a time ----
  for (int t = wg; t < PB * NB; t += WGS) {
    const int mt = t / NB, nt = t % NB;
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    keep(sacc);
    wg_fence();
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint64_t da = desc(sX + mt * box_bytes + kk * 16 * 128,
                               box_bytes, ATOM);
      wgmma_ss_tt(sacc, da, desc(sB + nt * box_bytes + kk * 16 * 128,
                                 box_bytes, ATOM));
      wgmma_ss_tt(sacc, da, desc(sC + nt * box_bytes + kk * 16 * 128,
                                 box_bytes, ATOM));
    }
    wg_commit();
    wg_wait_all();
    keep(sacc);
    float* sc_out = st + cell * P * N;
    const int p_lo = mt * 64 + r_lo;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = nt * BOX + 8 * n8 + cq;       // even; N % 16 == 0
      if (col >= N) continue;
      if (p_lo < P)
        *reinterpret_cast<float2*>(sc_out + static_cast<int64_t>(p_lo) * N
                                   + col) =
            make_float2(sacc[4 * n8], sacc[4 * n8 + 1]);
      if (p_lo + 8 < P)
        *reinterpret_cast<float2*>(sc_out
                                   + static_cast<int64_t>(p_lo + 8) * N
                                   + col) =
            make_float2(sacc[4 * n8 + 2], sacc[4 * n8 + 3]);
    }
  }
  if (threadIdx.x == 0) PHASE(5);
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

// [cells, rows, cols] bf16 as the 3-D tensor (cols, rows, cells), boxes
// of (64, rows, 1) with the 128-byte swizzle; out of bounds reads zeros.
bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                int64_t cells, int64_t rows, int64_t cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(cells)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols * 2),
                                 static_cast<cuuint64_t>(rows * cols * 2)};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PB, bool XTMA>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* st, void* dc,
                   int64_t BH, int64_t heads, int64_t chunks, int64_t Q,
                   int64_t P, int64_t N, int round_scores,
                   cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mx = {}, mb, mc;
  if ((XTMA && !tensor_map(&mx, enc, x, BH * chunks, Q, P)) ||
      !tensor_map(&mb, enc, B, BH / heads * chunks, Q, N) ||
      !tensor_map(&mc, enc, C, BH / heads * chunks, Q, N))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem_of(Q, P, N));
  // above 48 KiB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_tc<PB, XTMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_intra_tc<PB, XTMA><<<static_cast<unsigned>(BH * chunks), THREADS, smem,
                           stream>>>(
      mx, mb, mc, static_cast<const uint4*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(dc),
      static_cast<int>(chunks), static_cast<int>(heads), static_cast<int>(Q),
      static_cast<int>(P), static_cast<int>(N), round_scores);
  return cudaGetLastError();
}

bool takes(int64_t Q, int64_t P, int64_t N) {
  return Q % 64 == 0 && Q >= 64 && Q <= 256 && P % 2 == 0 && P > 0 &&
         P <= 256 && N % 16 == 0 && N > 0 && N <= 256;
}

// x by TMA where its rows are whole 32-byte steps, else by the threads
template <int PB>
cudaError_t launch_x(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, void* st,
                     void* dc, int64_t BH, int64_t heads, int64_t chunks,
                     int64_t Q, int64_t P, int64_t N, int round_scores,
                     cudaStream_t s) {
  return P % 16 == 0
             ? launch<PB, true>(x, dt, A, B, C, y, st, dc, BH, heads, chunks,
                                Q, P, N, round_scores, s)
             : launch<PB, false>(x, dt, A, B, C, y, st, dc, BH, heads,
                                 chunks, Q, P, N, round_scores, s);
}

}  // namespace

// Dynamic shared memory the kernel needs for (Q, P, N), in bytes (0 for a
// shape it does not take).
extern "C" int64_t ssd_intra_chunk_tc_smem(int64_t Q, int64_t P, int64_t N) {
  return takes(Q, P, N) ? smem_of(Q, P, N) : 0;
}

// bf16 x [BH, c, Q, P], B/C [BH / heads, c, Q, N] (16-byte aligned); f32
// dt [BH, c, Q], A [BH] -> f32 y [BH, c, Q, P], st [BH, c, P, N], dc
// [BH, c]; all contiguous; P even.  round_scores != 0 rounds C B^T to
// bf16.  The wrapper checks devices, shapes, dtypes and contiguity before
// calling; the limits below are checked again here.
// Returns the launch's cudaError_t.
#ifdef SSD_PHASE_STAMPS
// The stamps of the last launch: STAMPS per block, blocks 0 .. 2^14 - 1.
extern "C" int ssd_phase_stamps(void* dst, size_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, n));
}
#endif

extern "C" cudaError_t ssd_intra_chunk_tc_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* st, void* dc, int64_t BH, int64_t heads,
    int64_t chunks, int64_t Q, int64_t P, int64_t N, int round_scores,
    void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x)
                          | reinterpret_cast<uintptr_t>(B)
                          | reinterpret_cast<uintptr_t>(C);
  if (!takes(Q, P, N) || heads < 1 || BH < 1 || BH % heads != 0 ||
      chunks < 1 || BH * chunks > 0x7fffffffLL || align % 16 != 0 ||
      smem_of(Q, P, N) > SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (boxes(static_cast<int>(P))) {
    case 1:
      return launch_x<1>(x, dt, A, B, C, y, st, dc, BH, heads, chunks, Q, P, N,
                         round_scores, s);
    case 2:
      return launch_x<2>(x, dt, A, B, C, y, st, dc, BH, heads, chunks, Q, P, N,
                         round_scores, s);
    case 3:
      return launch_x<3>(x, dt, A, B, C, y, st, dc, BH, heads, chunks, Q, P, N,
                         round_scores, s);
    default:
      return launch_x<4>(x, dt, A, B, C, y, st, dc, BH, heads, chunks, Q, P, N,
                         round_scores, s);
  }
}
