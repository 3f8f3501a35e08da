// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 inputs.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bhsd (its _kernel) for bf16 q [BH, Sq, hd] and k, v
// [BHkv, Skv, hd] with hd % 8 == 0 and 64 <= hd <= 256; query head bh reads
// kv head bh / (BH / BHkv).  It computes what the Pallas kernel computes:
// the score scale hd^-0.5 applied after the product, masked scores at
// -1e30 (causal kpos <= qpos, window kpos > qpos - window, padding
// kpos < Skv, qpos = row + q_offset), f32 m, l and accumulator, the
// denominator clamped at 1e-30, bf16 output.  The softmax runs in base 2
// on scores pre-multiplied by log2(e).  P enters the P V product as two
// bf16 terms, P = P_hi + P_lo (error ~2^-17 p): one bf16 rounding of P
// (2^-9 of each term) lets rows with few keys and cancelling terms miss
// the output by more than one bf16 ulp, so the second product buys f32
// accuracy for half again the tensor-core work.  f32 inputs and other
// head dims take flash_attention.cu (the route is chosen in
// kernels/flash_attention.py).
//
// Bound: operations.  At granite-8b's shape (B 2, S 4096, 32/8 heads,
// hd 128, causal) the two products are ~275 GFLOP against ~0.2 GB of
// inputs and outputs: 0.28 ms at the bf16 tensor-core peak, far above the
// card's ops-per-byte line.  So both products run on the tensor cores
// (wgmma, f32 accumulate) and the tiles arrive by TMA while they run.
//
// Design: one block per (bh, 128 query rows), three warpgroups.
// - Warpgroup 2 is the producer: one thread loads the Q tile once and then
//   keeps K and V tiles in flight through a ring of STAGES stages, with a
//   full barrier per stage for K and one for V (TMA completes them) and an
//   empty barrier the consumers' eight warps release.  It gives up
//   registers (setmaxnreg.dec) to the consumers (setmaxnreg.inc).
// - Warpgroups 0 and 1 are consumers, 64 query rows each.  S = Q K^T is
//   wgmma m64nBKVk16 with Q and K from shared memory, both K-major; O +=
//   P V is wgmma m64n64k16 per 64 columns of the head and per term of P,
//   P from registers (S's f32 accumulator fragment converted in place to
//   bf16 pairs: the m64nN accumulator layout equals the A-register
//   fragment layout of the next product) and V from shared memory,
//   MN-major (transpose bit).
// - Tiles are stored as TMA wrote them with the 128-byte swizzle: a
//   row of 64 bf16 per 128 bytes, 8-row atoms of 1024 bytes, a 128- or
//   256-wide head as 2 or 4 such boxes.  q, k and v are described as 3-D
//   tensors (hd, S, BH), so a ragged tile is zero-filled by TMA and never
//   reads the next head's rows; a head narrower than its padded width is
//   zero-filled the same way.
// - Online softmax on the accumulator fragment: a thread holds two rows,
//   each spread over the four threads of a quad (shuffles 1 and 2).  The
//   masks are applied only on tiles that cross a mask edge.
// - Tiles masked for every row of the block are not loaded; a consumer
//   skips the tiles masked for all of its 64 rows (exact for every row
//   with an unmasked key, as in flash_attention.cu).  The heaviest causal
//   query tiles are scheduled first.
// Tiles: the head padded to 64, 128, 192 or 256 columns (a whole number
// of boxes, each starting inside the head); 128 keys per tile up to 128
// columns (160 KiB of shared memory at hd 128), 64 keys above (192 KiB at
// hd 256).  One block per SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                   // query rows per block
constexpr int CONSUMERS = 2;              // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int BOX = 64;                   // bf16 per 128-byte swizzled row
constexpr int ATOM = 1024;                // 8 rows x 128 bytes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HDP>
struct Tiles {
  static constexpr int BKV = HDP > 128 ? 64 : 128;    // keys per tile
  static constexpr int NB = HDP / BOX;                // boxes per row
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BKV * HDP * 2;      // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // + slack to align the tiles to an atom
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES
                              + ATOM;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
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
// wait that makes them valid.
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory,
// both K-major (transpose bits 0); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory,
// both K-major (transpose bits 0); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A (bf16x2 pairs) from registers,
// B from shared memory, MN-major (transpose bit 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int BKV>
__device__ __forceinline__ void mma_qk(float (&s)[BKV / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (BKV == 128)
    wgmma_ss_n128(s, a, b, scale_d);
  else
    wgmma_ss_n64(s, a, b, scale_d);
}

// Accumulator fragment of wgmma m64nN (f32), thread t of the warpgroup,
// warp w = t / 32, lane: element i is row 16 w + lane / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (lane % 4) + i % 2.
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 __nv_bfloat16* __restrict__ o, int Sq, int Skv, int hd,
                 int group, int causal, int window, int q_offset,
                 float scale_log2) {
  using T = Tiles<HDP>;
  constexpr int BKV = T::BKV, NB = T::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + ATOM - 1) & ~uint32_t(ATOM - 1);
  const uint32_t sK = sQ + T::Q_BYTES;             // + stage * KV_BYTES
  const uint32_t sV = sK + STAGES * T::KV_BYTES;
  const uint32_t qbar = sV + STAGES * T::KV_BYTES;
  const uint32_t full_k = qbar + 8;                // + 8 * stage
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty = full_v + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  // keys that some row of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_begin = 0, k_end = Skv;
  if (causal) k_end = min(Skv, q_last + q_offset + 1);
  if (window) k_begin = max(0, q0 + q_offset - window + 1);
  const int kt0 = (k_begin / BKV) * BKV;
  const int ntiles = k_end > kt0 ? (k_end - kt0 + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);      // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const int bhkv = bh / group;
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(sQ + j * BQ * 128, &mq, qbar, j * BOX, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const int kt = kt0 + t * BKV;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(sK + s * T::KV_BYTES + j * BKV * 128, &mk, full_k + 8 * s,
                   j * BOX, kt, bhkv);
        mbar_expect_tx(full_v + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(sV + s * T::KV_BYTES + j * BKV * 128, &mv, full_v + 8 * s,
                   j * BOX, kt, bhkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rw = q0 + 64 * wg;                 // first row of the group
    const int r_lo = 16 * warp + lane / 4;       // rows r_lo and r_lo + 8
    const int cq = 2 * (lane % 4);
    const int qa = rw + q_offset, qb = qa + 63;  // positions of its rows
    const bool idle = rw >= Sq;

    float acc[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

    mbar_wait(qbar, 0);
    __syncwarp();
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      const uint32_t par = (t / STAGES) & 1;
      const int kt = kt0 + t * BKV;
      const bool skip = idle || (causal && kt > qb)
                        || (window && kt + BKV - 1 <= qa - window);
      mbar_wait(full_k + 8 * s, par);
      __syncwarp();
      if (!skip) {
        // S = Q K^T over the head, 16 columns per wgmma
        wg_fence();
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int kk = 0; kk < BOX / 16; ++kk)
            mma_qk<BKV>(
                sc, desc(sQ + j * BQ * 128 + wg * 64 * 128 + kk * 32, 16, ATOM),
                desc(sK + s * T::KV_BYTES + j * BKV * 128 + kk * 32, 16, ATOM),
                (j | kk) != 0);
        wg_commit();
        wg_wait_all();
        keep(sc);

        const bool edge = kt + BKV > Skv || (causal && kt + BKV - 1 > qa)
                          || (window && kt <= qb - window);
        float mx_lo = NEG, mx_hi = NEG;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float x = sc[i] * scale_log2;
          if (edge) {
            const int kpos = kt + 8 * (i / 4) + cq + (i % 2);
            const int qpos = qa + r_lo + 8 * ((i / 2) % 2);
            bool ok = kpos < Skv;
            if (causal) ok = ok && kpos <= qpos;
            if (window) ok = ok && kpos > qpos - window;
            x = ok ? x : NEG;
          }
          sc[i] = x;
          if ((i / 2) % 2) mx_hi = fmaxf(mx_hi, x);
          else mx_lo = fmaxf(mx_lo, x);
        }
        const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
        const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
        const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const bool hi = (i / 2) % 2;
          const float p = exp2f(sc[i] - (hi ? mn_hi : mn_lo));
          sc[i] = p;
          if (hi) rs_hi += p;
          else rs_lo += p;
        }
        l_lo = l_lo * al_lo + quad_sum(rs_lo);
        l_hi = l_hi * al_hi + quad_sum(rs_hi);
        // P = P_hi + P_lo as the A fragments of the next product: keys
        // 16 kk .. +15
        uint32_t pa[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
            const float2 hf = __bfloat1622float2(h);
            pa[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
            pl[kk][r] = pack_bf16(a - hf.x, b - hf.y);
          }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[j][i] *= (i / 2) % 2 ? al_hi : al_lo;

        // O += P V, 64 columns of the head per wgmma
        mbar_wait(full_v + 8 * s, par);
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const uint64_t dv = desc(sV + s * T::KV_BYTES + j * BKV * 128
                                     + kk * 16 * 128, BKV * 128, ATOM);
            wgmma_rs_n64(acc[j], pa[kk], dv);
            wgmma_rs_n64(acc[j], pl[kk], dv);
          }
        wg_commit();
        wg_wait_all();
        keep(pa);
        keep(pl);
#pragma unroll
        for (int j = 0; j < NB; ++j) keep(acc[j]);
      } else {
        mbar_wait(full_v + 8 * s, par);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // epilogue: O / max(l, 1e-30) in bf16, rows < Sq and columns < hd
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = o + static_cast<int64_t>(bh) * Sq * hd;
    const int row_lo = rw + r_lo, row_hi = row_lo + 8;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int col = j * BOX + 8 * n8 + cq;      // even; hd is even
        if (col >= hd) continue;
        if (row_lo < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(row_lo) * hd + col) =
              __floats2bfloat162_rn(acc[j][4 * n8] / den_lo,
                                    acc[j][4 * n8 + 1] / den_lo);
        if (row_hi < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(row_hi) * hd + col) =
              __floats2bfloat162_rn(acc[j][4 * n8 + 2] / den_hi,
                                    acc[j][4 * n8 + 3] / den_hi);
      }
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

// [heads, rows, hd] bf16 as the 3-D tensor (hd, rows, heads), boxes of
// (64, box_rows, 1) with the 128-byte swizzle; out of bounds reads zeros.
bool tensor_map(CUtensorMap* map, EncodeTiled enc, const void* ptr,
                int64_t heads, int64_t rows, int64_t hd, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd * 2),
                                 static_cast<cuuint64_t>(rows * hd * 2)};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t BH, int64_t BHkv, int64_t Sq, int64_t Skv,
                   int64_t hd, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  using T = Tiles<HDP>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, enc, q, BH, Sq, hd, BQ) ||
      !tensor_map(&mk, enc, k, BHkv, Skv, hd, T::BKV) ||
      !tensor_map(&mv, enc, v, BHkv, Skv, hd, T::BKV))
    return cudaErrorInvalidValue;
  // above 48 KiB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_fwd_tc<HDP><<<grid, THREADS, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<int>(Sq),
      static_cast<int>(Skv), static_cast<int>(hd),
      static_cast<int>(BH / BHkv), causal, window, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o; hd % 8 == 0 and 64 <= hd <= 256; every pointer
// 16-byte aligned.  The wrapper checks devices, shapes, dtypes and
// contiguity before calling; the limits below are checked again here.
// Returns the launch's cudaError_t.
extern "C" cudaError_t flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t BH,
    int64_t BHkv, int64_t Sq, int64_t Skv, int64_t hd, int causal,
    int64_t window, int64_t q_offset, float scale, void* stream) {
  const int64_t lim = 1LL << 30;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q)
                          | reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v)
                          | reinterpret_cast<uintptr_t>(o);
  if (BH < 1 || BHkv < 1 || BH % BHkv != 0 || BH > 0x7fffffffLL ||
      Sq < 1 || Skv < 1 || Sq >= lim || Skv >= lim ||
      (Sq + BQ - 1) / BQ > 65535 || hd % 8 != 0 || hd < 64 || hd > 256 ||
      window < 0 || window >= lim || q_offset <= -lim || q_offset >= lim ||
      align % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window), qo = static_cast<int>(q_offset);
  if (hd <= 64)
    return launch<64>(q, k, v, o, BH, BHkv, Sq, Skv, hd, causal, w, qo,
                      scale, s);
  if (hd <= 128)
    return launch<128>(q, k, v, o, BH, BHkv, Sq, Skv, hd, causal, w, qo,
                       scale, s);
  if (hd <= 192)
    return launch<192>(q, k, v, o, BH, BHkv, Sq, Skv, hd, causal, w, qo,
                       scale, s);
  return launch<256>(q, k, v, o, BH, BHkv, Sq, Skv, hd, causal, w, qo,
                     scale, s);
}

// Dynamic shared memory of the instance that takes head dim hd, in bytes
// (0 for a head dim the kernel does not take).
extern "C" int flash_attention_tc_smem(int64_t hd) {
  if (hd % 8 != 0 || hd < 64 || hd > 256) return 0;
  if (hd <= 64) return Tiles<64>::SMEM;
  if (hd <= 128) return Tiles<128>::SMEM;
  if (hd <= 192) return Tiles<192>::SMEM;
  return Tiles<256>::SMEM;
}
