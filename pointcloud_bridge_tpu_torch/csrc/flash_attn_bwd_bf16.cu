// K6b, bfloat16: multi-head attention backward without the score matrix in
// device memory (flash attention, dq and dk/dv), bf16 in and out.
//
// Replaces: the VJP of the bf16 attention that
// pointcloud_bridge_tpu/models/ptv3.py:74 (_attention) runs when the model
// computes or streams in bfloat16: on the TPU the library Pallas kernel's
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq (sized by
// ptv3.py:154-156) in bf16.
//
// Semantics: for every batch row b and head h, with scale = 1/sqrt(D) and
// every product from bf16 operands summed in float32,
//   P[i, j]  = exp(scale * q_i . k_j - lse_i)      (float32)
//   delta_i  = sum_d o[i, d] * do[i, d]            (float32)
//   dP[i, j] = do_i . v_j                          (float32)
//   dS       = P * (dP - delta_i)                  (float32)
//   dv_j = sum_i bf16(P[i, j]) do_i
//   dq_i = scale * sum_j bf16(dS[i, j]) k_j
//   dk_j = scale * sum_i bf16(dS[i, j]) q_i
// each of dq, dk, dv rounded to bf16 once at the end. q, k, v are [B, N, H,
// D] bf16 with a row stride each (ldq, ldk, ldv, in elements), read in place
// from the packed qkv projection as in the forward; o and do are contiguous
// [B, N, H, D] bf16; lse is the forward's [B, H, N] float32 row statistic;
// delta is [B, H, N] float32; dq, dk, dv are written contiguous as
// [B, N, H, D] bf16. P, dP and dS exist a tile at a time in registers only.
//
// What bounds it on the H100: operations, as the forward. Five N x N x D
// products are the least a backward does (10*B*H*N*N*D operations against
// 18*B*N*H*D bytes); at the dense bf16 tensor rate the arithmetic is the
// floor from N = 530 up.
//
// Design: the owner design of the float32 kernels (flash_attn_bwd.cu), two
// kernels and no atomics, so the result is the same bits from run to run,
// on the forward's machinery (flash_attn_bf16.cuh): a producer warpgroup
// whose one thread asks the TMA for the block's resident tiles once and for
// the streamed tiles into a ring of stages under full and empty mbarriers,
// and consumer warpgroups of 64 rows that run every product as wgmma, the
// first products from shared memory, the second from the float32
// accumulators of the first rounded to bf16 in registers, a step behind
// (the second products of step j - 1 run while step j's P and dS are
// computed), the two consumer warpgroups of a block issuing their products
// in turns (flash_attn_bf16.cuh).
//  - pcb_flash_attn_bwd_dq_bf16: a block owns a (batch, head) and 128 query
//    rows (64 where the grid of 128-row tiles would not fill the SMs), keeps
//    their q and do tiles and streams k and v. Each consumer warp first
//    computes delta for its 16 rows (o against do, a row at a time, 8
//    channels a lane) and writes it for the dk/dv kernel, which therefore
//    runs after it on the same stream. A step: S = q . k^T and dP = do . v^T,
//    dS = P * (dP - delta) in place, dq += bf16(dS) . k (k MN-major).
//  - pcb_flash_attn_bwd_dkv_bf16: a block owns a (batch, head) and keys, and
//    streams q and do; the producer's second warp puts each step's lse
//    (+inf past N, so that P = exp2(-inf) = 0) and delta into the stage
//    beside them, under the same full barrier. A step: S^T = k . q^T and dP^T = v . do^T, then
//    dv += bf16(P^T) . do and dk += bf16(dS^T) . q. To D = 128 a consumer
//    warpgroup owns 64 keys and both sums (a block 128 keys or 64). From
//    D = 160 up the two sums (D floats a thread) do not fit its registers
//    beside S^T and dP^T: a block's two warpgroups share 64 keys, one sums
//    dv (S^T, P^T), the other dk (S^T, dP^T, dS^T), and S^T is the one
//    product computed twice (the tile plan, flash_attn_bf16.cuh).
//
// Ragged N: the TMA reads rows past N as zeros. In dq, keys past N get P =
// 0 and rows past N are not stored. In dk/dv, query rows past N get P = 0
// from their lse and key rows past N are not stored.
//
// The library is built with -fmad=false; a fused operation here is written
// as fmaf().
#include <cmath>

#include "flash_attn_bf16.cuh"

namespace {

using flash_bf16::bf16;
using flash_bf16::kGroup;
using flash_bf16::kRows;
using flash_bf16::Plan;
using flash_bf16::tile_bytes;

template <int D>
constexpr size_t dq_smem_bytes() {
  return flash_bf16::smem_bytes(D, 4, Plan<D>::dq_bn, Plan<D>::dq_stages, 0);
}

// the resident k and v tiles (two of each without the split, one with it),
// the ring, and a stage's (lse, delta) of its queries
template <int D>
constexpr size_t dkv_smem_bytes() {
  return flash_bf16::smem_bytes(D, Plan<D>::dkv_split ? 2 : 4, Plan<D>::dkv_bq,
                                Plan<D>::dkv_stages, Plan<D>::dkv_stages * 2 * Plan<D>::dkv_bq);
}

template <int D>
__global__ void __launch_bounds__(flash_bf16::kMaxThreads, 1)
flash_attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const bf16* __restrict__ o, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, bf16* __restrict__ dq,
                              float* __restrict__ delta, int n, int heads, int tiles,
                              float scale) {
  constexpr int BN = Plan<D>::dq_bn;
  constexpr int STAGES = Plan<D>::dq_stages;
  constexpr uint32_t kQ = tile_bytes(kRows, D);
  constexpr uint32_t kKV = tile_bytes(BN, D);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = flash_bf16::aligned_base(smem_raw);  // 2 q tiles
  const uint32_t sdo = sq + 2 * kQ;                          // 2 do tiles
  const uint32_t ring = sdo + 2 * kQ;                        // STAGES x (k, v)
  const uint32_t bars = ring + STAGES * 2 * kKV;
  const uint32_t resbar = bars + 2 * STAGES * 8;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int groups = blockDim.x / kGroup - 1;
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kRows * groups;
  const int steps = (n + BN - 1) / BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      flash_bf16::mbar_init(full(s), 1);
      flash_bf16::mbar_init(empty(s), 4 * groups);
    }
    flash_bf16::mbar_init(resbar, 1);
    flash_bf16::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= groups * kGroup) {
    flash_bf16::producer_registers();
    if (threadIdx.x == groups * kGroup) {
      flash_bf16::mbar_expect(resbar, 2 * groups * kQ);
      for (int w = 0; w < groups; ++w) {
        flash_bf16::load_tile<D, kRows>(sq + w * kQ, &tq, resbar, h * D, i0 + w * kRows, b);
        flash_bf16::load_tile<D, kRows>(sdo + w * kQ, &tdo, resbar, h * D, i0 + w * kRows, b);
      }
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        flash_bf16::mbar_wait(empty(s), ((step / STAGES) & 1) ^ 1);
        flash_bf16::mbar_expect(full(s), 2 * kKV);
        const uint32_t dst = ring + s * 2 * kKV;
        flash_bf16::load_tile<D, BN>(dst, &tk, full(s), h * D, step * BN, b);
        flash_bf16::load_tile<D, BN>(dst + kKV, &tv, full(s), h * D, step * BN, b);
      }
    }
    return;
  }
  flash_bf16::consumer_registers();

  const int wg = threadIdx.x / kGroup;
  const int warp = threadIdx.x % kGroup / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = i0 + wg * kRows + warp * 16;  // the warp's first row
  const long long ldo = (long long)heads * D;
  const size_t stat0 = (size_t)bh * n;

  // delta of the warp's 16 rows, a row at a time, 8 channels a lane, while
  // the copies fly; each thread keeps those of its rows g and g + 8
  float dl[2] = {0.f, 0.f};
  {
    const bf16* ob = o + (size_t)b * n * ldo + (size_t)h * D;
    const bf16* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float part = 0.f;
      if (row < n) {
        for (int c = 8 * lane; c < D; c += 256) {
          const uint4 ov = *reinterpret_cast<const uint4*>(ob + (size_t)row * ldo + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(dob + (size_t)row * ldo + c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            part = fmaf(of.x, gf.x, part);
            part = fmaf(of.y, gf.y, part);
          }
        }
      }
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) part += __shfl_xor_sync(0xffffffffu, part, w);
      if (r == g) dl[0] = part;
      if (r == g + 8) dl[1] = part;
      if (lane == 0 && row < n) delta[stat0 + row] = part;
    }
  }
  // the base-2 lse of rows g and g + 8
  float ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    ls[r] = row < n ? lse[stat0 + row] * flash::kLog2e : 0.f;
  }
  const float scale_log2e = scale * flash::kLog2e;
  const bool turns = groups == 2;  // the warpgroups' products in turns
  const uint32_t my_q = sq + wg * kQ;
  const uint32_t my_do = sdo + wg * kQ;
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;

  // S = q . k^T and dP = do . v^T of a step (rows g + 8 r against keys j0 +
  // 8 j + 2 t + e), asked for once the step's tiles are in, not waited
  auto firsts = [&](int step, float (&s)[BN / 2], float (&dp)[BN / 2]) {
    const int stage = step % STAGES;
    const uint32_t sk = ring + stage * 2 * kKV;
    flash_bf16::mbar_wait(full(stage), (step / STAGES) & 1);
    if (turns) flash_bf16::turn_wait(wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    flash_bf16::wgmma_fence();
    flash_bf16::dot_rows<D, BN>(s, my_q, sk);
    flash_bf16::dot_rows<D, BN>(dp, my_do, sk + kKV);
    flash_bf16::wgmma_commit();
  };
  // dS = P * (dP - delta) of a step into x (s and dp are only read, as in
  // the forward's softmax)
  auto grad = [&](int step, const float (&s)[BN / 2], const float (&dp)[BN / 2],
                  float (&x)[BN / 2], bool ragged) {  // a constant where it is called
    const int j0 = step * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = !ragged || j0 + 8 * j + 2 * t + (e & 1) < n;
        const float p =
            valid ? flash_bf16::exp2_ftz(fmaf(s[4 * j + e], scale_log2e, -ls[e >> 1])) : 0.f;
        x[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
      }
    }
  };

  // The loop runs a step behind on dq += bf16(dS) . k, as the forward does
  // on p . v: step j asks for S_j and dP_j, then for the second product of
  // step j - 1, and computes dS_j while that product runs.
  uint32_t ds[BN / 16][4];  // dS of the step before, bf16, the A operand
  flash_bf16::mbar_wait(resbar, 0);
  if (turns && wg == 1) flash_bf16::turn_pass(wg);
  {
    float s[BN / 2], dp[BN / 2], x[BN / 2];
    firsts(0, s, dp);
    if (turns) flash_bf16::turn_pass(wg);
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(s);
    flash_bf16::fence_regs(dp);
    if (BN > n) {
      grad(0, s, dp, x, true);
    } else {
      grad(0, s, dp, x, false);
    }
    flash_bf16::to_operand<BN>(x, ds);
  }
  for (int step = 1; step < steps; ++step) {
    const int prev = (step - 1) % STAGES;
    const uint32_t sk_prev = ring + prev * 2 * kKV;
    float s[BN / 2], dp[BN / 2], x[BN / 2];
    firsts(step, s, dp);
    // acc += bf16(dS) . k of the step before, from the registers
    flash_bf16::weighted_rows<D, BN>(acc, ds, sk_prev, BN);
    flash_bf16::wgmma_commit();
    if (turns) flash_bf16::turn_pass(wg);
    flash_bf16::wgmma_wait<1>();
    flash_bf16::fence_regs(s);
    flash_bf16::fence_regs(dp);
    if ((step + 1) * BN > n) {  // keys past N in the step
      grad(step, s, dp, x, true);
    } else {
      grad(step, s, dp, x, false);
    }
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(acc);
    if (lane == 0) flash_bf16::mbar_arrive(empty(prev));
    flash_bf16::to_operand<BN>(x, ds);
  }
  if (turns && wg == 0) flash_bf16::turn_wait(wg);
  // the last step's second product
  const uint32_t sk_last = ring + ((steps - 1) % STAGES) * 2 * kKV;
  flash_bf16::weighted_rows<D, BN>(acc, ds, sk_last, BN);
  flash_bf16::wgmma_commit();
  flash_bf16::wgmma_wait<0>();
  flash_bf16::fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    bf16* dst = dq + (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
    }
  }
}

// What a dk/dv consumer warpgroup needs: its keys' tiles, the ring, its
// statistics buffers, the barriers and the block's coordinates.
struct DkvArgs {
  uint32_t sk, sv, ring, bars, resbar;
  const float* stats;  // a stage's (lse, delta) of the step's queries, in the ring
  bf16* dk;
  bf16* dv;
  int n, heads, b, h, key0, steps, wg;
  bool turns;  // two consumer warpgroups, their products in turns
  float scale;
};

// One consumer warpgroup of the dk/dv kernel over the keys key0 .. key0 +
// 63: dv's sum where DV, dk's where DK (both without the split).
template <int D, bool DV, bool DK>
__device__ __forceinline__ void dkv_consumer(const DkvArgs& a) {
  constexpr int BQ = Plan<D>::dkv_bq;
  constexpr int STAGES = Plan<D>::dkv_stages;
  constexpr uint32_t kQ = tile_bytes(BQ, D);
  const int warp = threadIdx.x % kGroup / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale_log2e = a.scale * flash::kLog2e;
  float accv[DV ? D / 2 : 2], acck[DK ? D / 2 : 2];
#pragma unroll
  for (int c = 0; c < (DV ? D / 2 : 2); ++c) accv[c] = 0.f;
#pragma unroll
  for (int c = 0; c < (DK ? D / 2 : 2); ++c) acck[c] = 0.f;

  // S^T = k . q^T and dP^T = v . do^T of a step (keys g + 8 r against
  // queries 8 j + 2 t + e of the step), asked for once the step's tiles
  // and statistics are in, not waited
  auto firsts = [&](int step, float (&s)[BQ / 2], float (&dp)[DK ? BQ / 2 : 2]) {
    const int stage = step % STAGES;
    const uint32_t sq = a.ring + stage * 2 * kQ;
    flash_bf16::mbar_wait(a.bars + 8 * stage, (step / STAGES) & 1);
    if (a.turns) flash_bf16::turn_wait(a.wg);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = 0.f;
    if constexpr (DK) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) dp[i] = 0.f;
    }
    flash_bf16::wgmma_fence();
    flash_bf16::dot_rows<D, BQ>(s, a.sk, sq);
    if constexpr (DK) flash_bf16::dot_rows<D, BQ>(dp, a.sv, sq + kQ);
    flash_bf16::wgmma_commit();
  };
  // P^T into x, dS^T = P^T * (dP^T - delta) into y (s and dp are only read)
  auto grads = [&](int step, const float (&s)[BQ / 2], const float (&dp)[DK ? BQ / 2 : 2],
                   float (&x)[BQ / 2], float (&y)[DK ? BQ / 2 : 2]) {
    const float* st = a.stats + (step % STAGES) * 2 * BQ;  // lse, delta
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
      const float2 dlq = *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = flash_bf16::exp2_ftz(fmaf(s[4 * j + e], scale_log2e, e & 1 ? -lq.y : -lq.x));
        x[4 * j + e] = p;
        if constexpr (DK) y[4 * j + e] = p * (dp[4 * j + e] - (e & 1 ? dlq.y : dlq.x));
      }
    }
  };

  // The loop runs a step behind on the second products, as the forward and
  // dq do: step j asks for S^T_j and dP^T_j, then for dv += bf16(P^T) . do
  // and dk += bf16(dS^T) . q of step j - 1 (do and q MN-major), and
  // computes P^T_j and dS^T_j while those run.
  uint32_t pt[DV ? BQ / 16 : 1][4], dst[DK ? BQ / 16 : 1][4];  // the step before's
  flash_bf16::mbar_wait(a.resbar, 0);
  if (a.turns && a.wg == 1) flash_bf16::turn_pass(a.wg);
  {
    float s[BQ / 2], dp[DK ? BQ / 2 : 2], x[BQ / 2], y[DK ? BQ / 2 : 2];
    firsts(0, s, dp);
    if (a.turns) flash_bf16::turn_pass(a.wg);
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(s);
    flash_bf16::fence_regs(dp);
    grads(0, s, dp, x, y);
    if constexpr (DV) flash_bf16::to_operand<BQ>(x, pt);
    if constexpr (DK) flash_bf16::to_operand<BQ>(y, dst);
  }
  for (int step = 1; step < a.steps; ++step) {
    const int prev = (step - 1) % STAGES;
    const uint32_t sq = a.ring + prev * 2 * kQ;
    const uint32_t sdo = sq + kQ;
    float s[BQ / 2], dp[DK ? BQ / 2 : 2], x[BQ / 2], y[DK ? BQ / 2 : 2];
    firsts(step, s, dp);
    if constexpr (DV) flash_bf16::weighted_rows<D, BQ>(accv, pt, sdo, BQ);
    if constexpr (DK) flash_bf16::weighted_rows<D, BQ>(acck, dst, sq, BQ);
    flash_bf16::wgmma_commit();
    if (a.turns) flash_bf16::turn_pass(a.wg);
    flash_bf16::wgmma_wait<1>();
    flash_bf16::fence_regs(s);
    flash_bf16::fence_regs(dp);
    grads(step, s, dp, x, y);
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(accv);
    flash_bf16::fence_regs(acck);
    if (lane == 0) flash_bf16::mbar_arrive(a.bars + 8 * (STAGES + prev));
    if constexpr (DV) flash_bf16::to_operand<BQ>(x, pt);
    if constexpr (DK) flash_bf16::to_operand<BQ>(y, dst);
  }
  if (a.turns && a.wg == 0) flash_bf16::turn_wait(a.wg);
  {
    // the last step's second products
    const uint32_t sq_last = a.ring + ((a.steps - 1) % STAGES) * 2 * kQ;
    if constexpr (DV) flash_bf16::weighted_rows<D, BQ>(accv, pt, sq_last + kQ, BQ);
    if constexpr (DK) flash_bf16::weighted_rows<D, BQ>(acck, dst, sq_last, BQ);
    flash_bf16::wgmma_commit();
    flash_bf16::wgmma_wait<0>();
    flash_bf16::fence_regs(accv);
    flash_bf16::fence_regs(acck);
  }

  const long long ldo = (long long)a.heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = a.key0 + warp * 16 + g + 8 * r;
    if (row >= a.n) continue;
    const size_t off = ((size_t)a.b * a.n + row) * ldo + (size_t)a.h * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if constexpr (DK) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * c) = __floats2bfloat162_rn(
            acck[4 * c + 2 * r] * a.scale, acck[4 * c + 2 * r + 1] * a.scale);
      }
      if constexpr (DV) {
        *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * c) =
            __floats2bfloat162_rn(accv[4 * c + 2 * r], accv[4 * c + 2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(flash_bf16::kMaxThreads, 1)
flash_attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int heads,
                               int tiles, float scale) {
  constexpr int BQ = Plan<D>::dkv_bq;
  constexpr int STAGES = Plan<D>::dkv_stages;
  constexpr bool SPLIT = Plan<D>::dkv_split;
  constexpr uint32_t kK = tile_bytes(kRows, D);
  constexpr uint32_t kQ = tile_bytes(BQ, D);
  constexpr int KT = SPLIT ? 1 : 2;  // resident key tiles of each of k and v
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sk = flash_bf16::aligned_base(smem_raw);  // KT k tiles
  const uint32_t sv = sk + KT * kK;                          // KT v tiles
  const uint32_t ring = sv + KT * kK;                        // STAGES x (q, do)
  const uint32_t stats = ring + STAGES * 2 * kQ;             // STAGES x (lse, delta)
  const uint32_t bars = stats + STAGES * 2 * BQ * sizeof(float);
  const uint32_t resbar = bars + 2 * STAGES * 8;

  const int groups = blockDim.x / kGroup - 1;
  const int key_tiles = SPLIT ? 1 : groups;  // 64-key tiles a block
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j0 = tile * kRows * key_tiles;
  const int steps = (n + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's arrival and one of each lane of the statistics warp
      flash_bf16::mbar_init(bars + 8 * s, 1 + 32);
      flash_bf16::mbar_init(bars + 8 * (STAGES + s), 4 * groups);
    }
    flash_bf16::mbar_init(resbar, 1);
    flash_bf16::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= groups * kGroup) {
    flash_bf16::producer_registers();
    const int pt = threadIdx.x - groups * kGroup;
    if (pt >= 32 && pt < 64) {
      // the producer's second warp: a step's base-2 lse (+inf past N, so
      // that P = exp2(-inf) = 0) and delta into the stage, then an arrival
      // on its full barrier, which releases them to the consumers
      float* st = reinterpret_cast<float*>(smem_raw + (stats - flash_bf16::smem_u32(smem_raw)));
      const size_t stat0 = (size_t)bh * n;
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        flash_bf16::mbar_wait(bars + 8 * (STAGES + s), ((step / STAGES) & 1) ^ 1);
        for (int i = pt - 32; i < BQ; i += 32) {
          const int row = step * BQ + i;
          st[s * 2 * BQ + i] = row < n ? lse[stat0 + row] * flash::kLog2e : INFINITY;
          st[s * 2 * BQ + BQ + i] = row < n ? delta[stat0 + row] : 0.f;
        }
        flash_bf16::mbar_arrive(bars + 8 * s);
      }
    }
    if (pt == 0) {
      flash_bf16::mbar_expect(resbar, 2 * key_tiles * kK);
      for (int w = 0; w < key_tiles; ++w) {
        flash_bf16::load_tile<D, kRows>(sk + w * kK, &tk, resbar, h * D, j0 + w * kRows, b);
        flash_bf16::load_tile<D, kRows>(sv + w * kK, &tv, resbar, h * D, j0 + w * kRows, b);
      }
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        flash_bf16::mbar_wait(bars + 8 * (STAGES + s), ((step / STAGES) & 1) ^ 1);
        flash_bf16::mbar_expect(bars + 8 * s, 2 * kQ);
        const uint32_t dst = ring + s * 2 * kQ;
        flash_bf16::load_tile<D, BQ>(dst, &tq, bars + 8 * s, h * D, step * BQ, b);
        flash_bf16::load_tile<D, BQ>(dst + kQ, &tdo, bars + 8 * s, h * D, step * BQ, b);
      }
    }
    return;
  }
  flash_bf16::consumer_registers();

  const int wg = threadIdx.x / kGroup;
  const int kt = SPLIT ? 0 : wg;  // the warpgroup's key tile
  const float* stats_buf =
      reinterpret_cast<const float*>(smem_raw + (stats - flash_bf16::smem_u32(smem_raw)));
  const DkvArgs args{sk + kt * kK, sv + kt * kK, ring, bars, resbar, stats_buf, dk, dv,
                     n, heads, b, h, j0 + kt * kRows, steps, wg, groups == 2, scale};
  if constexpr (SPLIT) {
    if (wg == 0) {
      dkv_consumer<D, true, false>(args);
    } else {
      dkv_consumer<D, false, true>(args);
    }
  } else {
    dkv_consumer<D, true, true>(args);
  }
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* dout, const float* lse, bf16* dq, float* delta, int b,
                      int n, int heads, long long ldq, long long ldk, long long ldv,
                      int device, cudaStream_t st) {
  constexpr int BN = Plan<D>::dq_bn;
  constexpr size_t bytes = dq_smem_bytes<D>();
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bwd_dq_bf16_kernel<D>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  const int hd = heads * D;
  if ((err = flash_bf16::rows_map(&tq, q, b, n, hd, ldq, kRows)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tk, k, b, n, hd, ldk, BN)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tv, v, b, n, hd, ldv, BN)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tdo, dout, b, n, hd, hd, kRows)) != cudaSuccess) return err;
  const int groups = flash_bf16::consumer_groups(b, heads, n, device);
  const int tiles = (n + kRows * groups - 1) / (kRows * groups);
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), kGroup * (groups + 1), bytes, st>>>(
      tq, tk, tv, tdo, o, dout, lse, dq, delta, n, heads, tiles, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dk, bf16* dv, int b, int n,
                       int heads, long long ldq, long long ldk, long long ldv, int device,
                       cudaStream_t st) {
  constexpr int BQ = Plan<D>::dkv_bq;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bwd_dkv_bf16_kernel<D>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  const int hd = heads * D;
  if ((err = flash_bf16::rows_map(&tq, q, b, n, hd, ldq, BQ)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tk, k, b, n, hd, ldk, kRows)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tv, v, b, n, hd, ldv, kRows)) != cudaSuccess) return err;
  if ((err = flash_bf16::rows_map(&tdo, dout, b, n, hd, hd, BQ)) != cudaSuccess) return err;
  // with the split, two warpgroups share a block's 64 keys
  const int groups = Plan<D>::dkv_split ? 2 : flash_bf16::consumer_groups(b, heads, n, device);
  const int keys = Plan<D>::dkv_split ? kRows : kRows * groups;
  const int tiles = (n + keys - 1) / keys;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), kGroup * (groups + 1), bytes, st>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, n, heads, tiles, scale);
  return cudaGetLastError();
}

}  // namespace
// For both: d a multiple of 32 up to 256; b * heads * ceil(n / 64) < 2^31;
// every pointer 16-byte aligned and the row strides multiples of 8 (the
// TMA's rules for a global address and stride): checked by the wrapper.

// dq [B, N, H, D] bf16 and delta [B, H, N] float32 from q, k, v, o, do and lse.
PCB_API int pcb_flash_attn_bwd_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const float* lse,
                                       void* dq, float* delta, int b, int n,
                                       int heads, int d, long long ldq,
                                       long long ldk, long long ldv, int device,
                                       void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  const bf16* oh = static_cast<const bf16*>(o);
  const bf16* gh = static_cast<const bf16*>(dout);
  bf16* dqh = static_cast<bf16*>(dq);
#define PCB_DQ(DD) \
  launch_dq<DD>(qh, kh, vh, oh, gh, lse, dqh, delta, b, n, heads, ldq, ldk, ldv, device, st)
  PCB_FOR_HEAD_DIMS(PCB_DQ)
#undef PCB_DQ
  return (int)err;
}

// dk, dv [B, N, H, D] bf16 from q, k, v, do, lse and the delta that
// pcb_flash_attn_bwd_dq_bf16 wrote.
PCB_API int pcb_flash_attn_bwd_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv, int b, int n,
                                        int heads, int d, long long ldq,
                                        long long ldk, long long ldv, int device,
                                        void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  const bf16* gh = static_cast<const bf16*>(dout);
  bf16* dkh = static_cast<bf16*>(dk);
  bf16* dvh = static_cast<bf16*>(dv);
#define PCB_DKV(DD) \
  launch_dkv<DD>(qh, kh, vh, gh, lse, delta, dkh, dvh, b, n, heads, ldq, ldk, ldv, device, st)
  PCB_FOR_HEAD_DIMS(PCB_DKV)
#undef PCB_DKV
  return (int)err;
}
