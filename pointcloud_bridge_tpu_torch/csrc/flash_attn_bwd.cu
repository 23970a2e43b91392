// K6b: multi-head attention backward without the score matrix in device
// memory (flash attention, dq and dk/dv).
//
// Replaces: the VJP of the library Pallas kernel that
// pointcloud_bridge_tpu/models/ptv3.py:74 (_attention) calls on the TPU,
// jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd_dkv
// and _flash_attention_bwd_dq, two pallas_calls sized by the block_*_dkv and
// block_*_dq arguments of ptv3.py:154-156, fed by the forward's saved row
// statistics and by di = sum(o * do) computed outside them.
//
// Semantics: for every batch row b and head h, with scale = 1/sqrt(D),
//   P[i, j]  = exp(scale * q_i . k_j - lse_i)      (the forward's softmax)
//   delta_i  = sum_d o[i, d] * do[i, d]
//   dP[i, j] = do_i . v_j
//   dS       = P * (dP - delta_i)
//   dv_j = sum_i P[i, j] do_i
//   dq_i = scale * sum_j dS[i, j] k_j
//   dk_j = scale * sum_i dS[i, j] q_i
// float32 in, float32 sums, float32 out. q, k, v are [B, N, H, D] with a row
// stride each (ldq, ldk, ldv, in elements), read in place from the packed
// qkv projection as in the forward; o and do are contiguous [B, N, H, D];
// lse is the forward's [B, H, N] natural-log row statistic; delta is
// [B, H, N]; dq, dk, dv are written contiguous as [B, N, H, D]. P, dP and
// dS exist a tile at a time in registers and shared memory only.
//
// What bounds it on the H100: operations, as the forward. Five N x N x D
// products are the least a backward does (10*B*H*N*N*D operations against
// 36*B*N*H*D bytes); at float32 accuracy the fastest route is the tensor
// cores in 3xTF32 (165 TFLOP/s of float32-grade work), so the arithmetic is
// the floor from N = 180 up.
//
// Design: two kernels and no atomics, so that the result is the same bits
// from run to run. That recomputes S and dP in both, seven tile products for
// five. One pass over key tiles that also hands out dq would need a partial
// dq a key tile (N/64 times dq's size: 1.6 GB at [4, 4096, 2, 192]) or float
// atomics; the split keeps the sums in registers and their order fixed.
// Both kernels follow the forward (flash_attn.cu, flash_attn.cuh): a warp
// owns 16 rows, the streamed tiles arrive in a ring of buffers filled by
// cp.async under the arithmetic of the step before, one __syncthreads() a
// step, and every product runs on the tensor cores in 3xTF32, the second
// product of a step straight from the accumulator registers of the first.
//  - pcb_flash_attn_bwd_dq: a block owns a (batch, head) and 64 query rows,
//    keeps their q and do tiles in shared memory, and loops over the key
//    tiles (k and v in the ring). Its prologue computes delta for its rows
//    (o against do, both from device memory, a warp a row) and writes it for
//    the dk/dv kernel, which therefore runs after it on the same stream. A
//    step: S = q . k^T and dP = do . v^T as accumulator fragments,
//    dS = P * (dP - delta) in place, dq += dS . k.
//  - pcb_flash_attn_bwd_dkv: a block owns a (batch, head) and 64 keys, keeps
//    their k and v tiles in shared memory, and loops over the query tiles (q
//    and do in the ring, with their lse and delta). It computes the
//    transposed tiles S^T = k . q^T and dP^T = v . do^T, so that a warp's 16
//    rows are keys in the products and in the sums alike; then
//    dv += P^T . do and dk += dS^T . q. No softmax reduction is needed: lse
//    is known.
// Registers and shared memory limit the tiles. A warp's sums are 16 rows by
// D channels, D/2 registers a thread and output, and dk/dv holds two of
// them: from D = 96 up, two warps share 16 rows and split the channels
// (CS = 2; a block is then 8 warps). Each computes the half of S and dP that
// its channels contribute; the helper hands its halves to the pair's leader
// through shared memory, the leader adds them, makes dS (dk/dv: P^T and
// dS^T) and hands that back (flash_attn.cuh, pair_write and pair_read: two
// named barriers of 64 threads a step, one buffer a pair), and each goes on
// with its own half of the output channels: no product and no exponential
// is done twice, and D = 192 costs 96 sum registers a thread in dk/dv and 48
// in dq. The streamed side is 64 rows a step at D <= 64 (two or three blocks
// an SM), 32 rows to D = 192 and 16 beyond, three buffers where they fit.
//
// Ragged N: staged rows past N are zeros. In dq, keys past N get P = 0 and
// rows past N are not stored. In dk/dv, query rows past N get lse = +inf,
// hence P = exp2(-inf) = 0, and key rows past N are not stored. A warp whose
// 16 rows all lie past N copies and waits with the others and computes
// nothing.
//
// The library is built with -fmad=false; a fused operation here is written
// as fmaf().
#include <cmath>

#include "flash_attn.cuh"

namespace {

using flash::kPad;

constexpr int kBM = 64;  // rows a block owns (queries in dq, keys in dk/dv)

// warps that share 16 rows and split the channels; rows of the streamed
// side a step; buffers in the ring
constexpr int bwd_split(int d) { return d <= 64 ? 1 : 2; }
constexpr int bwd_step(int d) { return d <= 64 ? 64 : d <= 192 ? 32 : 16; }

// resident tiles (two of kBM rows), the ring, the pairs' exchange buffers
// and (dk/dv) the ring of row statistics
constexpr size_t bwd_smem_bytes(int d, int stages, bool stats) {
  const int bn = bwd_step(d);
  size_t floats = (size_t)(2 * kBM + 2 * stages * bn) * (d + kPad);
  if (bwd_split(d) == 2) floats += (size_t)(kBM / 16) * 2 * (bn / 8) * 128;
  if (stats) floats += (size_t)2 * stages * bn;
  return floats * sizeof(float);
}
constexpr int bwd_stages(int d) {
  if (d <= 64) return d == 32 ? 3 : 2;  // two blocks an SM at least
  return bwd_smem_bytes(d, 3, true) <= flash::kMaxShared ? 3 : 2;
}

// acc[0] = a0 . b0^T and acc[1] = a1 . b1^T (flash::dot_rows): side by side
// where a step has fewer than 8 score fragments, one after the other where
// it has 8 and twice as many would not fit the registers.
template <int LD, int NT, int KSTEPS>
__device__ __forceinline__ void dot_pair(const float* a0, const float* b0,
                                         const float* a1, const float* b1,
                                         int g, int t, float (&acc)[2][NT][4]) {
  if constexpr (NT < 8) {
    flash::dot_rows<LD, NT, KSTEPS, 2>({a0, a1}, {b0, b1}, g, t, acc);
  } else {
    flash::dot_rows<LD, NT, KSTEPS, 1>(
        {a0}, {b0}, g, t, *reinterpret_cast<float(*)[1][NT][4]>(&acc[0]));
    flash::dot_rows<LD, NT, KSTEPS, 1>(
        {a1}, {b1}, g, t, *reinterpret_cast<float(*)[1][NT][4]>(&acc[1]));
  }
}

template <int D, int BN, int STAGES, int CS>
__global__ void __launch_bounds__(2 * kBM * CS)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int n, int heads, int tiles, long long ldq,
                         long long ldk, long long ldv, float scale) {
  constexpr int LD = D + kPad;
  constexpr int THREADS = 2 * kBM * CS;
  constexpr int WARPS = THREADS / 32;
  constexpr int NT = BN / 8;        // score fragments a warp and step
  constexpr int DH = D / CS;        // channels a warp
  constexpr int NCH = DH / 8;       // output fragments a warp
  constexpr int TILE = BN * LD;
  constexpr int XCH = 2 * NT * 128;  // floats of a pair's exchange buffer
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kBM * LD;
  float* ring = sdo + kBM * LD;          // STAGES x (k tile, v tile)
  float* sx = ring + 2 * STAGES * TILE;  // a pair an exchange buffer (CS == 2)

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp % (kBM / 16)) * 16;  // the warp's first row in the tile
  const int c0 = (warp / (kBM / 16)) * DH;  // and its first channel
  const bool active = i0 + r0 < n;
  const long long ldo = (long long)heads * D;

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const float* ob = o + (size_t)b * n * ldo + (size_t)h * D;
  const float* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;
  const int steps = (n + BN - 1) / BN;

  // the q and do tiles travel with the first k and v tiles
  flash::stage_tile_async<D, kBM, THREADS>(sq, qb, i0, n, ldq);
  flash::stage_tile_async<D, kBM, THREADS>(sdo, dob, i0, n, ldo);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      flash::stage_tile_async<D, BN, THREADS>(ring + 2 * s * TILE, kb, s * BN, n, ldk);
      flash::stage_tile_async<D, BN, THREADS>(ring + (2 * s + 1) * TILE, vb, s * BN, n, ldv);
    }
    flash::cp_async_commit();
  }

  // delta of the block's rows, a warp a row, while the copies fly; each
  // thread then keeps the statistics of its two rows in registers
  __shared__ float sdelta[kBM];
  for (int r = warp; r < kBM; r += WARPS) {
    const int row = i0 + r;
    float part = 0.f;
    if (row < n) {
      for (int c = 4 * lane; c < D; c += 128) {
        const float4 ov = *reinterpret_cast<const float4*>(ob + (size_t)row * ldo + c);
        const float4 gv = *reinterpret_cast<const float4*>(dob + (size_t)row * ldo + c);
        part = fmaf(ov.x, gv.x, part);
        part = fmaf(ov.y, gv.y, part);
        part = fmaf(ov.z, gv.z, part);
        part = fmaf(ov.w, gv.w, part);
      }
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, w);
    }
    if (lane == 0) {
      sdelta[r] = part;
      if (row < n) delta[stat0 + row] = part;
    }
  }
  __syncthreads();

  // delta and the base-2 lse of rows g and g + 8 of the warp's 16
  float dl[2], ls[2], acc[NCH][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + g + 8 * r;
    dl[r] = sdelta[r0 + g + 8 * r];
    ls[r] = row < n ? lse[stat0 + row] * flash::kLog2e : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  }
  const float scale_log2e = scale * flash::kLog2e;

  for (int step = 0; step < steps; ++step) {
    // this step's tiles have landed, and every warp is done with the
    // buffer of the step before, which the next copy overwrites
    flash::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = step + STAGES - 1;
    if (ahead < steps) {
      float* dst = ring + 2 * (ahead % STAGES) * TILE;
      flash::stage_tile_async<D, BN, THREADS>(dst, kb, ahead * BN, n, ldk);
      flash::stage_tile_async<D, BN, THREADS>(dst + TILE, vb, ahead * BN, n, ldv);
    }
    flash::cp_async_commit();
    if (!active) continue;

    const float* sk = ring + 2 * (step % STAGES) * TILE;
    const float* sv = sk + TILE;
    const int j0 = step * BN;

    // rows g, g + 8 against keys j0 + 8 j + 2 t, + 1, over the warp's
    // channels: S = q . k^T, dP = do . v^T
    float sd[2][NT][4];
    dot_pair<LD, NT, DH / 8>(sq + r0 * LD + c0, sk + c0, sdo + r0 * LD + c0,
                             sv + c0, g, t, sd);
    float (&s)[NT][4] = sd[0];
    float (&dp)[NT][4] = sd[1];
    // the pair's leader (channels from 0) sums the halves and makes dS
    const int pair = warp % (kBM / 16);
    const bool leader = CS == 1 || c0 == 0;
    float* buf = sx + pair * XCH;
    if (CS == 2) {
      if (!leader) flash::pair_write<2, NT>(sd, buf, lane);
      flash::pair_barrier(1 + pair);
      if (leader) flash::pair_read<2, true, NT>(sd, buf, lane);
    }
    if (leader) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = j0 + 8 * j + 2 * t + (e & 1) < n;
          const float p =
              valid ? exp2f(fmaf(s[j][e], scale_log2e, -ls[e >> 1])) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
    }
    if (CS == 2) {
      if (leader) flash::pair_write<1, NT>(sd, buf, lane);
      flash::pair_barrier(1 + pair);
      if (!leader) flash::pair_read<1, false, NT>(sd, buf, lane);
    }

    // acc += dS . k over the warp's channels, from the registers
    flash::weighted_rows<LD, NT, NCH>(s, sk + c0, g, t, acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + g + 8 * r;
    if (row >= n) continue;
    float* dst = dq + (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D +
                 c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float2 out;
      out.x = acc[c][2 * r] * scale;
      out.y = acc[c][2 * r + 1] * scale;
      *reinterpret_cast<float2*>(dst + 8 * c) = out;
    }
  }
}

template <int D, int BQ, int STAGES, int CS>
__global__ void __launch_bounds__(2 * kBM * CS)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int n, int heads, int tiles, long long ldq,
                          long long ldk, long long ldv, float scale) {
  constexpr int LD = D + kPad;
  constexpr int THREADS = 2 * kBM * CS;
  constexpr int NT = BQ / 8;        // score fragments a warp and step
  constexpr int DH = D / CS;        // channels a warp
  constexpr int NCH = DH / 8;       // output fragments a warp and output
  constexpr int TILE = BQ * LD;
  constexpr int XCH = 2 * NT * 128;  // floats of a pair's exchange buffer
  static_assert(2 * BQ <= THREADS, "a thread a row statistic");
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kBM * LD;
  float* ring = sv + kBM * LD;             // STAGES x (q tile, do tile)
  float* sstat = ring + 2 * STAGES * TILE;  // STAGES x (base-2 lse, delta)
  float* sx = sstat + 2 * STAGES * BQ;      // a pair an exchange buffer (CS == 2)

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j0 = tile * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp % (kBM / 16)) * 16;  // the warp's first key in the tile
  const int c0 = (warp / (kBM / 16)) * DH;  // and its first channel
  const bool active = j0 + r0 < n;
  const long long ldo = (long long)heads * D;

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const float* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;
  const int steps = (n + BQ - 1) / BQ;

  // Ask for the q and do tiles of a step and store its row statistics: the
  // base-2 lse (+inf for a row past N, so that P = exp2(-inf) = 0) by the
  // first BQ threads, delta by the next BQ. A plain store: it is read a
  // __syncthreads() later at the earliest.
  auto stage = [&](int step) {
    float* dst = ring + 2 * (step % STAGES) * TILE;
    flash::stage_tile_async<D, BQ, THREADS>(dst, qb, step * BQ, n, ldq);
    flash::stage_tile_async<D, BQ, THREADS>(dst + TILE, dob, step * BQ, n, ldo);
    float* st = sstat + 2 * (step % STAGES) * BQ;
    if (threadIdx.x < BQ) {
      const int row = step * BQ + threadIdx.x;
      st[threadIdx.x] = row < n ? lse[stat0 + row] * flash::kLog2e : INFINITY;
    } else if (threadIdx.x < 2 * BQ) {
      const int row = step * BQ + threadIdx.x - BQ;
      st[threadIdx.x] = row < n ? delta[stat0 + row] : 0.f;
    }
  };

  // the k and v tiles travel with the first q and do tiles
  flash::stage_tile_async<D, kBM, THREADS>(sk, kb, j0, n, ldk);
  flash::stage_tile_async<D, kBM, THREADS>(sv, vb, j0, n, ldv);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s);
    flash::cp_async_commit();
  }

  float acck[NCH][4], accv[NCH][4];  // keys g and g + 8 of the warp's 16
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acck[c][e] = 0.f;
      accv[c][e] = 0.f;
    }
  }
  const float scale_log2e = scale * flash::kLog2e;

  for (int step = 0; step < steps; ++step) {
    // this step's tiles have landed, and every warp is done with the
    // buffer of the step before, which the next copy overwrites
    flash::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < steps) stage(step + STAGES - 1);
    flash::cp_async_commit();
    if (!active) continue;

    const float* sq = ring + 2 * (step % STAGES) * TILE;
    const float* sdo = sq + TILE;
    const float* sl = sstat + 2 * (step % STAGES) * BQ;
    const float* sdl = sl + BQ;

    // keys g, g + 8 against queries 8 j + 2 t, + 1 of the step, over the
    // warp's channels: S^T = k . q^T, dP^T = v . do^T
    float sd[2][NT][4];
    dot_pair<LD, NT, DH / 8>(sk + r0 * LD + c0, sq + c0, sv + r0 * LD + c0,
                             sdo + c0, g, t, sd);
    float (&st)[NT][4] = sd[0];
    float (&dpt)[NT][4] = sd[1];
    // the pair's leader (channels from 0) sums the halves and makes P^T, dS^T
    const int pair = warp % (kBM / 16);
    const bool leader = CS == 1 || c0 == 0;
    float* buf = sx + pair * XCH;
    if (CS == 2) {
      if (!leader) flash::pair_write<2, NT>(sd, buf, lane);
      flash::pair_barrier(1 + pair);
      if (leader) flash::pair_read<2, true, NT>(sd, buf, lane);
    }
    if (leader) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
        const float2 dlq = *reinterpret_cast<const float2*>(sdl + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(st[j][e], scale_log2e, e & 1 ? -lq.y : -lq.x));
          st[j][e] = p;                                         // P^T
          dpt[j][e] = p * (dpt[j][e] - (e & 1 ? dlq.y : dlq.x));  // dS^T
        }
      }
    }
    if (CS == 2) {
      if (leader) flash::pair_write<2, NT>(sd, buf, lane);
      flash::pair_barrier(1 + pair);
      if (!leader) flash::pair_read<2, false, NT>(sd, buf, lane);
    }

    // dv += P^T . do and dk += dS^T . q over the warp's channels
    flash::weighted_rows<LD, NT, NCH>(st, sdo + c0, g, t, accv);
    flash::weighted_rows<LD, NT, NCH>(dpt, sq + c0, g, t, acck);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + r0 + g + 8 * r;
    if (row >= n) continue;
    const size_t off = (size_t)b * n * ldo + (size_t)row * ldo +
                       (size_t)h * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float2 gk, gv;
      gk.x = acck[c][2 * r] * scale;
      gk.y = acck[c][2 * r + 1] * scale;
      gv.x = accv[c][2 * r];
      gv.y = accv[c][2 * r + 1];
      *reinterpret_cast<float2*>(dk + off + 8 * c) = gk;
      *reinterpret_cast<float2*>(dv + off + 8 * c) = gv;
    }
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, const float* lse,
                      float* dq, float* delta, int b, int n, int heads,
                      long long ldq, long long ldk, long long ldv, int device,
                      cudaStream_t st) {
  constexpr int BN = bwd_step(D), STAGES = bwd_stages(D), CS = bwd_split(D);
  constexpr size_t bytes = bwd_smem_bytes(D, STAGES, false);
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bwd_dq_kernel<D, BN, STAGES, CS>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), 2 * kBM * CS, bytes, st>>>(
      q, k, v, o, dout, lse, dq, delta, n, heads, tiles, ldq, ldk, ldv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int b, int n, int heads,
                       long long ldq, long long ldk, long long ldv, int device,
                       cudaStream_t st) {
  constexpr int BQ = bwd_step(D), STAGES = bwd_stages(D), CS = bwd_split(D);
  constexpr size_t bytes = bwd_smem_bytes(D, STAGES, true);
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bwd_dkv_kernel<D, BQ, STAGES, CS>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), 2 * kBM * CS, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, n, heads, tiles, ldq, ldk, ldv, scale);
  return cudaGetLastError();
}

}  // namespace
// For both: d a multiple of 32 up to 256; b * heads * ceil(n / 64) < 2^31;
// every pointer 16-byte aligned and the row strides multiples of 4: checked
// by the wrapper.

// dq [B, N, H, D] and delta [B, H, N] from q, k, v, o, do and lse.
PCB_API int pcb_flash_attn_bwd_dq(const float* q, const float* k,
                                  const float* v, const float* o,
                                  const float* dout, const float* lse,
                                  float* dq, float* delta, int b, int n,
                                  int heads, int d, long long ldq,
                                  long long ldk, long long ldv, int device,
                                  void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_DQ(DD) \
  launch_dq<DD>(q, k, v, o, dout, lse, dq, delta, b, n, heads, ldq, ldk, ldv, \
                device, st)
  PCB_FOR_HEAD_DIMS(PCB_DQ)
#undef PCB_DQ
  return (int)err;
}

// dk, dv [B, N, H, D] from q, k, v, do, lse and the delta that
// pcb_flash_attn_bwd_dq wrote.
PCB_API int pcb_flash_attn_bwd_dkv(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, int b, int n,
                                   int heads, int d, long long ldq,
                                   long long ldk, long long ldv, int device,
                                   void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_DKV(DD) \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, b, n, heads, ldq, ldk, ldv, \
                 device, st)
  PCB_FOR_HEAD_DIMS(PCB_DKV)
#undef PCB_DKV
  return (int)err;
}
