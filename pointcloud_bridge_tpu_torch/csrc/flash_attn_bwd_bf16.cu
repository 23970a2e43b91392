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
// Design: the float32 kernels' owner design (flash_attn_bwd.cu): two
// kernels and no atomics, so the result is the same bits from run to run;
// each block owns its output rows and loops over the other side, which
// arrives in a ring of two buffers filled by cp.async under the arithmetic
// of the step before; a warp owns 16 rows; every product runs on the tensor
// cores, the second product of a step straight from the float32 fragments
// of the first, rounded to bf16.
//  - pcb_flash_attn_bwd_dq_bf16: a block owns a (batch, head) and 64 query
//    rows, keeps their q and do tiles in shared memory and loops over the
//    key tiles (k and v in the ring). Its prologue computes delta for its
//    rows (o against do, a warp a row) and writes it for the dk/dv kernel,
//    which therefore runs after it on the same stream. A step: S = q . k^T
//    and dP = do . v^T as float32 fragments, dS = P * (dP - delta) in
//    place, dq += bf16(dS) . k.
//  - pcb_flash_attn_bwd_dkv_bf16: a block owns a (batch, head), 64 keys and
//    DH = D / CS of the output channels; it keeps the k and v tiles in
//    shared memory and loops over the query tiles (q and do in the ring,
//    with their lse and delta). It computes the transposed tiles
//    S^T = k . q^T and dP^T = v . do^T over all D channels, then
//    dv += bf16(P^T) . do and dk += bf16(dS^T) . q over its DH channels.
//    Where D > 64 the CS blocks of a key tile each recompute S and dP
//    (CS = 2 to D = 224, 4 at 256), so that a thread holds D/CS sums and no
//    block needs another's scores: the two first products are done CS
//    times, a price paid for sums that fit the registers without the
//    float32 kernels' exchange between warps.
// The streamed side is 64 rows a step at D <= 64 and 32 beyond.
//
// Ragged N: staged rows past N are zeros. In dq, keys past N get P = 0 and
// rows past N are not stored. In dk/dv, query rows past N get lse = +inf,
// hence P = exp2(-inf) = 0, and key rows past N are not stored.
//
// The library is built with -fmad=false; a fused operation here is written
// as fmaf().
#include <cmath>

#include "flash_attn_bf16.cuh"

namespace {

using flash_bf16::bf16;
using flash_bf16::kPad;

constexpr int kBM = 64;        // rows a block owns (queries in dq, keys in dk/dv)
constexpr int kThreads = 128;  // a warp a 16 rows
constexpr int kStages = 2;     // buffers in the ring

constexpr int bwd_step(int d) { return d <= 64 ? 64 : 32; }  // streamed rows a step
constexpr int dkv_split(int d) { return d <= 64 ? 1 : d <= 224 ? 2 : 4; }

// resident tiles (two of kBM rows) and the ring, in bf16; (dk/dv) the ring
// of row statistics in float32
constexpr size_t bwd_smem_bytes(int d, bool stats) {
  const int bn = bwd_step(d);
  return (size_t)(2 * kBM + 2 * kStages * bn) * (d + kPad) * sizeof(bf16) +
         (stats ? (size_t)2 * kStages * bn * sizeof(float) : 0);
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ o,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              bf16* __restrict__ dq, float* __restrict__ delta,
                              int n, int heads, int tiles, long long ldq,
                              long long ldk, long long ldv, float scale) {
  constexpr int LD = D + kPad;
  constexpr int WARPS = kThreads / 32;
  constexpr int NT = BN / 8;   // score fragments a warp and step
  constexpr int NCH = D / 8;   // output fragments a warp
  constexpr int TILE = BN * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kBM * LD;
  bf16* ring = sdo + kBM * LD;  // kStages x (k tile, v tile)

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the tile
  const bool active = i0 + r0 < n;
  const long long ldo = (long long)heads * D;

  const bf16* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const bf16* ob = o + (size_t)b * n * ldo + (size_t)h * D;
  const bf16* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;
  const int steps = (n + BN - 1) / BN;

  // the q and do tiles travel with the first k and v tiles
  flash_bf16::stage_tile_async<D, kBM, kThreads>(sq, qb, i0, n, ldq);
  flash_bf16::stage_tile_async<D, kBM, kThreads>(sdo, dob, i0, n, ldo);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      flash_bf16::stage_tile_async<D, BN, kThreads>(ring + 2 * s * TILE, kb, s * BN, n, ldk);
      flash_bf16::stage_tile_async<D, BN, kThreads>(ring + (2 * s + 1) * TILE, vb, s * BN, n,
                                                    ldv);
    }
    flash::cp_async_commit();
  }

  // delta of the block's rows, a warp a row, 8 channels a lane, while the
  // copies fly; each thread then keeps the statistics of its two rows
  __shared__ float sdelta[kBM];
  for (int r = warp; r < kBM; r += WARPS) {
    const int row = i0 + r;
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
    flash::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = step + kStages - 1;
    if (ahead < steps) {
      bf16* dst = ring + 2 * (ahead % kStages) * TILE;
      flash_bf16::stage_tile_async<D, BN, kThreads>(dst, kb, ahead * BN, n, ldk);
      flash_bf16::stage_tile_async<D, BN, kThreads>(dst + TILE, vb, ahead * BN, n, ldv);
    }
    flash::cp_async_commit();
    if (!active) continue;

    const bf16* sk = ring + 2 * (step % kStages) * TILE;
    const bf16* sv = sk + TILE;
    const int j0 = step * BN;

    // rows g, g + 8 against keys j0 + 8 j + 2 t, + 1: S = q . k^T, dP = do . v^T
    float s[NT][4], dp[NT][4];
    flash_bf16::dot_rows<LD, NT, D>(sq + r0 * LD, sk, g, t, s);
    flash_bf16::dot_rows<LD, NT, D>(sdo + r0 * LD, sv, g, t, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = j0 + 8 * j + 2 * t + (e & 1) < n;
        const float p = valid ? exp2f(fmaf(s[j][e], scale_log2e, -ls[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
      }
    }

    // acc += bf16(dS) . k, from the registers
    flash_bf16::weighted_rows<LD, NT, NCH>(s, sk, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + r0 + g + 8 * r;
    if (row >= n) continue;
    bf16* dst = dq + (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) =
          __floats2bfloat162_rn(acc[c][2 * r] * scale, acc[c][2 * r + 1] * scale);
    }
  }
}

template <int D, int BQ, int CS>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int n, int heads, int tiles, long long ldq,
                               long long ldk, long long ldv, float scale) {
  constexpr int LD = D + kPad;
  constexpr int NT = BQ / 8;    // score fragments a warp and step
  constexpr int DH = D / CS;    // output channels a block
  constexpr int NCH = DH / 8;   // output fragments a warp and output
  constexpr int TILE = BQ * LD;
  static_assert(2 * BQ <= kThreads, "a thread a row statistic");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kBM * LD;
  bf16* ring = sv + kBM * LD;  // kStages x (q tile, do tile)
  float* sstat = reinterpret_cast<float*>(ring + 2 * kStages * TILE);  // (lse, delta)

  const int cs = blockIdx.x % CS;
  const int tile = blockIdx.x / CS % tiles;
  const int bh = blockIdx.x / CS / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j0 = tile * kBM;
  const int c0 = cs * DH;  // the block's first output channel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;  // the warp's first key in the tile
  const bool active = j0 + r0 < n;
  const long long ldo = (long long)heads * D;

  const bf16* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const bf16* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const bf16* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const bf16* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;
  const int steps = (n + BQ - 1) / BQ;

  // Ask for the q and do tiles of a step and store its row statistics: the
  // base-2 lse (+inf for a row past N, so that P = exp2(-inf) = 0) by the
  // first BQ threads, delta by the next BQ. A plain store: it is read a
  // __syncthreads() later at the earliest.
  auto stage = [&](int step) {
    bf16* dst = ring + 2 * (step % kStages) * TILE;
    flash_bf16::stage_tile_async<D, BQ, kThreads>(dst, qb, step * BQ, n, ldq);
    flash_bf16::stage_tile_async<D, BQ, kThreads>(dst + TILE, dob, step * BQ, n, ldo);
    float* st = sstat + 2 * (step % kStages) * BQ;
    if (threadIdx.x < BQ) {
      const int row = step * BQ + threadIdx.x;
      st[threadIdx.x] = row < n ? lse[stat0 + row] * flash::kLog2e : INFINITY;
    } else if (threadIdx.x < 2 * BQ) {
      const int row = step * BQ + threadIdx.x - BQ;
      st[threadIdx.x] = row < n ? delta[stat0 + row] : 0.f;
    }
  };

  // the k and v tiles travel with the first q and do tiles
  flash_bf16::stage_tile_async<D, kBM, kThreads>(sk, kb, j0, n, ldk);
  flash_bf16::stage_tile_async<D, kBM, kThreads>(sv, vb, j0, n, ldv);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
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
    flash::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps) stage(step + kStages - 1);
    flash::cp_async_commit();
    if (!active) continue;

    const bf16* sq = ring + 2 * (step % kStages) * TILE;
    const bf16* sdo = sq + TILE;
    const float* sl = sstat + 2 * (step % kStages) * BQ;
    const float* sdl = sl + BQ;

    // keys g, g + 8 against queries 8 j + 2 t, + 1 of the step:
    // S^T = k . q^T, dP^T = v . do^T
    float st[NT][4], dpt[NT][4];
    flash_bf16::dot_rows<LD, NT, D>(sk + r0 * LD, sq, g, t, st);
    flash_bf16::dot_rows<LD, NT, D>(sv + r0 * LD, sdo, g, t, dpt);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
      const float2 dlq = *reinterpret_cast<const float2*>(sdl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(st[j][e], scale_log2e, e & 1 ? -lq.y : -lq.x));
        st[j][e] = p;                                           // P^T
        dpt[j][e] = p * (dpt[j][e] - (e & 1 ? dlq.y : dlq.x));  // dS^T
      }
    }

    // dv += bf16(P^T) . do and dk += bf16(dS^T) . q over the block's channels
    flash_bf16::weighted_rows<LD, NT, NCH>(st, sdo + c0, lane, accv);
    flash_bf16::weighted_rows<LD, NT, NCH>(dpt, sq + c0, lane, acck);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + r0 + g + 8 * r;
    if (row >= n) continue;
    const size_t off = (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D + c0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c) =
          __floats2bfloat162_rn(acck[c][2 * r] * scale, acck[c][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c) =
          __floats2bfloat162_rn(accv[c][2 * r], accv[c][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* dout, const float* lse, bf16* dq, float* delta,
                      int b, int n, int heads, long long ldq, long long ldk,
                      long long ldv, int device, cudaStream_t st) {
  constexpr int BN = bwd_step(D);
  constexpr size_t bytes = bwd_smem_bytes(D, false);
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  auto kernel = flash_attn_bwd_dq_bf16_kernel<D, BN>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles), kThreads, bytes, st>>>(
      q, k, v, o, dout, lse, dq, delta, n, heads, tiles, ldq, ldk, ldv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const float* lse, const float* delta,
                       bf16* dk, bf16* dv, int b, int n, int heads, long long ldq,
                       long long ldk, long long ldv, int device, cudaStream_t st) {
  constexpr int BQ = bwd_step(D), CS = dkv_split(D);
  constexpr size_t bytes = bwd_smem_bytes(D, true);
  static_assert(bytes <= flash::kMaxShared, "shared memory");
  static_assert((D / CS) % 16 == 0, "pairs of 8-channel tiles a block");
  auto kernel = flash_attn_bwd_dkv_bf16_kernel<D, BQ, CS>;
  static bool allowed[flash::kDevices] = {};
  cudaError_t err = flash::allow_shared(
      kernel, bytes, device < flash::kDevices ? &allowed[device] : nullptr);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  kernel<<<(unsigned)((size_t)b * heads * tiles * CS), kThreads, bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, n, heads, tiles, ldq, ldk, ldv, scale);
  return cudaGetLastError();
}

}  // namespace
// For both: d a multiple of 32 up to 256; b * heads * ceil(n / 64) * 4 <
// 2^31; every pointer 16-byte aligned and the row strides multiples of 8:
// checked by the wrapper.

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
