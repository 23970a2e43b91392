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
// 36*B*N*H*D bytes), so the arithmetic is the floor from N = 72 up.
//
// Design: two kernels and no atomics, so that the result is the same from
// run to run. That recomputes S and dP in both, seven tile products for
// five, and buys deterministic sums and no zeroing pass.
//  - pcb_flash_attn_bwd_dq: a block of 16 x 16 threads owns a (batch, head)
//    and 64 query rows, keeps their q and do tiles in shared memory, and
//    loops over the key tiles as the forward does. Its prologue computes
//    delta for its rows (o from device memory against the staged do, joined
//    over the 16 threads of a row by shuffles) and writes it for the dk/dv
//    kernel, which therefore runs after it on the same stream. A step: S and
//    dP as 4 x 4 register tiles, dS to a shared tile, dq += dS . k.
//  - pcb_flash_attn_bwd_dkv: a block owns a (batch, head) and 64 keys, keeps
//    their k and v tiles in shared memory, and loops over the query tiles.
//    It computes the transposed tiles S^T = k . q^T and dP^T = v . do^T, so
//    that a thread's 4 rows are keys in the products and in the sums alike:
//    P^T and dS^T go to two shared tiles, then dv += P^T . do and
//    dk += dS^T . q, D/16 channels a thread and row each. No softmax
//    reduction is needed: lse is known.
// Shared memory is what limits the tiles: four staged tiles of 64 rows and
// the dS tile are 213 KB at D = 192 (of the 227 KB a block may have) and
// over it beyond; the dk/dv kernel's second weight tile brings it over at
// D = 192 already. The streamed side (keys in dq, queries in dk/dv) is
// therefore 32 rows where 64 do not fit: D > 192 in dq, D > 160 in dk/dv.
// Registers: dk/dv holds 2 x 4 x D/16 sums a thread, 96 at D = 192; a block
// of 256 threads may use 255 registers a thread, and one block an SM is all
// the shared memory admits at D >= 96 anyway.
//
// Ragged N: staged rows past N are zeros. In dq, keys past N get P = 0 and
// rows past N are not stored. In dk/dv, query rows past N get lse = +inf,
// hence P = exp2(-inf) = 0, and key rows past N are not stored.
//
// The FMAs are written as fmaf(): the library is built with -fmad=false.
#include <cmath>

#include "flash_attn.cuh"

namespace {

using flash::kPad;
using flash::kThreads;

constexpr int kBM = 64;  // rows a block owns (queries in dq, keys in dk/dv)

// rows of the streamed side a step
constexpr int dq_step(int d) { return d <= 192 ? 64 : 32; }
constexpr int dkv_step(int d) { return d <= 160 ? 64 : 32; }

template <int D, int BN>
constexpr size_t dq_smem_bytes() {
  return (size_t)((2 * kBM + 2 * BN) * (D + kPad) + kBM * (BN + kPad)) *
         sizeof(float);
}

template <int D, int BQ>
constexpr size_t dkv_smem_bytes() {
  return (size_t)((2 * kBM + 2 * BQ) * (D + kPad) + 2 * kBM * (BQ + kPad) +
                  2 * BQ) * sizeof(float);
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int CPT = D / 16;  // output channels a thread and row
  constexpr int NJ = BN / 16;  // keys a thread and step
  constexpr int PS = BN + kPad;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = sq + kBM * LD;
  float* sk = sdo + kBM * LD;
  float* sv = sk + BN * LD;
  float* sds = sv + BN * LD;

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int i0 = tile * kBM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long ldo = (long long)heads * D;

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const float* ob = o + (size_t)b * n * ldo + (size_t)h * D;
  const float* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;

  flash::stage_tile<D, kBM>(sq, qb, i0, n, ldq);
  flash::stage_tile<D, kBM>(sdo, dob, i0, n, ldo);
  __syncthreads();

  // delta and the base-2 lse of rows ty + 16 i; the 16 threads of a row are
  // 16 neighbouring lanes and take the channels 2 tx + 32 mm (+1) each
  float dl[4], ls[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = i0 + r;
    float part = 0.f;
    if (row < n) {
#pragma unroll
      for (int mm = 0; mm < CPT / 2; ++mm) {
        const int c = 2 * tx + 32 * mm;
        const float2 ov = *reinterpret_cast<const float2*>(ob + (size_t)row * ldo + c);
        const float2 gv = *reinterpret_cast<const float2*>(sdo + r * LD + c);
        part = fmaf(ov.x, gv.x, part);
        part = fmaf(ov.y, gv.y, part);
      }
    }
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, w);
    }
    dl[i] = part;
    ls[i] = row < n ? lse[stat0 + row] * flash::kLog2e : 0.f;
    if (row < n && tx == 0) delta[stat0 + row] = part;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  const float scale_log2e = scale * flash::kLog2e;

  for (int j0 = 0; j0 < n; j0 += BN) {
    __syncthreads();  // the previous step's k, v and dS are no longer read
    flash::stage_tile<D, BN>(sk, kb, j0, n, ldk);
    flash::stage_tile<D, BN>(sv, vb, j0, n, ldv);
    __syncthreads();

    // rows ty + 16 i, keys tx + 16 j: S = q . k^T, dP = do . v^T
    float s[4][NJ], dp[4][NJ];
    flash::dot_tile<D, NJ>(sq, ty, sk, tx, s);
    flash::dot_tile<D, NJ>(sdo, ty, sv, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bool valid = j0 + tx + 16 * j < n;
        const float p = valid ? exp2f(fmaf(s[i][j], scale_log2e, -ls[i])) : 0.f;
        sds[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();  // the dS tile is whole

    // rows ty + 16 i of dS . k, channels 2 tx + 32 mm (+1)
    flash::accumulate_tile<D, BN>(sds, PS, ty, sk, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= n) continue;
    float* dst = dq + (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D;
#pragma unroll
    for (int mm = 0; mm < CPT / 2; ++mm) {
      float2 out;
      out.x = acc[i][2 * mm] * scale;
      out.y = acc[i][2 * mm + 1] * scale;
      *reinterpret_cast<float2*>(dst + 2 * tx + 32 * mm) = out;
    }
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int CPT = D / 16;  // output channels a thread and row
  constexpr int NJ = BQ / 16;  // queries a thread and step
  constexpr int PS = BQ + kPad;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = sk + kBM * LD;
  float* sq = sv + kBM * LD;
  float* sdo = sq + BQ * LD;
  float* sp = sdo + BQ * LD;    // P^T  [key][query]
  float* sds = sp + kBM * PS;   // dS^T [key][query]
  float* sl = sds + kBM * PS;   // base-2 lse of the step's queries
  float* sdl = sl + BQ;         // their delta

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int j0 = tile * kBM;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long ldo = (long long)heads * D;

  const float* qb = q + (size_t)b * n * ldq + (size_t)h * D;
  const float* kb = k + (size_t)b * n * ldk + (size_t)h * D;
  const float* vb = v + (size_t)b * n * ldv + (size_t)h * D;
  const float* dob = dout + (size_t)b * n * ldo + (size_t)h * D;
  const size_t stat0 = (size_t)bh * n;

  flash::stage_tile<D, kBM>(sk, kb, j0, n, ldk);
  flash::stage_tile<D, kBM>(sv, vb, j0, n, ldv);

  float acck[4][CPT], accv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acck[i][c] = 0.f;
      accv[i][c] = 0.f;
    }
  }
  const float scale_log2e = scale * flash::kLog2e;

  for (int i0 = 0; i0 < n; i0 += BQ) {
    __syncthreads();  // the previous step's q, do, P^T and dS^T are no longer read
    flash::stage_tile<D, BQ>(sq, qb, i0, n, ldq);
    flash::stage_tile<D, BQ>(sdo, dob, i0, n, ldo);
    if (threadIdx.x < BQ) {
      const int row = i0 + threadIdx.x;
      // a query row past N: P = exp2(-inf) = 0
      sl[threadIdx.x] = row < n ? lse[stat0 + row] * flash::kLog2e : INFINITY;
      sdl[threadIdx.x] = row < n ? delta[stat0 + row] : 0.f;
    }
    __syncthreads();  // and the k and v tiles are there the first time

    // keys ty + 16 i, queries tx + 16 j: S^T = k . q^T, dP^T = v . do^T
    float st[4][NJ], dpt[4][NJ];
    flash::dot_tile<D, NJ>(sk, ty, sq, tx, st);
    flash::dot_tile<D, NJ>(sv, ty, sdo, tx, dpt);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float lq = sl[tx + 16 * j];
      const float dlq = sdl[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(st[i][j], scale_log2e, -lq));
        sp[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sds[(ty + 16 * i) * PS + tx + 16 * j] = p * (dpt[i][j] - dlq);
      }
    }
    __syncthreads();  // both tiles are whole

    // keys ty + 16 i of P^T . do and dS^T . q, channels 2 tx + 32 mm (+1)
    flash::accumulate_tile<D, BQ>(sp, PS, ty, sdo, tx, accv);
    flash::accumulate_tile<D, BQ>(sds, PS, ty, sq, tx, acck);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = j0 + ty + 16 * i;
    if (row >= n) continue;
    const size_t off = (size_t)b * n * ldo + (size_t)row * ldo + (size_t)h * D;
#pragma unroll
    for (int mm = 0; mm < CPT / 2; ++mm) {
      float2 gk, gv;
      gk.x = acck[i][2 * mm] * scale;
      gk.y = acck[i][2 * mm + 1] * scale;
      gv.x = accv[i][2 * mm];
      gv.y = accv[i][2 * mm + 1];
      *reinterpret_cast<float2*>(dk + off + 2 * tx + 32 * mm) = gk;
      *reinterpret_cast<float2*>(dv + off + 2 * tx + 32 * mm) = gv;
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, const float* lse,
                      float* dq, float* delta, int b, int n, int heads,
                      long long ldq, long long ldk, long long ldv,
                      cudaStream_t st) {
  constexpr int BN = dq_step(D);
  constexpr size_t bytes = dq_smem_bytes<D, BN>();
  cudaError_t err = allow_shared(flash_attn_bwd_dq_kernel<D, BN>, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  flash_attn_bwd_dq_kernel<D, BN>
      <<<(unsigned)((size_t)b * heads * tiles), kThreads, bytes, st>>>(
          q, k, v, o, dout, lse, dq, delta, n, heads, tiles, ldq, ldk, ldv,
          scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int b, int n, int heads,
                       long long ldq, long long ldk, long long ldv,
                       cudaStream_t st) {
  constexpr int BQ = dkv_step(D);
  constexpr size_t bytes = dkv_smem_bytes<D, BQ>();
  cudaError_t err = allow_shared(flash_attn_bwd_dkv_kernel<D, BQ>, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const float scale = (float)(1.0 / std::sqrt((double)D));
  flash_attn_bwd_dkv_kernel<D, BQ>
      <<<(unsigned)((size_t)b * heads * tiles), kThreads, bytes, st>>>(
          q, k, v, dout, lse, delta, dk, dv, n, heads, tiles, ldq, ldk, ldv,
          scale);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_DQ(DD) \
  launch_dq<DD>(q, k, v, o, dout, lse, dq, delta, b, n, heads, ldq, ldk, ldv, st)
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_DKV(DD) \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, b, n, heads, ldq, ldk, ldv, st)
  PCB_FOR_HEAD_DIMS(PCB_DKV)
#undef PCB_DKV
  return (int)err;
}
