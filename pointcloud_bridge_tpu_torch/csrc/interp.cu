// K4: exact k-NN inverse-distance interpolation, forward.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/interp3.py,
// _interp_kernel with _blend_tile (called by _interp_call; entry
// interpolate_pallas). The backward (_interp_bwd_kernel) is interp_bwd.cu.
//
// Semantics (pointnet2_utils.py:171-211): for each destination point, the k
// nearest sources by squared distance, picked as an iterative first-min
// (equal distances go to the lower index); weights w = 1 / (d2 + 1e-8),
// summed in selection order and normalised; the output is the weighted sum
// of the k source feature rows, added in selection order.
//
// What bounds it on the H100: the bytes of the output (and of the k gathered
// rows, which stay in L2) and, at S = 1024, the compare-and-scan work of the
// selection (B*N*S distances). Both are small next to what one SM a few
// queries can do, so the kernel is about spreading the work over the card.
//
// Design:
// - A group of G lanes selects for one destination point (G = 4, 8, 16 or 32:
//   the fewest that put 2^17 lanes to work over the B * N queries;
//   ops/interpolate.py::interp_lanes). The block stages the sources
//   in shared memory, 1024 at a time, as (x, y, z, 0) float4s, one 16-byte
//   load a source. Lane l of the group scans sources l, l + G, ... in index
//   order and keeps its best (distance, index) pairs sorted in registers: a
//   source enters only if it is ahead of the last kept pair, with a strict
//   comparison, so the lower index stays ahead on equal distances.
// - Every 8 sources a lane, the group shares a bound: the least, over its
//   lanes, of each lane's k-th kept distance. k sources are at most that
//   far, so a source farther away cannot be among the k nearest and is not
//   inserted. The bound matters for the divergence of the warp: a lane that
//   sees S / G sources against its own list alone would insert nearly at
//   every step of the scan, and the warp pays the insertion whenever any of
//   its 32 lanes does. For the same reason a lane first measures its 8
//   sources and marks those within the bound; at 4 and 8 lanes a query it
//   then inserts the marked ones in rounds, so that the warp pays as many
//   rounds as its busiest lane has candidates, not one for each source that
//   any of its lanes keeps.
// - Then log2 G rounds of __shfl_xor_sync merge pairs of sorted lists (the
//   elementwise min of one list and the other reversed holds the smallest of
//   both, and a bitonic pass sorts it). The (distance, index) order is
//   total, so the merged list is the iterative first-min of _blend_tile,
//   ties included, and every lane of the group holds it. k = 3 keeps 4
//   pairs a lane, so that the lists merge as powers of two. Every lane then
//   computes the weights in the reference's order (__fdiv_rn, __fadd_rn).
// - The blend is a warp's, row after row of its 32 / G queries: the lanes
//   take the channels of the block's chunk, 16 bytes at a time where D % 4 ==
//   0 and both feature and output pointers are 16-byte aligned (a contiguous
//   view at a storage offset need not be), else 4 bytes. Each channel is
//   summed in selection order with __fmul_rn/__fadd_rn, as before; there is
//   no division for each element.
// - The grid is (query tiles) x (channel chunks) x B. Where the query tiles
//   alone would leave the card short of two blocks an SM, the channels are
//   cut into chunks of whole warp widths and each chunk's block selects
//   again (cheap at S <= 512, where that happens at the models' shapes).
// The selected indices and normalised weights are also written ([B, N, k]
// int32 and float32) when a backward will follow, so that the backward is
// one scatter pass instead of a second neighbour search. Indices, weights and
// output are bit-identical to the kernel of one thread a query that this
// design replaced, and the blend is that of interpolate_plain.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kTile = 1024;    // sources staged at a time
constexpr int kScan = 8;       // sources a lane scans between two updates of the bound

__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

template <int KP>
__device__ __forceinline__ void order(float (&d)[KP], int (&i)[KP], int a, int b) {
  if (ahead(d[b], i[b], d[a], i[a])) {
    const float td = d[a];
    const int ti = i[a];
    d[a] = d[b];
    i[a] = i[b];
    d[b] = td;
    i[b] = ti;
  }
}

// (v, vi) into the ascending list; the pair pushed out of the last slot drops
template <int KP>
__device__ __forceinline__ void insert(float (&bd)[KP], int (&bi)[KP], float v, int vi) {
  if (!ahead(v, vi, bd[KP - 1], bi[KP - 1])) return;
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    if (ahead(v, vi, bd[p], bi[p])) {
      const float tv = bd[p];
      const int ti = bi[p];
      bd[p] = v;
      bi[p] = vi;
      v = tv;
      vi = ti;
    }
  }
}

// Merge the lists of the G lanes of each group: afterwards every lane holds
// the group's KP best pairs, ascending. All 32 lanes take part.
template <int G, int KP>
__device__ __forceinline__ void group_merge(float (&bd)[KP], int (&bi)[KP]) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    float od[KP];
    int oi[KP];
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      od[t] = __shfl_xor_sync(0xffffffffu, bd[t], off);
      oi[t] = __shfl_xor_sync(0xffffffffu, bi[t], off);
    }
    // min(mine[t], theirs[KP-1-t]): the KP smallest of both, a bitonic run
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      if (ahead(od[KP - 1 - t], oi[KP - 1 - t], bd[t], bi[t])) {
        bd[t] = od[KP - 1 - t];
        bi[t] = oi[KP - 1 - t];
      }
    }
#pragma unroll
    for (int h = KP / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int t = 0; t < KP; ++t) {
        if (!(t & h)) order<KP>(bd, bi, t, t + h);
      }
    }
  }
}

// The k nearest sources of each group's query and their normalised weights,
// in every lane of the group. The whole block calls it (it stages), and
// every lane runs the same iterations (the bound below is shuffled).
template <int K, int G>
__device__ __forceinline__ void select_k(const float* __restrict__ ps, int s, float qx,
                                         float qy, float qz, int (&idx)[K], float (&w)[K]) {
  constexpr int KP = K == 3 ? 4 : K;
  // rounds of deferred insertion pay at 4 and 8 lanes a query, where a lane
  // scans long enough for many of its steps to keep nothing; at 16 and 32
  // the rounds cost more than they save (PERF.md)
  constexpr bool kDefer = G <= 8;
  __shared__ float4 src[kTile];  // x, y, z of the staged sources
  const int l = threadIdx.x % G;
  float bd[KP];
  int bi[KP];
#pragma unroll
  for (int t = 0; t < KP; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bi[t] = INT_MAX;
  }
  // The group's bound: the least, over its lanes, of each lane's k-th kept
  // distance. k sources are at most that far, so a source farther away is
  // not among the k nearest, and no lane needs it.
  float td = __int_as_float(0x7f800000);
  for (int base = 0; base < s; base += kTile) {
    const int lim = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < lim; t += kThreads) {
      const float* pt = ps + (size_t)(base + t) * 3;
      src[t] = make_float4(pt[0], pt[1], pt[2], 0.f);
    }
    __syncthreads();
    for (int t0 = 0; t0 < lim; t0 += kScan * G) {
      // the window's distances, and a bit for each within the bound
      float v[kScan];
      unsigned pending = 0;
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int t = min(t0 + u * G + l, lim - 1);
        const float4 c = src[t];
        v[u] = sq_dist3(qx, qy, qz, c.x, c.y, c.z);
        if (t0 + u * G + l < lim && v[u] <= td) pending |= 1u << u;
      }
      if (kDefer) {
        // lowest bit first: the warp runs as many rounds as its busiest lane
        // has candidates, not one for each step where any lane has one
        // (insert() orders equal distances, so the order is free)
        while (__any_sync(0xffffffffu, pending)) {
          if (pending) {
            const int u = __ffs(pending) - 1;
            pending &= pending - 1;
            float vu = v[0];
#pragma unroll
            for (int q = 1; q < kScan; ++q) vu = u == q ? v[q] : vu;
            insert<KP>(bd, bi, vu, base + t0 + u * G + l);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kScan; ++u)
          if (pending >> u & 1) insert<KP>(bd, bi, v[u], base + t0 + u * G + l);
      }
      td = bd[K - 1];
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        td = fminf(td, __shfl_xor_sync(0xffffffffu, td, off));
    }
  }
  group_merge<G, KP>(bd, bi);
  float wsum = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    w[t] = __fdiv_rn(1.f, __fadd_rn(bd[t], 1e-8f));
    wsum = __fadd_rn(wsum, w[t]);
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    w[t] = __fdiv_rn(w[t], wsum);
    // only a NaN coordinate leaves a slot unfilled; keep the read in bounds
    idx[t] = bi[t] == INT_MAX ? 0 : bi[t];
  }
}

__device__ __forceinline__ float4 scale4(float w, float4 f) {
  return make_float4(__fmul_rn(w, f.x), __fmul_rn(w, f.y), __fmul_rn(w, f.z),
                     __fmul_rn(w, f.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One output row's channels [c0, c1) by the 32 lanes of a warp: the k rows
// of fb weighted and added in selection order.
template <int K, bool kVec>
__device__ __forceinline__ void blend_row(const float* __restrict__ fb, float* __restrict__ o,
                                          const int (&idx)[K], const float (&w)[K], int d,
                                          int c0, int c1, int lane) {
  if (kVec) {
    for (int c = c0 + 4 * lane; c < c1; c += 128) {
      float4 acc = scale4(w[0], __ldg(reinterpret_cast<const float4*>(fb + (size_t)idx[0] * d + c)));
#pragma unroll
      for (int t = 1; t < K; ++t)
        acc = add4(acc, scale4(w[t], __ldg(reinterpret_cast<const float4*>(
                                         fb + (size_t)idx[t] * d + c))));
      *reinterpret_cast<float4*>(o + c) = acc;
    }
  } else {
    for (int c = c0 + lane; c < c1; c += 32) {
      float acc = __fmul_rn(w[0], __ldg(fb + (size_t)idx[0] * d + c));
#pragma unroll
      for (int t = 1; t < K; ++t)
        acc = __fadd_rn(acc, __fmul_rn(w[t], __ldg(fb + (size_t)idx[t] * d + c)));
      o[c] = acc;
    }
  }
}

// Select and blend. Block (x, y, z) = (query tile, channel
// chunk, batch element).
template <int K, int G, bool kVec>
__global__ void __launch_bounds__(kThreads)
    interp_kernel(const float* __restrict__ dst, const float* __restrict__ src,
                  const float* __restrict__ feats, float* __restrict__ out,
                  int* __restrict__ idx_out, float* __restrict__ w_out, int n, int s, int d,
                  int cw) {
  constexpr int kWarpQueries = 32 / G;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int l = threadIdx.x % G;
  const int qw = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kWarpQueries;
  const int q = qw + lane / G;
  const bool active = q < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* c = dst + ((size_t)b * n + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }
  int idx[K];
  float w[K];
  select_k<K, G>(src + (size_t)b * s * 3, s, qx, qy, qz, idx, w);
  if (idx_out != nullptr && blockIdx.y == 0 && l == 0 && active) {
    const size_t row = ((size_t)b * n + q) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      idx_out[row + t] = idx[t];
      w_out[row + t] = w[t];
    }
  }

  const int c0 = blockIdx.y * cw;
  const int c1 = min(d, c0 + cw);
  const float* fb = feats + (size_t)b * s * d;
#pragma unroll
  for (int r = 0; r < kWarpQueries; ++r) {
    if (qw + r >= n) break;  // the same for the whole warp
    int ri[K];
    float rw[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      ri[t] = __shfl_sync(0xffffffffu, idx[t], r * G);
      rw[t] = __shfl_sync(0xffffffffu, w[t], r * G);
    }
    blend_row<K, kVec>(fb, out + ((size_t)b * n + qw + r) * d, ri, rw, d, c0, c1, lane);
  }
}

template <int K, int G, bool kVec>
void launch(const float* dst, const float* src, const float* feats, float* out, int* idx_out,
            float* w_out, int b, int n, int s, int d, int cw, cudaStream_t st) {
  const int chunks = max(1, (d + cw - 1) / cw);  // D = 0 blends nothing
  const int tiles = (n + kThreads / G - 1) / (kThreads / G);
  interp_kernel<K, G, kVec><<<dim3(tiles, chunks, b), kThreads, 0, st>>>(
      dst, src, feats, out, idx_out, w_out, n, s, d, cw);
}

template <int K>
cudaError_t launch_k(const float* dst, const float* src, const float* feats, float* out,
                     int* idx_out, float* w_out, int b, int n, int s, int d, int lanes,
                     int cw, bool vec, cudaStream_t st) {
#define PCB_INTERP(G)                                                                     \
  case G:                                                                                 \
    if (vec)                                                                              \
      launch<K, G, true>(dst, src, feats, out, idx_out, w_out, b, n, s, d, cw, st);         \
    else                                                                                  \
      launch<K, G, false>(dst, src, feats, out, idx_out, w_out, b, n, s, d, cw, st);        \
    break
  switch (lanes) {
    PCB_INTERP(4);
    PCB_INTERP(8);
    PCB_INTERP(16);
    PCB_INTERP(32);
    default:
      return cudaErrorInvalidValue;
  }
#undef PCB_INTERP
  return cudaGetLastError();
}

}  // namespace

// plan (ops/interpolate.py INTERP_PLAN): B, N, S, D, k, lanes a query (4, 8,
// 16 or 32), channels a chunk (a multiple of 4 where vec), vec (16-byte
// accesses). The wrapper keeps 1 <= k <= min(4, S), B <= 65535 and at most
// 65535 chunks. idx_out and w_out are both null (no backward to follow) or
// both [B, N, k].
PCB_API int pcb_interpolate(const float* dst, const float* src, const float* feats,
                            float* out, int* idx_out, float* w_out, const int* plan,
                            int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int d = plan[3];
  const int k = plan[4];
  const int lanes = plan[5];
  const int chunk = plan[6];
  const int vec = plan[7];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch_k<1>(dst, src, feats, out, idx_out, w_out, b, n, s, d, lanes, chunk, vec, st);
    case 2: return (int)launch_k<2>(dst, src, feats, out, idx_out, w_out, b, n, s, d, lanes, chunk, vec, st);
    case 3: return (int)launch_k<3>(dst, src, feats, out, idx_out, w_out, b, n, s, d, lanes, chunk, vec, st);
    case 4: return (int)launch_k<4>(dst, src, feats, out, idx_out, w_out, b, n, s, d, lanes, chunk, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
