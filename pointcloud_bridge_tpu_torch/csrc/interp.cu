// K4: exact k-NN inverse-distance interpolation, forward.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/interp3.py,
// _interp_kernel with _blend_tile (called by _interp_call; entry
// interpolate_pallas). The backward (_interp_bwd_kernel) is not ported yet.
//
// Semantics (pointnet2_utils.py:171-211): for each destination point, the k
// nearest sources by squared distance, picked as an iterative first-min
// (equal distances go to the lower index); weights w = 1 / (d2 + 1e-8),
// summed in selection order and normalised; the output is the weighted sum
// of the k source feature rows.
//
// What bounds it on the H100: compare-and-scan work in the selection
// (B*N*S distance evaluations and k-deep insertions) and, for wide D, the
// bytes of the k gathered rows and the output row.
//
// Design: one thread per destination point and 256 points per block. The
// block stages the sources in shared memory, 1024 at a time (12 KB, the
// whole of S on the SSG path), and each thread keeps its k best
// (distance, index) pairs sorted in registers: a source enters only if it
// beats the k-th, so the scan costs one compare per source in the common
// case. Scanning in index order with a strict comparison keeps the lower
// index on ties, which is exactly the iterative first-min. The selected
// indices and normalised weights go to shared memory, and the block then
// blends its 256 rows with the channel as the fastest index, so feature
// loads and output stores coalesce. The one-hot [TQ, S] x [S, D] product of
// the Pallas kernel was a TPU artefact and has no counterpart.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kQueries = 256;  // destination points per block
constexpr int kTile = 1024;    // sources staged per tile

template <int K>
__global__ void interp_kernel(const float* __restrict__ dst,
                              const float* __restrict__ src,
                              const float* __restrict__ feats,
                              float* __restrict__ out, int n, int s, int d) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ int sel_idx[kQueries][K];
  __shared__ float sel_w[kQueries][K];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQueries;
  const int q = q0 + threadIdx.x;
  const bool active = q < n;
  const float* ps = src + (size_t)b * s * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* c = dst + ((size_t)b * n + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }

  // k best so far, ascending by (distance, index)
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bi[t] = INT_MAX;
  }

  for (int base = 0; base < s; base += kTile) {
    const int lim = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < lim; t += blockDim.x) {
      const float* pt = ps + (size_t)(base + t) * 3;
      sx[t] = pt[0];
      sy[t] = pt[1];
      sz[t] = pt[2];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < lim; ++t) {
      float v = sq_dist3(qx, qy, qz, sx[t], sy[t], sz[t]);
      int vi = base + t;
      if (!(v < bd[K - 1] || (v == bd[K - 1] && vi < bi[K - 1]))) continue;
      // bubble (v, vi) into place; the pair pushed out of slot K-1 drops
#pragma unroll
      for (int p = 0; p < K; ++p) {
        if (v < bd[p] || (v == bd[p] && vi < bi[p])) {
          const float tv = bd[p];
          const int ti = bi[p];
          bd[p] = v;
          bi[p] = vi;
          v = tv;
          vi = ti;
        }
      }
    }
  }

  if (active) {
    float w[K];
    float wsum = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      w[t] = __fdiv_rn(1.f, __fadd_rn(bd[t], 1e-8f));
      wsum = __fadd_rn(wsum, w[t]);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) {
      sel_w[threadIdx.x][t] = __fdiv_rn(w[t], wsum);
      // only a NaN coordinate leaves a slot unfilled; keep the read in bounds
      sel_idx[threadIdx.x][t] = bi[t] == INT_MAX ? 0 : bi[t];
    }
  }
  __syncthreads();

  const int nq = min(kQueries, n - q0);
  const float* f = feats + (size_t)b * s * d;
  float* o = out + ((size_t)b * n + q0) * d;
  for (int e = threadIdx.x; e < nq * d; e += blockDim.x) {
    const int r = e / d;
    const int ch = e - r * d;
    float acc = __fmul_rn(sel_w[r][0], __ldg(f + (size_t)sel_idx[r][0] * d + ch));
#pragma unroll
    for (int t = 1; t < K; ++t) {
      acc = __fadd_rn(
          acc, __fmul_rn(sel_w[r][t], __ldg(f + (size_t)sel_idx[r][t] * d + ch)));
    }
    o[e] = acc;
  }
}

template <int K>
void launch_interp(const float* dst, const float* src, const float* feats,
                   float* out, int b, int n, int s, int d, cudaStream_t st) {
  const dim3 grid((n + kQueries - 1) / kQueries, b);
  interp_kernel<K><<<grid, kQueries, 0, st>>>(dst, src, feats, out, n, s, d);
}

}  // namespace

// 1 <= k <= min(4, s), checked by the wrapper.
PCB_API int pcb_interpolate(const float* dst, const float* src,
                            const float* feats, float* out, int b, int n,
                            int s, int d, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: launch_interp<1>(dst, src, feats, out, b, n, s, d, st); break;
    case 2: launch_interp<2>(dst, src, feats, out, b, n, s, d, st); break;
    case 3: launch_interp<3>(dst, src, feats, out, b, n, s, d, st); break;
    case 4: launch_interp<4>(dst, src, feats, out, b, n, s, d, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
