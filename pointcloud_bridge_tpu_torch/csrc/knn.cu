// K5: exact k nearest neighbours, nearest first.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/knnset.py,
// _knnset_kernel (called by _knnset_call; entry topk_set_from_buffer), and
// with it the lax.approx_max_k candidate buffer that kernel selects from
// (ops/grouping.py::knn_set). The buffer exists only because the TPU has a
// hardware approximate top-k; here one kernel goes from the coordinates to
// the exact k-NN, which is what ops.knn / knn_with_distance / knn_set
// compute on the exact path.
//
// Semantics: for each query the k points with the smallest squared
// distance (dx*dx + dy*dy) + dz*dz, ascending; equal distances go to the
// lower index (lax.top_k on -d, a stable sort). Outputs idx [B, S, k] int32
// and d2 [B, S, k] float32.
//
// What bounds it on the H100: operations. B*S*N distance evaluations and
// compares (67 M at B=4, N=S=4096) against under 5 MB moved; and below
// that floor, the latency of the insertions into the running list.
//
// Design: one warp per query, eight queries per block. The block stages
// the points in shared memory, 1024 at a time, as three coordinate planes
// (conflict-free reads). In each step the warp's 32 lanes take 32
// consecutive points, one distance each. The warp keeps the k best so far
// as one sorted list spread over its lanes: position p lives in lane p % 32,
// register p / 32 (k <= 64 needs two registers a lane), so the list costs
// no shared memory and never spills, however large k is. A point enters
// only if it beats the k-th best; one ballot a step finds such lanes, and
// in the common case there is none and the step costs a dozen
// instructions. Points are visited in index order and must be strictly
// closer than the k-th to enter, and an entering point goes behind every
// entry at the same distance: together that is the lower-index-first tie
// rule. An insertion is a ballot for the position, one shuffle-up a
// register, and a shuffle for the new k-th. With random points a query
// sees about k*ln(N/k) insertions, far fewer than N.
//
// A NaN or infinite distance never enters. The wrapper requires k <= N, so
// with finite coordinates every slot is filled.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;     // queries per block
constexpr int kTile = 1024;   // points staged per tile
constexpr unsigned kFull = 0xffffffffu;

// TWO: the list is up to 64 long (two registers a lane), else up to 32.
template <bool TWO>
__global__ void knn_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ query,
                           int* __restrict__ idx_out,
                           float* __restrict__ d2_out, int n, int s, int k) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarps + warp;
  const bool active = q < s;  // uniform over the warp
  const float* pts = xyz + (size_t)b * n * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* c = query + ((size_t)b * s + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }

  const float inf = __int_as_float(0x7f800000);
  // list position lane in (d0, i0), position lane + 32 in (d1, i1)
  float d0 = inf, d1 = inf;
  int i0 = INT_MAX, i1 = INT_MAX;
  float kth = inf;  // distance at position k - 1

  for (int base = 0; base < n; base += kTile) {
    const int lim = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < lim; t += blockDim.x) {
      const float* pt = pts + (size_t)(base + t) * 3;
      sx[t] = pt[0];
      sy[t] = pt[1];
      sz[t] = pt[2];
    }
    __syncthreads();
    if (!active) continue;

    for (int t0 = 0; t0 < lim; t0 += 32) {
      const int t = t0 + lane;
      float v = inf;
      if (t < lim) v = sq_dist3(qx, qy, qz, sx[t], sy[t], sz[t]);
      unsigned m = __ballot_sync(kFull, v < kth);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float cv = __shfl_sync(kFull, v, src);
        if (!(cv < kth)) continue;  // the k-th moved since the ballot
        const int ci = base + t0 + src;
        // entries at the same distance have lower indices: they stay ahead
        int pos = __popc(__ballot_sync(kFull, d0 <= cv));
        if (TWO) pos += __popc(__ballot_sync(kFull, d1 <= cv));
        // positions >= pos move up by one, the candidate takes pos
        const float up_d0 = __shfl_up_sync(kFull, d0, 1);
        const int up_i0 = __shfl_up_sync(kFull, i0, 1);
        if (TWO) {
          float up_d1 = __shfl_up_sync(kFull, d1, 1);
          int up_i1 = __shfl_up_sync(kFull, i1, 1);
          const float last_d0 = __shfl_sync(kFull, d0, 31);
          const int last_i0 = __shfl_sync(kFull, i0, 31);
          if (lane == 0) {
            up_d1 = last_d0;
            up_i1 = last_i0;
          }
          const int p1 = lane + 32;
          if (p1 > pos) {
            d1 = up_d1;
            i1 = up_i1;
          } else if (p1 == pos) {
            d1 = cv;
            i1 = ci;
          }
        }
        if (lane > pos) {
          d0 = up_d0;
          i0 = up_i0;
        } else if (lane == pos) {
          d0 = cv;
          i0 = ci;
        }
        kth = (TWO && k > 32) ? __shfl_sync(kFull, d1, k - 33)
                              : __shfl_sync(kFull, d0, k - 1);
      }
    }
  }

  if (!active) return;
  const size_t row = ((size_t)b * s + q) * k;
  if (lane < k) {
    idx_out[row + lane] = i0 == INT_MAX ? 0 : i0;
    d2_out[row + lane] = d0;
  }
  if (TWO && lane + 32 < k) {
    idx_out[row + lane + 32] = i1 == INT_MAX ? 0 : i1;
    d2_out[row + lane + 32] = d1;
  }
}

}  // namespace

// 1 <= k <= min(64, n), checked by the wrapper.
PCB_API int pcb_knn(const float* xyz, const float* query, int* idx_out,
                    float* d2_out, int b, int n, int s, int k, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 64 || k > n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  if (k > 32) {
    knn_kernel<true><<<grid, kWarps * 32, 0, st>>>(xyz, query, idx_out, d2_out,
                                                   n, s, k);
  } else {
    knn_kernel<false><<<grid, kWarps * 32, 0, st>>>(xyz, query, idx_out,
                                                    d2_out, n, s, k);
  }
  return (int)cudaGetLastError();
}
