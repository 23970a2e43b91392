// K2: exact ball query.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/ballq.py, _ballq_kernel
// (called by _ballq_call; entry ball_query_pallas).
//
// Semantics (pointnet2_utils.py:97-112): for each query centre, the first K
// point indices in ascending order whose squared distance is <= r2 (r2 is
// radius*radius rounded to float32 by the caller); slots past the last hit
// hold the first hit; an empty ball gives N in every slot. K may exceed N.
//
// What bounds it on the H100: compare-and-scan work. A query scans points in
// index order until it has K hits, so the cost is the number of points
// scanned times B*S, plus the read of each point tile; there is no
// [B, S, N] distance matrix and no sort.
//
// Design: one warp per query, eight queries (one batch row) per block. The
// block stages tiles of 512 points in shared memory (structure of arrays)
// and every warp scans them 32 points at a time: each lane tests one point,
// a ballot gives the hits of the 32 in index order, and a popcount of the
// lower lanes gives each hit its slot, so the ascending order falls out
// without a cumsum. A warp stops at K hits; the block stops loading tiles
// once all its warps have stopped. Padding the tail slots is one strided
// store per lane.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;    // queries per block
constexpr int kTile = 512;   // points staged per tile

__global__ void ballq_kernel(const float* __restrict__ xyz,
                             const float* __restrict__ centers,
                             int* __restrict__ out, int n, int s, int k,
                             float r2) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = q < s;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + ((size_t)b * s + q) * k;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* c = centers + ((size_t)b * s + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }

  int count = 0;  // hits so far; the same in every lane of the warp
  int first = n;  // index of the first hit, N while the ball is empty
  bool done = !active;
  for (int base = 0; base < n; base += kTile) {
    if (__syncthreads_and(done)) break;
    const int lim = min(kTile, n - base);
    for (int t = threadIdx.x; t < lim; t += blockDim.x) {
      const float* pt = p + (size_t)(base + t) * 3;
      tx[t] = pt[0];
      ty[t] = pt[1];
      tz[t] = pt[2];
    }
    __syncthreads();
    if (!done) {
      for (int t0 = 0; t0 < lim && count < k; t0 += 32) {
        const int t = t0 + lane;
        const bool hit =
            t < lim && sq_dist3(qx, qy, qz, tx[t], ty[t], tz[t]) <= r2;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m == 0u) continue;
        if (count == 0) first = base + t0 + __ffs(m) - 1;
        if (hit) {
          const int slot = count + __popc(m & ((1u << lane) - 1u));
          if (slot < k) o[slot] = base + t;
        }
        count += __popc(m);
      }
      done = count >= k;
    }
  }
  if (active) {
    for (int slot = count + lane; slot < k; slot += 32) o[slot] = first;
  }
}

}  // namespace

PCB_API int pcb_ball_query(const float* xyz, const float* centers, int* out,
                           int b, int n, int s, int k, float r2, int device,
                           void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  ballq_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      xyz, centers, out, n, s, k, r2);
  return (int)cudaGetLastError();
}
