// K3b: backward of the fused group (group.cu): scatter-add of the grouped
// gradient onto the points.
//
// Replaces: the backward of pointcloud_bridge_tpu/ops/pallas_kernels/
// gather3.py's grouped gather, which the JAX package runs as the XLA
// scatter-add _gather3_bwd (ops/core.py:44-52) for the xyz channels and as
// XLA's gather transpose (ops/core.py:105) for the feature channels. For a
// channel range [c0, c1) of g [B, S, K, 3 + C]:
//   out[b, j, ch - c0] += g[b, s, k, ch]      with j = clamp(idx[b,s,k], 0, N-1)
// c0 = 3 gives dfeatures [B, N, C]; c0 = 0 adds dxyz in front. The clamp is
// index_points' (ops/core.py:93): an empty-ball slot holds N, read point
// N-1, and so sends its gradient to N-1. A sparse ball repeats its first hit
// in several slots, and every repeat adds its gradient, as XLA's scatter-add
// does. (dnew_xyz = -sum_K g[..., :3] is a plain reduction beside it.)
//
// What bounds it on the H100: bytes of g (read once) and one atomic add per
// element into out, whose rows neighbourhoods share; the repeats of a sparse
// ball contend on one row.
//
// Design: the mirror of group.cu: one thread per element of g's channel
// range, in g's order, so a warp reads contiguous channels of one row and
// adds into contiguous channels of one point. A grid-stride loop covers any
// size; the wrapper keeps the element count below 2^30 so the index
// arithmetic stays 32-bit. out is zeroed on the same stream first. The order
// of the float adds varies from run to run.
#include "common.cuh"

namespace {

__global__ void group_bwd_kernel(const float* __restrict__ g,
                                 const int* __restrict__ idx,
                                 float* __restrict__ out, int n, int s, int k,
                                 int width, int c0, int wout, int total) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int row = e / wout;  // (b * S + s) * K + k
    const int ch = e - row * wout;
    const int b = row / (s * k);
    int j = __ldg(idx + row);
    j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
    atomicAdd(out + ((size_t)b * n + j) * wout + ch,
              __ldg(g + (size_t)row * width + c0 + ch));
  }
}

}  // namespace

// g [B, S, K, width], idx [B, S, K] -> out [B, N, c1 - c0];
// 0 <= c0 < c1 <= width, checked by the wrapper.
PCB_API int pcb_group_backward(const float* g, const int* idx, float* out,
                               int b, int n, int s, int k, int width, int c0,
                               int c1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int wout = c1 - c0;
  err = cudaMemsetAsync(out, 0, (size_t)b * n * wout * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int total = b * s * k * wout;  // < 2^30, checked by the wrapper
  const int threads = 256;
  int blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  group_bwd_kernel<<<blocks, threads, 0, st>>>(g, idx, out, n, s, k, width, c0,
                                               wout, total);
  return (int)cudaGetLastError();
}
