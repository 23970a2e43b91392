// K3: grouped gather, fused with the centre subtraction and the feature
// gather of group_points.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/gather3.py,
// _gather3_kernel (called by _gather3_call; entry gather3_pallas), which
// ops/grouping.py::group_points reaches through index_points. The Pallas
// kernel gathers the 3 xyz channels only; here one kernel writes the whole
// [B, S, K, 3 + C] result of group_points:
//   out[b,s,k,0:3]   = xyz[b, j] - centers[b, s]
//   out[b,s,k,3:3+C] = feats[b, j]          with j = clamp(idx[b,s,k], 0, N-1)
// The clamp is index_points' (ops/core.py:93): a ball-query miss is N.
//
// What bounds it on the H100: bytes. Every output element is one load and
// one store with no reuse beyond the rows that several neighbourhoods share
// (which L2 catches); there is no arithmetic beyond one subtraction.
//
// Design: one thread per output element, in output order, so the stores of
// a warp are contiguous and the loads of a row's feature channels are too.
// A grid-stride loop covers any size; the wrapper keeps the element count
// below 2^31 so the index arithmetic stays 32-bit. The one-hot MXU gather of
// the Pallas kernel was a TPU artefact and has no counterpart.
#include "common.cuh"

namespace {

__global__ void group_kernel(const float* __restrict__ xyz,
                             const float* __restrict__ centers,
                             const int* __restrict__ idx,
                             const float* __restrict__ feats,
                             float* __restrict__ out, int n, int s, int k,
                             int c, int total) {
  const int width = 3 + c;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int row = e / width;  // (b * S + s) * K + k
    const int ch = e - row * width;
    const int bs = row / k;     // b * S + s
    const int b = bs / s;
    int j = __ldg(idx + row);
    j = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
    const size_t pt = (size_t)b * n + j;
    out[e] = ch < 3 ? __fsub_rn(__ldg(xyz + pt * 3 + ch),
                                __ldg(centers + (size_t)bs * 3 + ch))
                    : __ldg(feats + pt * c + (ch - 3));
  }
}

}  // namespace

// feats may be null when c == 0.
PCB_API int pcb_group(const float* xyz, const float* centers, const int* idx,
                      const float* feats, float* out, int b, int n, int s,
                      int k, int c, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int total = b * s * k * (3 + c);  // < 2^31, checked by the wrapper
  const int threads = 256;
  int blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  group_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      xyz, centers, idx, feats, out, n, s, k, c, total);
  return (int)cudaGetLastError();
}
