// K4b: k-NN inverse-distance interpolation, backward to the source features.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/interp3.py,
// _interp_bwd_kernel (called by _interp_bwd_call; the VJP of
// interpolate_pallas). It computes df = blend^T . g:
//   df[b, s, :] = sum over queries q and slots t with idx[b,q,t] == s of
//                 w[b,q,t] * g[b,q,:]
// The coordinates get no gradient (zeros in the Pallas VJP): FP-layer
// coordinates are gathers of the input cloud and depend on no parameter.
//
// What bounds it on the H100: bytes of g (read once) and the atomic adds
// into df (k per element of g). Where few sources take many queries (fp3:
// 64 sources for 256 queries at width 512) the adds contend on the same
// addresses.
//
// Design: the Pallas kernel recomputes the neighbour search and runs a
// [TQ, S]^T x [TQ, D] one-hot product on the MXU, carrying df across its
// sequential query grid. Blocks on the card run in no order, so the sum
// across queries goes through atomics instead, and the search is not
// repeated: the forward kernel (interp.cu) saved each query's k indices and
// normalised weights. One warp per query row: the lanes read g's row along
// D (coalesced) and add w * g into the k source rows, also along D. df is
// zeroed on the same stream first. The order of the float adds varies from
// run to run, so the result is close to, not bit-equal with, an ordered sum.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void interp_bwd_kernel(const float* __restrict__ g,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w,
                                  float* __restrict__ df, int rows, int n,
                                  int s, int d, int k) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // b*N+q
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / n;
  const int* ri = idx + (size_t)row * k;
  const float* rw = w + (size_t)row * k;
  const float* gr = g + (size_t)row * d;
  float* base = df + (size_t)b * s * d;
  for (int ch = lane; ch < d; ch += 32) {
    const float gv = __ldg(gr + ch);
    for (int t = 0; t < k; ++t) {
      atomicAdd(base + (size_t)__ldg(ri + t) * d + ch, __fmul_rn(__ldg(rw + t), gv));
    }
  }
}

}  // namespace

// g [B, N, D], idx [B, N, k] int32 in [0, S), w [B, N, k] -> df [B, S, D].
PCB_API int pcb_interpolate_backward(const float* g, const int* idx,
                                     const float* w, float* df, int b, int n,
                                     int s, int d, int k, int device,
                                     void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(df, 0, (size_t)b * s * d * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int rows = b * n;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  interp_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, st>>>(g, idx, w, df, rows,
                                                            n, s, d, k);
  return (int)cudaGetLastError();
}
