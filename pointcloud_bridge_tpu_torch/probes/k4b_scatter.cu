// K4b design (b), measured against csrc/interp_bwd.cu by k4b_probe.py and
// not on the port's main path: the scatter, with cheaper atomics than the
// parent's kernel. df is zeroed first (cudaMemsetAsync); then a warp takes
// `rows` query rows in turn, loads each row's k indices and weights once (a
// lane a slot) and hands them round by shuffles, reads g's row along D, 16
// bytes a lane where it can, and adds w * g into the k source rows with one
// 16-byte reduction (RED.E.ADD.F32x4) a lane and slot. The float adds land
// in no fixed order, so the sums change in their last bits from run to run.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
scatter_kernel(const float* __restrict__ g, const int* __restrict__ idx,
               const float* __restrict__ w, float* __restrict__ df, int total,
               int n, int s, int d, int k, int rows) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows;
  for (int row = first; row < min(first + rows, total); ++row) {
    const int b = row / n;
    const int mine = lane < k ? __ldg(idx + (size_t)row * k + lane) : 0;
    const float wmine = lane < k ? __ldg(w + (size_t)row * k + lane) : 0.f;
    const float* gr = g + (size_t)row * d;
    float* base = df + (size_t)b * s * d;
    int src[4];
    float wt[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      src[t] = __shfl_sync(0xffffffffu, mine, t);
      wt[t] = __shfl_sync(0xffffffffu, wmine, t);
    }
    if (kVec) {
      for (int c = 4 * lane; c < d; c += 128) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gr + c));
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t < k && (unsigned)src[t] < (unsigned)s) {
            red_add4(base + (size_t)src[t] * d + c,
                     make_float4(__fmul_rn(wt[t], gv.x), __fmul_rn(wt[t], gv.y),
                                 __fmul_rn(wt[t], gv.z), __fmul_rn(wt[t], gv.w)));
          }
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float gv = __ldg(gr + c);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t < k && (unsigned)src[t] < (unsigned)s) {
            atomicAdd(base + (size_t)src[t] * d + c, __fmul_rn(wt[t], gv));
          }
        }
      }
    }
  }
}

}  // namespace

// The plan of csrc/interp_bwd.cu (B, N, S, D, k, rows, vec), with `rows` the
// query rows a warp.
PCB_API int pcb_interp_bwd_scatter(const float* g, const int* idx, const float* w, float* df,
                                   const int* plan, int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int d = plan[3];
  const int k = plan[4];
  const int rows = plan[5];
  const int vec = plan[6];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(df, 0, (size_t)b * s * d * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int total = b * n;
  const int blocks = (total + kWarps * rows - 1) / (kWarps * rows);
  if (blocks == 0) return (int)cudaGetLastError();
  if (vec) {
    scatter_kernel<true><<<blocks, kWarps * 32, 0, st>>>(g, idx, w, df, total, n, s, d, k, rows);
  } else {
    scatter_kernel<false><<<blocks, kWarps * 32, 0, st>>>(g, idx, w, df, total, n, s, d, k, rows);
  }
  return (int)cudaGetLastError();
}
