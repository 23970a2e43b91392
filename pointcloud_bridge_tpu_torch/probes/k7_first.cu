// The first design of K7, kept beside the port for comparison: the probe
// k7_probe.py builds it (with k7b_first.cu) into its own library, and
// chip_smoke.py times it in braces beside csrc/edge_reduce.cu. Not on any
// path of the port. The text below is the file as the first design had it, its entry
// point renamed pcb_edge_reduce_first.
//
// K7: the neighbour reduction of DGCNN's restructured EdgeConv.
//
// Replaces: no Pallas kernel. The JAX package runs the restructured
// EdgeConv on the TPU (pointcloud_bridge_tpu/models/dgcnn.py:117-140), where
// XLA fuses index_points(y, idx) with the max, min, mean and mean-square
// reductions over the k neighbours (dgcnn.py:127-137) into one read of the
// gathered rows. This kernel is that fusion written by hand, so that the
// [B, S, k, F] gathered tensor is never built. For y [B, N, F] and idx
// [B, S, k]:
//   mx[b, i, :] = max_j y[b, clamp(idx[b, i, j]), :]    (NaN propagates)
//   mn[b, i, :] = min_j y[b, clamp(idx[b, i, j]), :]
// and, with `moments` (train mode, whose BatchNorm needs the moments of
// h_j = y_j + z_i):
//   s1[b, i, :] = (sum_j y_j) * inv_k,  s2[b, i, :] = (sum_j y_j * y_j) * inv_k
// with inv_k = float32(1 / k). The clamp is index_points' (ops/core.py).
//
// The order is fixed: each sum is a left fold from 0.0 over the slots in
// ascending j, every multiply and add rounded on its own (the library is
// built with -fmad=false), so a call gives the same bits every time and
// ops/edge.py::edge_reduce_plain, which folds the same way, gives them too.
// mx and mn are selections, exact on any device.
//
// Design: a warp a row i and a chunk of 32 * V channels (V = 1, 2 or 4
// consecutive floats a lane, the wrapper's pick: F = 64 takes V = 2, one
// 256-byte row a slot). Lane l loads slot s0 + l's index; the warp walks
// the slots in order, a shuffle hands each lane the slot's row, and every
// lane loads its V channels of kAhead rows before folding them in order.
// What bounds it on the H100: bytes. Each output is written once and idx
// read once; y is read k times, but a cloud's rows (1 MB at N = 4096, F =
// 64) stay in the 50 MB L2, so HBM sees y about once. The bound counts idx,
// y once and the outputs.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 4;  // slots whose rows a lane loads before folding

template <int V>
__device__ __forceinline__ void load_row(float (&r)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = q.x, r[1] = q.y;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

template <int V, bool kMoments>
__global__ void __launch_bounds__(kThreads)
    edge_reduce_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                       float* __restrict__ mx, float* __restrict__ mn, float* __restrict__ s1,
                       float* __restrict__ s2, int rows, int n, int s, int k, int f,
                       float inv_k) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int ch = (blockIdx.y * 32 + lane) * V;
  const bool active = ch < f;
  const int* ir = idx + (size_t)row * k;
  const float* yb = y + (size_t)(row / s) * n * f + ch;
  const float inf = __int_as_float(0x7f800000);
  float hi[V], lo[V], sum[V], sq[V];
#pragma unroll
  for (int c = 0; c < V; ++c) hi[c] = -inf, lo[c] = inf, sum[c] = 0.0f, sq[c] = 0.0f;

  for (int s0 = 0; s0 < k; s0 += 32) {
    const int mine = s0 + lane < k ? clamp_index(__ldg(ir + s0 + lane), n) : 0;
    const int m = min(32, k - s0);
    for (int q = 0; q < m; q += kAhead) {
      float v[kAhead][V];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = __shfl_sync(0xffffffffu, mine, (q + u) & 31);
        if (active && q + u < m) load_row<V>(v[u], yb + (size_t)j * f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (!active || q + u >= m) continue;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float a = v[u][c];
          // NaN sticks: once hi is NaN no comparison replaces it
          hi[c] = (a > hi[c] || a != a) ? a : hi[c];
          lo[c] = (a < lo[c] || a != a) ? a : lo[c];
          if (kMoments) {
            sum[c] = __fadd_rn(sum[c], a);
            sq[c] = __fadd_rn(sq[c], __fmul_rn(a, a));
          }
        }
      }
    }
  }
  if (!active) return;
  const size_t at = (size_t)row * f + ch;
  store_row<V>(mx + at, hi);
  store_row<V>(mn + at, lo);
  if (kMoments) {
#pragma unroll
    for (int c = 0; c < V; ++c) sum[c] = __fmul_rn(sum[c], inv_k), sq[c] = __fmul_rn(sq[c], inv_k);
    store_row<V>(s1 + at, sum);
    store_row<V>(s2 + at, sq);
  }
}

template <int V>
cudaError_t launch(const float* y, const int* idx, float* mx, float* mn, float* s1, float* s2,
                   int rows, int n, int s, int k, int f, bool moments, float inv_k,
                   cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps),
                  (unsigned)((f + 32 * V - 1) / (32 * V)));
  if (moments)
    edge_reduce_kernel<V, true><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, s1, s2, rows, n, s, k,
                                                           f, inv_k);
  else
    edge_reduce_kernel<V, false><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, s1, s2, rows, n, s,
                                                            k, f, inv_k);
  return cudaGetLastError();
}

}  // namespace

// y [B, N, F], idx [B, S, k] -> mx, mn and, with moments, s1, s2, each
// [B, S, F] (s1 and s2 may be null without moments). `plan` holds the
// integers of a launch, laid out once a shape by the wrapper
// (ops/edge.py::_edge_plan, fields EDGE_PLAN): b, n, s, k, f, vec (1, 2 or
// 4 floats a lane; every pointer aligned to it and F a multiple of it),
// moments, and inv_k's float32 bits. The wrapper checks k >= 1, F >= 1
// and B * S < 2^31.
PCB_API int pcb_edge_reduce_first(const float* y, const int* idx, float* mx, float* mn, float* s1,
                            float* s2, const int* plan, int device, void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int f = plan[4];
  const int vec = plan[5];
  const int moments = plan[6];
  float inv_k;
  std::memcpy(&inv_k, plan + 7, sizeof(float));
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = b * s;
  if (vec == 4) return (int)launch<4>(y, idx, mx, mn, s1, s2, rows, n, s, k, f, moments, inv_k, st);
  if (vec == 2) return (int)launch<2>(y, idx, mx, mn, s1, s2, rows, n, s, k, f, moments, inv_k, st);
  if (vec == 1) return (int)launch<1>(y, idx, mx, mn, s1, s2, rows, n, s, k, f, moments, inv_k, st);
  return (int)cudaErrorInvalidValue;
}
