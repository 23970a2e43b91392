// The first design of K7b, kept beside the port for comparison: the per-edge
// gradients [B, S, k, F] that K3b (csrc/group_bwd.cu) then folds. The probe
// k7_probe.py builds it (with k7_first.cu) into its own library; chip_smoke.py
// times it in braces beside csrc/edge_reduce_bwd.cu and measures its peak
// memory. Not on any path of the port. The text below is the file as the
// first design had it, its entry point renamed pcb_edge_reduce_backward_first.
//
// K7b: the backward of K7 (edge_reduce.cu), as per-edge gradients that the
// group backward (K3b, group_bwd.cu) folds onto the points.
//
// Replaces: no Pallas kernel: the VJP that XLA derives for the reductions
// of pointcloud_bridge_tpu/models/dgcnn.py:127-137 on the TPU. For row i
// and its slot j (point p = clamp(idx[b, i, j])), channel c, v = y[b, p, c]:
//   e[b, i, j, c] = ((v == mx_i ? g_mx_i / n_mx_i : 0)
//                    + (v == mn_i ? g_mn_i / n_mn_i : 0))
//                   + g_s1_i * inv_k + v * ((g_s2_i * inv_k) * 2)
// where n_mx_i counts the slots of row i whose value equals mx_i: a tie
// splits the cotangent evenly, as JAX's reduce_max VJP and torch's amax
// backward do. The last two terms only with moments. Each operation is
// rounded on its own in that order (-fmad=false), as
// ops/edge.py::edge_grads_plain computes it, so the two give the same bits.
// The wrapper then hands e [B, S, k, F] to K3b (group_backward_cuda), which
// sums each point's slots in ascending i * k + j: the gradient on y is the
// same bits every call.
//
// Design: a warp a row and a chunk of 32 * V channels, as K7: one pass over
// the slots counts the ties, a second computes and stores each slot's row
// of e (coalesced, V floats a lane). This is the first design: e is a
// [B, S, k, F] float32 scratch (B = 16, N = 4096, k = 20, F = 64: 336 MB;
// k = 64, F = 128: 2.1 GB) written here and read once by K3b; a fold that
// computes the slots' terms itself would not need it.
// What bounds it on the H100: bytes, e written once, idx, y, and the six
// per-row arrays read once.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 4;

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
    edge_reduce_bwd_kernel(const float* __restrict__ y, const int* __restrict__ idx,
                           const float* __restrict__ mx, const float* __restrict__ mn,
                           const float* __restrict__ gmx, const float* __restrict__ gmn,
                           const float* __restrict__ gs1, const float* __restrict__ gs2,
                           float* __restrict__ e, int rows, int n, int s, int k, int f,
                           float inv_k) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int ch = (blockIdx.y * 32 + lane) * V;
  const bool active = ch < f;
  const int* ir = idx + (size_t)row * k;
  const float* yb = y + (size_t)(row / s) * n * f + ch;
  const size_t at = (size_t)row * f + ch;
  float hi[V], lo[V], gx[V], gn[V], h1[V], h2[V];
  int nx[V], nn[V];
#pragma unroll
  for (int c = 0; c < V; ++c) nx[c] = nn[c] = 0;
  if (active) {
    load_row<V>(hi, mx + at);
    load_row<V>(lo, mn + at);
  }

  // pass 1: the ties of the max and of the min
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
        for (int c = 0; c < V; ++c) nx[c] += v[u][c] == hi[c], nn[c] += v[u][c] == lo[c];
      }
    }
  }
  if (active) {
    load_row<V>(gx, gmx + at);
    load_row<V>(gn, gmn + at);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      gx[c] = __fdiv_rn(gx[c], (float)nx[c]);
      gn[c] = __fdiv_rn(gn[c], (float)nn[c]);
    }
    if (kMoments) {
      load_row<V>(h1, gs1 + at);
      load_row<V>(h2, gs2 + at);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        h1[c] = __fmul_rn(h1[c], inv_k);
        h2[c] = __fmul_rn(__fmul_rn(h2[c], inv_k), 2.0f);
      }
    }
  }

  // pass 2: each slot's row of e
  float* eb = e + (size_t)row * k * f + ch;
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
        float out[V];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const float a = v[u][c];
          float t = __fadd_rn(a == hi[c] ? gx[c] : 0.0f, a == lo[c] ? gn[c] : 0.0f);
          if (kMoments) t = __fadd_rn(__fadd_rn(t, h1[c]), __fmul_rn(a, h2[c]));
          out[c] = t;
        }
        store_row<V>(eb + (size_t)(s0 + q + u) * f, out);
      }
    }
  }
}

template <int V>
cudaError_t launch(const float* y, const int* idx, const float* mx, const float* mn,
                   const float* gmx, const float* gmn, const float* gs1, const float* gs2,
                   float* e, int rows, int n, int s, int k, int f, bool moments, float inv_k,
                   cudaStream_t st) {
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps),
                  (unsigned)((f + 32 * V - 1) / (32 * V)));
  if (moments)
    edge_reduce_bwd_kernel<V, true><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, gmx, gmn, gs1,
                                                               gs2, e, rows, n, s, k, f, inv_k);
  else
    edge_reduce_bwd_kernel<V, false><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, gmx, gmn, gs1,
                                                                gs2, e, rows, n, s, k, f, inv_k);
  return cudaGetLastError();
}

}  // namespace

// y [B, N, F], idx [B, S, k], K7's mx and mn [B, S, F], their cotangents
// g_mx, g_mn and, with moments, those of s1 and s2 (else null), each
// [B, S, F] -> e [B, S, k, F]. `plan` is K7's (ops/edge.py EDGE_PLAN), its
// vec the alignment of every pointer here.
PCB_API int pcb_edge_reduce_backward_first(const float* y, const int* idx, const float* mx,
                                     const float* mn, const float* g_mx, const float* g_mn,
                                     const float* g_s1, const float* g_s2, float* e,
                                     const int* plan, int device, void* stream) {
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
  if (vec == 4)
    return (int)launch<4>(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2, e, rows, n, s, k, f, moments,
                          inv_k, st);
  if (vec == 2)
    return (int)launch<2>(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2, e, rows, n, s, k, f, moments,
                          inv_k, st);
  if (vec == 1)
    return (int)launch<1>(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2, e, rows, n, s, k, f, moments,
                          inv_k, st);
  return (int)cudaErrorInvalidValue;
}
