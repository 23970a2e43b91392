// K7b's ties from a row pass of its own, measured and kept out of the port:
// the other way to give K7b the counts it divides by. Where K7 counts the
// ties online in its train flavour (csrc/edge_reduce.cu, `ties`), this pass
// leaves K7 as it was and walks each row's k neighbour rows again in the
// backward, comparing each slot's value with K7's mx and mn:
//   ties[b, i, c] = #{j : y[b, p_j, c] == mx[b, i, c]}
//                   | #{j : y[b, p_j, c] == mn[b, i, c]} << 16
// (p_j = clamp(idx[b, i, j])), the counts of ops/edge.py::tie_counts_plain.
// A warp a row and a chunk of 32 * V channels, the walk of K7's rows route.
// The probe k7_probe.py builds it and times K7 and this pass against K7
// counting online (chip_smoke.py --edge ties). Not on any path of the port.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 4;  // slots whose rows a lane loads before comparing

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
__global__ void __launch_bounds__(kThreads)
    edge_tie_rows(const float* __restrict__ y, const int* __restrict__ idx,
                  const float* __restrict__ mx, const float* __restrict__ mn,
                  int* __restrict__ ties, int rows, int n, int s, int k, int f) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int ch = (blockIdx.y * 32 + lane) * V;
  const bool active = ch < f;
  const int* ir = idx + (size_t)row * k;
  const float* yb = y + (size_t)(row / s) * n * f + ch;
  const size_t at = (size_t)row * f + ch;
  float hi[V], lo[V];
  int nx[V], nn[V];
#pragma unroll
  for (int c = 0; c < V; ++c) hi[c] = 0.0f, lo[c] = 0.0f, nx[c] = 0, nn[c] = 0;
  if (active) load_row<V>(hi, mx + at), load_row<V>(lo, mn + at);

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
  if (!active) return;
#pragma unroll
  for (int c = 0; c < V; ++c) ties[at + c] = (int)((unsigned)nx[c] | (unsigned)nn[c] << 16);
}

}  // namespace

// y [B, N, F], idx [B, S, k], mx and mn [B, S, F] -> ties [B, S, F] int32.
// `plan` is K7's (ops/edge.py::_edge_plan, fields EDGE_PLAN): b, n, s, k,
// f, vec, moments (not read) and inv_k's bits (not read).
PCB_API int pcb_edge_tie_rows(const float* y, const int* idx, const float* mx, const float* mn,
                              int* ties, const int* plan, int device, void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int f = plan[4];
  const int vec = plan[5];
  const int rows = b * s;
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps),
                  (unsigned)((f + 32 * vec - 1) / (32 * vec)));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4)
    edge_tie_rows<4><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, ties, rows, n, s, k, f);
  else if (vec == 2)
    edge_tie_rows<2><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, ties, rows, n, s, k, f);
  else if (vec == 1)
    edge_tie_rows<1><<<grid, kThreads, 0, st>>>(y, idx, mx, mn, ties, rows, n, s, k, f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
