// K3b: backward of the fused group (group.cu): scatter-add of the grouped
// gradient onto the points.
//
// Replaces: the backward of pointcloud_bridge_tpu/ops/pallas_kernels/
// gather3.py's grouped gather, which the JAX package runs as the XLA
// scatter-add _gather3_bwd (ops/core.py:44-52) for the xyz channels and as
// XLA's gather transpose (ops/core.py:105) for the feature channels. For a
// channel range [c0, c1) of g [B, S, K, 3 + C]:
//   out[b, j, ch - c0] += g[b, s, k, ch]      with j = clamp(idx[b,s,k], 0, N-1)
// c0 = 3 gives dfeatures [B, N, C]; c0 = 0 adds dxyz in front, c1 = 3 is
// dxyz alone. The clamp is index_points' (ops/core.py:93): an empty-ball
// slot holds N, reads point N-1, and so sends its gradient to N-1. A sparse
// ball repeats its first hit in its trailing slots, and every repeat adds its
// gradient, as XLA's scatter-add does. (dnew_xyz = -sum_K g[..., :3] is a
// plain reduction beside it.)
//
// What bounds it on the H100: bytes, g read once (17 MB at the SSG train
// step's sa2 at B=4). A thread an element, as this kernel first ran, spends
// two divisions by runtime values and one 4-byte atomic on each element, and
// the trailing repeats of a sparse ball all add into one address in turn.
//
// Design:
// - A warp owns one ball (b, s) and one chunk of G * V channels
//   (blockIdx.x * 4 + warp = s, blockIdx.y = chunk, blockIdx.z = b: no
//   division anywhere). G lanes (4, 8, 16 or 32, by the width) cover a
//   slot's channels, so 32 / G slots go at once; V = 4 channels a lane where
//   c1 - c0 is a multiple of 4 (an output row is then 16-byte aligned), else 1.
// - The warp first finds where the trailing run of first-hit repeats starts
//   (one ballot over each 32 slots, from the end). It then walks the ball's
//   slots in order, kSlots a group in flight (all their loads issued before
//   any reduction): a slot before the run adds into its point with one
//   reduction, `red_add4` (16 bytes, compute capability 9.x) or a scalar
//   atomicAdd; slot 0 and the run are summed in registers, across groups by
//   shuffles, and added once. An empty ball is one add a channel.
// - out is zeroed on the same stream first. The order of the float adds
//   varies from run to run, inside the band of 1e-5 * max|plain| that
//   chip_smoke.py holds it to.
// What holds it back now is reading g: on an H100 80GB HBM3 it reads 68.7 MB
// at about 1.6 TB/s at B=16, and its atomics cost less (PERF.md). An aligned
// 16-byte load a lane with a shuffle, streaming loads and 16 lanes a slot
// were each no faster than the four 4-byte loads below.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block, a ball a warp
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;      // slots in flight a lane group

// The V channels of one slot row that a lane adds (V = 1 or 4).
template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
  static __device__ __forceinline__ T shfl_xor(T a, int m) {
    return __shfl_xor_sync(0xffffffffu, a, m);
  }
  static __device__ __forceinline__ void red(float* p, T v) { atomicAdd(p, v); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  // g's rows are 3 + C floats, so a lane's four channels are seldom 16-byte
  // aligned: four 4-byte loads, which L1 serves from the same sectors
  static __device__ __forceinline__ T load(const float* p) {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ T shfl_xor(T a, int m) {
    return make_float4(__shfl_xor_sync(0xffffffffu, a.x, m), __shfl_xor_sync(0xffffffffu, a.y, m),
                       __shfl_xor_sync(0xffffffffu, a.z, m), __shfl_xor_sync(0xffffffffu, a.w, m));
  }
  static __device__ __forceinline__ void red(float* p, T v) { red_add4(p, v); }
};

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
    group_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                     float* __restrict__ out, int n, int s, int k, int width, int c0,
                     int wout) {
  using W = Vec<V>;
  constexpr int kGroups = 32 / G;
  const int ball = blockIdx.x * kWarps + threadIdx.x / 32;
  if (ball >= s) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int ch = (blockIdx.y * G + lane % G) * V;  // this lane's first channel
  const bool active = ch < wout;
  const size_t bs = (size_t)blockIdx.z * s + ball;
  const int* ib = idx + bs * k;
  const float* gb = g + bs * k * width + c0 + ch;
  float* ob = out + (size_t)blockIdx.z * n * wout + ch;

  // the run: slots run..k-1 repeat slot 0's point (run = k: no run)
  const int j0 = clamp_index(__ldg(ib), n);
  int run = 1;
  for (int p = (k - 1) & ~31; p >= 0; p -= 32) {
    const bool other = p + lane < k && clamp_index(__ldg(ib + p + lane), n) != j0;
    const unsigned m = __ballot_sync(0xffffffffu, other);
    if (m) {
      run = p + 32 - __clz(m);
      break;
    }
  }

  typename W::T acc = W::zero();
  for (int p = 0; p < k; p += 32) {
    const int jl = p + lane < k ? clamp_index(__ldg(ib + p + lane), n) : 0;
    const int end = min(32, k - p);
    for (int q0 = 0; q0 < end; q0 += kSlots * kGroups) {
      // the loads of all kSlots rows first, then their adds
      typename W::T v[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int q = q0 + u * kGroups + grp;
        v[u] = active && q < end ? W::load(gb + (size_t)(p + q) * width) : W::zero();
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int q = q0 + u * kGroups + grp;
        const int j = __shfl_sync(0xffffffffu, jl, q & 31);
        if (p + q == 0 || p + q >= run)
          W::add(acc, v[u]);
        else if (active && q < end)
          W::red(ob + (size_t)j * wout, v[u]);
      }
    }
  }
#pragma unroll
  for (int m = G; m < 32; m <<= 1) W::add(acc, W::shfl_xor(acc, m));
  if (grp == 0 && active) W::red(ob + (size_t)j0 * wout, acc);
}

template <int G, int V>
void launch(const float* g, const int* idx, float* out, int b, int n, int s, int k,
            int width, int c0, int wout, cudaStream_t st) {
  const dim3 grid((unsigned)((s + kWarps - 1) / kWarps),
                  (unsigned)((wout + G * V - 1) / (G * V)), (unsigned)b);
  group_bwd_kernel<G, V><<<grid, kThreads, 0, st>>>(g, idx, out, n, s, k, width, c0, wout);
}

}  // namespace

// g [B, S, K, width], idx [B, S, K] -> out [B, N, c1 - c0]. `plan` holds the
// integers of a launch, laid out once a shape by the wrapper
// (ops/grouping.py::_group_backward_plan, fields GROUP_BWD_PLAN), which
// checks 0 <= c0 < c1 <= width and 1 <= B <= 65535 (offsets are 64-bit) and
// picks `lanes` (4, 8, 16 or 32) and `vec` (4 where c1 - c0 is a multiple of
// 4, else 1).
PCB_API int pcb_group_backward(const float* g, const int* idx, float* out, const int* plan,
                               int device, void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int width = plan[4];
  const int c0 = plan[5];
  const int c1 = plan[6];
  const int lanes = plan[7];
  const int vec = plan[8];
  cudaStream_t st = (cudaStream_t)stream;
  const int wout = c1 - c0;
  err = cudaMemsetAsync(out, 0, (size_t)b * n * wout * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
#define PCB_GROUP_BWD(GG, VV)                                    \
  if (lanes == GG && vec == VV) {                                \
    launch<GG, VV>(g, idx, out, b, n, s, k, width, c0, wout, st); \
    return (int)cudaGetLastError();                              \
  }
  PCB_GROUP_BWD(4, 1) PCB_GROUP_BWD(8, 1) PCB_GROUP_BWD(16, 1) PCB_GROUP_BWD(32, 1)
  PCB_GROUP_BWD(4, 4) PCB_GROUP_BWD(8, 4) PCB_GROUP_BWD(16, 4) PCB_GROUP_BWD(32, 4)
#undef PCB_GROUP_BWD
  return (int)cudaErrorInvalidValue;
}
