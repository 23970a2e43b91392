// K7's staged route, measured and kept out of the port: a block
// holds a batch element's slice of 8 (or 4) channels of y in shared memory
// (cp.async), a lane a channel and 32 / slice rows a warp, each lane folding
// its row's slots from shared memory in slot order. It gives K7's bits
// (csrc/edge_reduce.cu) and lost to K7's rows route at every DGCNN shape
// (PERF.md): K7 is bound by its instructions a slot and channel, not
// by L2, so reading y from shared memory saves nothing it pays for. The
// probe k7_probe.py builds it and times it beside K7 (chip_smoke.py --edge
// probes). Not on any path of the port.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kStagedThreads = 1024;  // a staged block

// One slot's value a of a channel into the running max and min, their
// ties, and the sums: NaN sticks (once hi is NaN no comparison replaces
// it); a larger value restarts the tie count, an equal one adds to it.
template <bool kMoments, bool kTies>
__device__ __forceinline__ void fold_value(float a, float& hi, float& lo, float& sum, float& sq,
                                           int& nx, int& nn) {
  const bool up = a > hi || a != a;
  const bool down = a < lo || a != a;
  if (kTies) {
    nx = up ? 1 : nx + (a == hi);
    nn = down ? 1 : nn + (a == lo);
  }
  hi = up ? a : hi;
  lo = down ? a : lo;
  if (kMoments) {
    sum = __fadd_rn(sum, a);
    sq = __fadd_rn(sq, __fmul_rn(a, a));
  }
}

// ------------------------------------------------------ the staged route

// `bytes` from device to shared memory without passing through registers
// (cp.async, compute capability 8.0 and up); both addresses aligned to it
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
               : "memory");
}

// L lanes a row (the L channels c0.. of a slice, one a lane), 32 / L rows a
// warp: lanes l of the row's group load slot j0 + l's index, a shuffle
// hands each lane the slot's point, and the lane reads its channel of that
// point's row from shared memory (ys [n][L]), slot after slot.
template <int L, int V, bool kMoments, bool kTies>
__global__ void __launch_bounds__(kStagedThreads)
    edge_reduce_staged(const float* __restrict__ y, const int* __restrict__ idx,
                       float* __restrict__ mx, float* __restrict__ mn, float* __restrict__ s1,
                       float* __restrict__ s2, int* __restrict__ ties, int n, int s, int k, int f,
                       int rows_a_block, float inv_k) {
  extern __shared__ float ys[];  // [n][L]: this batch element's slice of y
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * L;
  const int width = min(L, f - c0);
  // the slice, V floats a copy (channels past F as 0)
  const float* yb = y + (size_t)b * n * f + c0;
  for (int e = threadIdx.x; e < n * (L / V); e += kStagedThreads) {
    const int p = e / (L / V);
    const int q = (e - p * (L / V)) * V;
    if (q < width) {
      cp_async<4 * V>(ys + p * L + q, yb + (size_t)p * f + q);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) ys[p * L + q + u] = 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  constexpr int kRows = 32 / L;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;  // this lane's channel, and the slot it loads
  const int group = lane / L;  // this lane's row in the warp's kRows
  const bool active = sub < width;
  const float inf = __int_as_float(0x7f800000);
  const int r_end = min(s, ((int)blockIdx.x + 1) * rows_a_block);
  const int step = kStagedThreads / 32 * kRows;
  for (int r0 = (int)blockIdx.x * rows_a_block + (int)(threadIdx.x >> 5) * kRows; r0 < r_end;
       r0 += step) {
    const int r = r0 + group;
    const bool live = r < r_end;
    const int* ir = idx + ((size_t)b * s + (live ? r : r0)) * k;
    float hi = -inf, lo = inf, sum = 0.0f, sq = 0.0f;
    int nx = 0, nn = 0;
    for (int j0 = 0; j0 < k; j0 += L) {
      const int mine = live && j0 + sub < k ? clamp_index(__ldg(ir + j0 + sub), n) : 0;
      const int m = min(L, k - j0);
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (u >= m) break;  // uniform across the warp
        const int p = __shfl_sync(0xffffffffu, mine, group * L + u);
        fold_value<kMoments, kTies>(ys[p * L + sub], hi, lo, sum, sq, nx, nn);
      }
    }
    if (!live || !active) continue;
    const size_t at = ((size_t)b * s + r) * f + c0 + sub;
    mx[at] = hi;
    mn[at] = lo;
    if (kMoments) {
      s1[at] = __fmul_rn(sum, inv_k);
      s2[at] = __fmul_rn(sq, inv_k);
    }
    if (kTies) ties[at] = (int)((unsigned)nx | (unsigned)nn << 16);
  }
}

template <int L, int V>
cudaError_t launch_staged(const float* y, const int* idx, float* mx, float* mn, float* s1,
                          float* s2, int* ties, int b, int n, int s, int k, int f, bool moments,
                          int rows_a_block, float inv_k, cudaStream_t st) {
  const size_t smem = (size_t)n * L * sizeof(float);
  const dim3 grid((unsigned)((s + rows_a_block - 1) / rows_a_block), (unsigned)((f + L - 1) / L),
                  (unsigned)b);
#define PCB_STAGED(M, T)                                                                      \
  {                                                                                           \
    auto kernel = edge_reduce_staged<L, V, M, T>;                                             \
    if (smem > 48 * 1024) {                                                                   \
      const cudaError_t err = cudaFuncSetAttribute(                                           \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);                    \
      if (err != cudaSuccess) return err;                                                     \
    }                                                                                         \
    kernel<<<grid, kStagedThreads, smem, st>>>(y, idx, mx, mn, s1, s2, ties, n, s, k, f,      \
                                               rows_a_block, inv_k);                          \
  }
  if (moments) {
    if (ties) PCB_STAGED(true, true) else PCB_STAGED(true, false)
  } else {
    if (ties) PCB_STAGED(false, true) else PCB_STAGED(false, false)
  }
#undef PCB_STAGED
  return cudaGetLastError();
}

}  // namespace

// As pcb_edge_reduce, with `plan` b, n, s, k, f, vec (the floats a copy of y
// moves), moments, slice (8 or 4 channels a block), rows_a_block, and
// inv_k's float32 bits.
PCB_API int pcb_edge_reduce_staged(const float* y, const int* idx, float* mx, float* mn,
                                   float* s1, float* s2, int* ties, const int* plan, int device,
                                   void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = plan[0], n = plan[1], s = plan[2], k = plan[3], f = plan[4], vec = plan[5];
  const int moments = plan[6], slice = plan[7], rows_a_block = plan[8];
  float inv_k;
  std::memcpy(&inv_k, plan + 9, sizeof(float));
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_SLICE(L, V)                                                                      \
  if (slice == L && vec == V)                                                                \
    return (int)launch_staged<L, V>(y, idx, mx, mn, s1, s2, ties, b, n, s, k, f, moments,    \
                                    rows_a_block, inv_k, st);
  PCB_SLICE(8, 4) PCB_SLICE(8, 2) PCB_SLICE(8, 1) PCB_SLICE(4, 4) PCB_SLICE(4, 2) PCB_SLICE(4, 1)
#undef PCB_SLICE
  return (int)cudaErrorInvalidValue;
}
