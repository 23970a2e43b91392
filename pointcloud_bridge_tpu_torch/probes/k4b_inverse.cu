// K4b variant, measured against csrc/interp_bwd.cu by k4b_probe.py and not
// on the port's main path: the inverse of the kept selection built once a
// batch element, then the sums by owner warps.
//
//   1. inverse_kernel, a block of 1024 threads a batch element: counts each
//      source row's entries in shared memory, scans the counts into each
//      row's offset, and places every entry number e = q * k + t of the
//      row at its offset (shared-memory atomics: a row's entries land in no
//      fixed order), into scratch the caller allocates;
//   2. sum_kernel, a warp a (row, 128 channels): sorts the row's entries
//      ascending (a bitonic network across the warp where they are at most
//      32, else the next smallest found by a warp minimum each time), loads
//      eight g rows and their weights at a time, adds w * g in that order in
//      registers (__fmul_rn, then __fadd_rn) and writes the row once.
// The sums are csrc/interp_bwd.cu's to the bit. It takes the kernel's plan
// (B, N, S, D, k, rows unused, vec) and scratch of B * (N * k + S + 1) ints.
#include "common.cuh"

namespace {

constexpr int kInverseThreads = 1024;
constexpr int kSumWarps = 8;
constexpr int kChunk = 128;
constexpr int kAhead = 8;

__device__ __forceinline__ int div_k(unsigned e, int k) {
  return (int)(k == 3 ? __umulhi(e, 0xAAAAAAABu) >> 1 : e >> (k >> 1));
}

__global__ void __launch_bounds__(kInverseThreads)
inverse_kernel(const int* __restrict__ idx, int* __restrict__ list, int* __restrict__ offsets,
               int m, int s) {
  extern __shared__ int cnt[];  // s + 1
  __shared__ int warp_sum[kInverseThreads / 32];
  const int b = blockIdx.x;
  const int* ib = idx + (size_t)b * m;
  for (int i = threadIdx.x; i <= s; i += kInverseThreads) cnt[i] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += kInverseThreads) {
    const int key = __ldg(ib + e);
    if ((unsigned)key < (unsigned)s) atomicAdd(cnt + key, 1);
  }
  __syncthreads();
  // exclusive scan of cnt[0, s): a thread a run of consecutive rows
  const int per = (s + kInverseThreads - 1) / kInverseThreads;
  const int lo = min(s, threadIdx.x * per), hi = min(s, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += cnt[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sum[lane] = v;  // inclusive
  }
  __syncthreads();
  int run = x - local + (warp ? warp_sum[warp - 1] : 0);
  int* ob = offsets + (size_t)b * (s + 1);
  for (int i = lo; i < hi; ++i) {
    const int c = cnt[i];
    cnt[i] = run;
    ob[i] = run;
    run += c;
  }
  if (threadIdx.x == kInverseThreads - 1) ob[s] = warp_sum[31];
  __syncthreads();
  int* lb = list + (size_t)b * m;
  for (int e = threadIdx.x; e < m; e += kInverseThreads) {
    const int key = __ldg(ib + e);
    if ((unsigned)key < (unsigned)s) lb[atomicAdd(cnt + key, 1)] = e;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_kernel(const float* __restrict__ g, const float* __restrict__ w,
           const int* __restrict__ list, const int* __restrict__ offsets, float* __restrict__ df,
           int b_, int n, int s, int d, int k, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long job = (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (job >= (long long)b_ * s * chunks) return;
  const int chunk = (int)(job % chunks);
  const int row = (int)((job / chunks) % s);
  const int b = (int)(job / ((long long)chunks * s));
  const int m = n * k;
  const int c0 = chunk * kChunk;
  const int* ob = offsets + (size_t)b * (s + 1);
  const int from = __ldg(ob + row), len = __ldg(ob + row + 1) - from;
  const int* lst = list + (size_t)b * m + from;
  const float* gb = g + (size_t)b * n * d + c0;
  const float* wb = w + (size_t)b * m;
  float a[4] = {0.f, 0.f, 0.f, 0.f};

  auto add = [&](const int* es, int count) {  // es: warp-uniform entry numbers
    float gv[kAhead][4];
    float wt[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < count) {
        const int q = div_k(es[i], k);
        wt[i] = __ldg(wb + es[i]);
        if (kVec) {
          const float4 v = c0 + 4 * lane < d
                               ? __ldg(reinterpret_cast<const float4*>(gb + (size_t)q * d) + lane)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          gv[i][0] = v.x;
          gv[i][1] = v.y;
          gv[i][2] = v.z;
          gv[i][3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            gv[i][c] = c0 + lane + 32 * c < d ? __ldg(gb + (size_t)q * d + lane + 32 * c) : 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < count) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] = __fadd_rn(a[c], __fmul_rn(wt[i], gv[i][c]));
      }
    }
  };

  if (len <= 32) {
    unsigned e = lane < len ? (unsigned)__ldg(lst + lane) : 0xffffffffu;
    // bitonic sort across the warp, ascending by lane
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned other = __shfl_xor_sync(0xffffffffu, e, stride);
        const bool up = ((lane & size) == 0);
        const bool lower = (lane & stride) == 0;
        e = (lower == up) ? min(e, other) : max(e, other);
      }
    }
    for (int i0 = 0; i0 < len; i0 += kAhead) {
      int es[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) es[i] = (int)__shfl_sync(0xffffffffu, e, min(i0 + i, 31));
      add(es, min(kAhead, len - i0));
    }
  } else {
    // the next smallest entry number, a warp minimum at a time
    unsigned last = 0;
    for (int i = 0; i < len; ++i) {
      unsigned best = 0xffffffffu;
      for (int j = lane; j < len; j += 32) {
        const unsigned v = (unsigned)__ldg(lst + j);
        if ((i == 0 || v > last) && v < best) best = v;
      }
      best = __reduce_min_sync(0xffffffffu, best);
      int es[kAhead];
      es[0] = (int)best;
      add(es, 1);
      last = best;
    }
  }

  float* out = df + ((size_t)b * s + row) * d + c0;
  if (kVec) {
    if (c0 + 4 * lane < d) reinterpret_cast<float4*>(out)[lane] = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c0 + lane + 32 * c < d) out[lane + 32 * c] = a[c];
    }
  }
}

}  // namespace

PCB_API int pcb_k4b_inverse(const float* g, const int* idx, const float* w, float* df,
                            int* scratch, const int* plan, int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int d = plan[3];
  const int k = plan[4];
  const int vec = plan[6];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int m = n * k;
  int* list = scratch;
  int* offsets = scratch + (size_t)b * m;
  const size_t smem = (size_t)(s + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  inverse_kernel<<<b, kInverseThreads, smem, st>>>(idx, list, offsets, m, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (d + kChunk - 1) / kChunk;
  const long long jobs = (long long)b * s * chunks;
  const int blocks = (int)((jobs + kSumWarps - 1) / kSumWarps);
  if (vec) {
    sum_kernel<true><<<blocks, kSumWarps * 32, 0, st>>>(g, w, list, offsets, df, b, n, s, d, k,
                                                        chunks);
  } else {
    sum_kernel<false><<<blocks, kSumWarps * 32, 0, st>>>(g, w, list, offsets, df, b, n, s, d, k,
                                                         chunks);
  }
  return (int)cudaGetLastError();
}
