// K4b variant, measured against csrc/interp_bwd.cu by k4b_probe.py and not
// on the port's main path: the kernel's design with the window's list
// sorted by row in shared memory before the adds, so that each warp walks
// only its own rows' entries and holds a row's sum in registers.
//
// A block owns `rows` df rows of one batch element and a 128-channel chunk,
// and takes that element's kept selection a window of 4096 entries at a
// time, each warp an eighth of the window with all its loads in flight:
//   1. each warp counts its entries a row;
//   2. one warp lays the window's list out by row: the rows of one owner
//      warp (r % 8) together, a row's entries warp by warp;
//   3. each warp writes its entries, with their weights, at its place in
//      their row (__match_any_sync ranks the lanes of one row), so every
//      row's entries lie together in ascending (q, t) order: a stable
//      counting sort of the window by row, in shared memory;
//   4. each warp walks its own rows' part of the list once, eight g rows
//      loaded before their adds, and adds w * g[q] into the row's
//      accumulator (__fmul_rn, then __fadd_rn), held in registers while
//      the row lasts and in shared memory between windows.
// The sums are csrc/interp_bwd.cu's to the bit. It takes the same plan.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 16;                   // 32-entry steps a warp scans a window
constexpr int kSlice = kSteps * 32;          // entries a warp scans a window
constexpr int kWindow = kWarps * kSlice;     // entries a block scans a window
constexpr int kMaxRows = 64;                 // df rows a block
constexpr int kChunk = 128;                  // channels a block
constexpr int kAhead = 8;                    // g rows a warp loads before it adds
// shared memory: the accumulators; a window's list of (query << 6 | row,
// weight) pairs, sorted by row; each warp's count, then cursor, a row; the
// owner warps' ranges of the list
constexpr int kSmem =
    kMaxRows * kChunk * 4 + kWindow * 8 + kWarps * kMaxRows * 4 + (kWarps + 1) * 4;

// A row's place in the list order: the rows of one owner warp (r % 8)
// together, by r / 8.
__device__ __forceinline__ int bucket_of(int r, int per_warp) {
  return (r & (kWarps - 1)) * per_warp + (r >> 3);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
interp_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ df, int n,
                  int s, int d, int k, int rows, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int2* list = reinterpret_cast<int2*>(acc + kMaxRows * kChunk);
  int* cursor = reinterpret_cast<int*>(list + kWindow);  // [kWarps][kMaxRows]
  int* owner = cursor + kWarps * kMaxRows;               // [kWarps + 1]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int group = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - group * chunks) * kChunk;
  const int s0 = group * rows;
  const int here = min(rows, s - s0);  // rows of this block
  const int per_warp = rows / kWarps;  // rows a warp owns
  const int m = n * k;                 // entries of this batch element
  const int* ib = idx + (size_t)b * m;
  const float* wb = w + (size_t)b * m;
  const float* gb = g + (size_t)b * n * d + c0;
  int* mine = cursor + warp * kMaxRows;

  for (int r = warp; r < here; r += kWarps) {
    reinterpret_cast<float4*>(acc + r * kChunk)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < kWarps * kMaxRows; i += kThreads) cursor[i] = 0;

  // this warp's slice of a window, indices and weights, loaded whole: all
  // its loads in flight at once (unsigned entry numbers: a window past
  // m < 2^31 does not overflow)
  int key[kSteps];
  float wk[kSteps];
  auto load_slice = [&](unsigned base) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const unsigned e = base + warp * kSlice + u * 32 + lane;
      key[u] = e < (unsigned)m ? __ldg(ib + e) : -1;
      wk[u] = e < (unsigned)m ? __ldg(wb + e) : 0.f;
    }
  };
  load_slice(0);
  __syncthreads();
  for (unsigned base = 0; base < (unsigned)m; base += kWindow) {
    // 1. this warp's entries a row
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r = key[u] - s0;
      if ((unsigned)r < (unsigned)here) atomicAdd(mine + bucket_of(r, per_warp), 1);
    }
    __syncthreads();

    // 2. the list's layout: each row's start (exclusive scan over the rows
    //    in list order, a lane two rows), each warp's cursor in each row,
    //    and each owner warp's range
    if (warp == 0) {
      int t0 = 0, t1 = 0;  // rows `lane` and `lane + 32` in list order
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        t0 += cursor[v * kMaxRows + lane];
        t1 += cursor[v * kMaxRows + lane + 32];
      }
      int x0 = t0, x1 = t1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y0 = __shfl_up_sync(0xffffffffu, x0, o);
        const int y1 = __shfl_up_sync(0xffffffffu, x1, o);
        if (lane >= o) {
          x0 += y0;
          x1 += y1;
        }
      }
      const int half = __shfl_sync(0xffffffffu, x0, 31);
      const int total = half + __shfl_sync(0xffffffffu, x1, 31);
      int at0 = x0 - t0, at1 = half + x1 - t1;
      const int j = lane * per_warp;  // the first row of owner `lane`
      const int first0 = __shfl_sync(0xffffffffu, at0, j & 31);
      const int first1 = __shfl_sync(0xffffffffu, at1, j & 31);
      if (lane <= kWarps) owner[lane] = j < 32 ? first0 : j < kMaxRows ? first1 : total;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c0v = cursor[v * kMaxRows + lane];
        const int c1v = cursor[v * kMaxRows + lane + 32];
        cursor[v * kMaxRows + lane] = at0;
        cursor[v * kMaxRows + lane + 32] = at1;
        at0 += c0v;
        at1 += c1v;
      }
    }
    __syncthreads();

    // 3. each warp writes its entries at its cursor in their row, in order
    const unsigned e0 = base + warp * kSlice;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r = key[u] - s0;
      const bool in = (unsigned)r < (unsigned)here;
      const unsigned vote = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int bk = bucket_of(r, per_warp);
        const unsigned peers = __match_any_sync(vote, bk);
        // (query << 6 | row, weight): N < 2^25 and rows <= 64
        const int q = (int)((e0 + u * 32 + lane) / (unsigned)k);
        list[mine[bk] + __popc(peers & lanes_below(lane))] =
            make_int2(q << 6 | r, __float_as_int(wk[u]));
        __syncwarp(vote);
        if (lane == __ffs(peers) - 1) mine[bk] += __popc(peers);
      }
      __syncwarp();
    }
    if (base + kWindow < (unsigned)m) load_slice(base + kWindow);
    __syncthreads();

    // 4. this warp's rows, each in ascending (q, t) order; the cursors are
    //    cleared for the next window meanwhile
    for (int i = lane; i < kMaxRows; i += 32) mine[i] = 0;
    const int from = owner[warp], to = owner[warp + 1];
    int cur = -1;  // the row held in registers
    if (kVec) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      const bool live = c0 + 4 * lane < d;
      for (int i0 = from; i0 < to; i0 += kAhead) {
        const int ahead = min(to - i0, kAhead);
        int rs[kAhead];
        float wt[kAhead];
        float4 gv[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          if (i < ahead) {
            const int2 en = list[i0 + i];
            rs[i] = en.x & (kMaxRows - 1);
            wt[i] = __int_as_float(en.y);
            gv[i] = live ? __ldg(reinterpret_cast<const float4*>(gb + (size_t)(en.x >> 6) * d) +
                                 lane)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          if (i < ahead) {
            if (rs[i] != cur) {
              if (cur >= 0) reinterpret_cast<float4*>(acc + cur * kChunk)[lane] = a;
              cur = rs[i];
              a = reinterpret_cast<const float4*>(acc + cur * kChunk)[lane];
            }
            a.x = __fadd_rn(a.x, __fmul_rn(wt[i], gv[i].x));
            a.y = __fadd_rn(a.y, __fmul_rn(wt[i], gv[i].y));
            a.z = __fadd_rn(a.z, __fmul_rn(wt[i], gv[i].z));
            a.w = __fadd_rn(a.w, __fmul_rn(wt[i], gv[i].w));
          }
        }
      }
      if (cur >= 0) reinterpret_cast<float4*>(acc + cur * kChunk)[lane] = a;
    } else {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i0 = from; i0 < to; i0 += kAhead) {
        const int ahead = min(to - i0, kAhead);
        int rs[kAhead];
        float wt[kAhead];
        float gv[kAhead][4];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          if (i < ahead) {
            const int2 en = list[i0 + i];
            rs[i] = en.x & (kMaxRows - 1);
            wt[i] = __int_as_float(en.y);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              gv[i][c] = c0 + lane + 32 * c < d
                             ? __ldg(gb + (size_t)(en.x >> 6) * d + lane + 32 * c)
                             : 0.f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
          if (i < ahead) {
            if (rs[i] != cur) {
              if (cur >= 0) {
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[cur * kChunk + lane + 32 * c] = a[c];
              }
              cur = rs[i];
#pragma unroll
              for (int c = 0; c < 4; ++c) a[c] = acc[cur * kChunk + lane + 32 * c];
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] = __fadd_rn(a[c], __fmul_rn(wt[i], gv[i][c]));
          }
        }
      }
      if (cur >= 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[cur * kChunk + lane + 32 * c] = a[c];
      }
    }
    __syncthreads();  // the next window rewrites the list, counts and ranges
  }

  // each warp writes its rows once
  float* out = df + ((size_t)b * s + s0) * d + c0;
  for (int r = warp; r < here; r += kWarps) {
    if (kVec) {
      if (c0 + 4 * lane < d) {
        reinterpret_cast<float4*>(out + (size_t)r * d)[lane] =
            reinterpret_cast<const float4*>(acc + r * kChunk)[lane];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c0 + lane + 32 * c < d) out[(size_t)r * d + lane + 32 * c] = acc[r * kChunk + lane + 32 * c];
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* g, const int* idx, const float* w, float* df, int b, int n,
                   int s, int d, int k, int rows, int device, cudaStream_t st) {
  // opt in once a device to more than 48 KB of shared memory
  static unsigned opted = 0;
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (!((opted >> device) & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        interp_bwd_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted |= 1u << device;
  }
  const int chunks = (d + kChunk - 1) / kChunk;
  const dim3 grid(((s + rows - 1) / rows) * chunks, b);
  interp_bwd_kernel<kVec><<<grid, kThreads, kSmem, st>>>(g, idx, w, df, n, s, d, k, rows, chunks);
  return cudaGetLastError();
}

}  // namespace

// g [B, N, D], idx [B, N, k] int32, w [B, N, k] -> df [B, S, D], with the
// integers of ops/interpolate.py INTERP_BWD_PLAN: B, N, S, D, k, the df rows
// a block (a multiple of 8, at most 64) and whether g and df take 16-byte
// accesses (D a multiple of 4, both pointers 16-byte aligned).
PCB_API int pcb_interpolate_backward(const float* g, const int* idx,
                                     const float* w, float* df,
                                     const int* plan, int device,
                                     void* stream) {
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
  err = vec ? launch<true>(g, idx, w, df, b, n, s, d, k, rows, device, st)
            : launch<false>(g, idx, w, df, b, n, s, d, k, rows, device, st);
  return (int)err;
}
