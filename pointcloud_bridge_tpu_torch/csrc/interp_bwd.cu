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
// What bounds it on the H100: bytes. g is read, df written, idx and w read
// (the bound counts each once); there are 2 k flops a g element, far below
// the card's rate. Few sources take many queries (12 a source at SSG's
// fp3, 16 at BriStruNet's), so a scatter of w * g into df adds k times into
// each df element, from many blocks at once. This design reads each g row k
// times (from L2 where g fits), and measured on an H100 its scans and list
// walks, not its bytes, take most of its time.
//
// Design: the owner computes, and no float is added by an atomic. The
// Pallas kernel runs a one-hot [TQ, S]^T x [TQ, D] product on the MXU and
// carries df across its sequential query grid; here a block owns `rows`
// consecutive df rows of one batch element and one chunk of 128 channels,
// and finds its rows' contributions itself: it scans that element's kept
// selection (idx and w as the forward kernel saved them) in ascending (q, t)
// order, a window of 4096 entries at a time, each warp its own eighth of the
// window with all its loads in flight at once, and compacts the entries that
// fall in its rows, with their weights, into shared memory by ballot, so the
// window's list stays in ascending order. Each row is owned by one warp
// (rows r with r % 8 == warp), which adds w * g[q] of its entries in that
// order into the row's accumulator in shared memory (__fmul_rn, then
// __fadd_rn), up to eight g rows loaded before their adds, and writes the
// row once at the end, 16 bytes a lane where D and the pointers allow. A row
// that no query chose is written as zeros, so df needs no memset, and the
// sums are the same bits from call to call: a left fold from 0 in ascending
// (q, t), which tests/test_torch_interp_backward.py emulates. An index
// outside [0, S) matches no block's rows and is never written through. Each
// step of a warp's adds waits on a round trip to memory for g, so the
// weights travel in the list, the windows are large and the next window's
// selection is loaded while this one's rows are added. Every block reads its
// element's selection (8 bytes an entry, from L2 after the first), so the
// wrapper picks the most rows a block (8-64) that still gives each SM a
// block.
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
// shared memory: the accumulators, each warp's slice list of (query << 6 |
// row, weight) pairs for a window, the warps' counts
constexpr int kSmem = kMaxRows * kChunk * 4 + kWarps * kSlice * 8 + kWarps * 4;

// e / k for 1 <= k <= 4 and e < 2^31 without a division: a shift, or for
// k = 3 the high half of e * ceil(2^33 / 3), shifted by one.
__device__ __forceinline__ int div_k(unsigned e, int k) {
  return (int)(k == 3 ? __umulhi(e, 0xAAAAAAABu) >> 1 : e >> (k >> 1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
interp_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ df, int n,
                  int s, int d, int k, int rows, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int2* lists = reinterpret_cast<int2*>(acc + kMaxRows * kChunk);
  int* count = reinterpret_cast<int*>(lists + kWarps * kSlice);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int group = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - group * chunks) * kChunk;
  const int s0 = group * rows;
  const int here = min(rows, s - s0);  // rows of this block
  const int m = n * k;                 // entries of this batch element
  const int* ib = idx + (size_t)b * m;
  const float* wb = w + (size_t)b * m;
  const float* gb = g + (size_t)b * n * d + c0;
  int2* list = lists + warp * kSlice;

  for (int r = warp; r < here; r += kWarps) {
    reinterpret_cast<float4*>(acc + r * kChunk)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

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
  for (unsigned base = 0; base < (unsigned)m; base += kWindow) {
    // 1. the slice's entries of the block's rows, compacted by ballot in
    //    ascending order; then the next window's slice is loaded while this
    //    window's entries are added
    const unsigned e0 = base + warp * kSlice;
    int found = 0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r = key[u] - s0;
      const bool in = (unsigned)r < (unsigned)here;
      const unsigned vote = __ballot_sync(0xffffffffu, in);
      if (in) {
        // (query << 6 | row, weight): N < 2^25 and rows <= 64
        const int q = div_k(e0 + u * 32 + lane, k);
        list[found + __popc(vote & lanes_below(lane))] = make_int2(q << 6 | r,
                                                                   __float_as_int(wk[u]));
      }
      found += __popc(vote);
    }
    if (lane == 0) count[warp] = found;
    __syncthreads();
    if (base + kWindow < (unsigned)m) load_slice(base + kWindow);

    // 2. the window's list is the slices in warp order; each warp adds the
    //    entries of its rows, in that order
    int start[kWarps + 1];
    start[0] = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) start[j + 1] = start[j] + count[j];
    const int total = start[kWarps];
    for (int f0 = 0; f0 < total; f0 += 32) {
      const int f = f0 + lane;
      int2 en = make_int2(-1, 0);
      if (f < total) {
        int j = 0, at = 0;  // the slice that holds list entry f, and its start
#pragma unroll
        for (int t = 1; t < kWarps; ++t) {
          if (f >= start[t]) {
            j = t;
            at = start[t];
          }
        }
        en = lists[j * kSlice + f - at];
      }
      const int row = en.x & (kMaxRows - 1);
      unsigned mine = __ballot_sync(0xffffffffu, en.x >= 0 && (row & (kWarps - 1)) == warp);
      if (!mine) continue;
      const int q = en.x >> 6;
      const float wv = __int_as_float(en.y);
      while (mine) {
        // up to kAhead of this warp's entries: their g rows and weights are
        // all loaded before the first add (the branches are warp-uniform)
        const int ahead = min(__popc(mine), kAhead);
        int src[kAhead], rs[kAhead];
        if (kVec) {
          float4 gv[kAhead];
          const bool live = c0 + 4 * lane < d;
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            if (i < ahead) {
              src[i] = __ffs(mine) - 1;
              mine &= mine - 1;
              rs[i] = __shfl_sync(0xffffffffu, row, src[i]);
              const int qi = __shfl_sync(0xffffffffu, q, src[i]);
              gv[i] = live ? __ldg(reinterpret_cast<const float4*>(gb + (size_t)qi * d) + lane)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            if (i < ahead) {
              const float wt = __shfl_sync(0xffffffffu, wv, src[i]);
              float4* a = reinterpret_cast<float4*>(acc + rs[i] * kChunk) + lane;
              float4 v = *a;
              v.x = __fadd_rn(v.x, __fmul_rn(wt, gv[i].x));
              v.y = __fadd_rn(v.y, __fmul_rn(wt, gv[i].y));
              v.z = __fadd_rn(v.z, __fmul_rn(wt, gv[i].z));
              v.w = __fadd_rn(v.w, __fmul_rn(wt, gv[i].w));
              *a = v;
            }
          }
        } else {
          float gv[kAhead][4];
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            if (i < ahead) {
              src[i] = __ffs(mine) - 1;
              mine &= mine - 1;
              rs[i] = __shfl_sync(0xffffffffu, row, src[i]);
              const int qi = __shfl_sync(0xffffffffu, q, src[i]);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                gv[i][c] = c0 + lane + 32 * c < d ? __ldg(gb + (size_t)qi * d + lane + 32 * c)
                                                  : 0.f;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kAhead; ++i) {
            if (i < ahead) {
              const float wt = __shfl_sync(0xffffffffu, wv, src[i]);
              float* a = acc + rs[i] * kChunk + lane;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                a[32 * c] = __fadd_rn(a[32 * c], __fmul_rn(wt, gv[i][c]));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the next window overwrites the lists
  }

  // 3. each warp writes its rows once
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
        if (c0 + lane + 32 * c < d) {
          out[(size_t)r * d + lane + 32 * c] = acc[r * kChunk + lane + 32 * c];
        }
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
