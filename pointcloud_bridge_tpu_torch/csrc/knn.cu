// K5: exact k nearest neighbours, nearest first.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/knnset.py,
// _knnset_kernel (called by _knnset_call; entry topk_set_from_buffer), and
// with it the lax.approx_max_k candidate buffer that kernel selects from
// (ops/grouping.py::knn_set). The buffer exists only because the TPU has a
// hardware approximate top-k; here one kernel goes from the coordinates to
// the exact k-NN, which is what ops.knn / knn_with_distance / knn_set
// compute on the exact path.
//
// Semantics: for each query the k points with the smallest squared
// distance (dx*dx + dy*dy) + dz*dz, ascending; equal distances go to the
// lower index (lax.top_k on -d, a stable sort). Outputs idx [B, S, k] int32
// and d2 [B, S, k] float32, bit-identical to ops/grouping.py::knn_plain.
//
// What bounds it on the H100: operations. B*S*N distances, each 8 rounded
// operations and a compare (67 M pairs at B=4, N=S=4096) against under 5 MB
// moved, and the shared-memory load of each point (a float4 for 32 lanes is
// 512 bytes, four cycles of an SM's 128 bytes a cycle); then the selection
// of the k least among the candidates.
//
// Design: a warp a query, `warps` warps a block (the wrapper's plan,
// ops/grouping.py::neighbour_launch, picks them by the number of queries).
// - The block stages the row in dynamic shared memory as float4 points with
//   cp.async (common.cuh stage_points): the whole row at once where it fits
//   (one barrier), else a ring of two tiles, the next one in flight while
//   the warps scan this one (one barrier a tile).
// - A point's key is (distance bits, index) as one 64-bit integer: a
//   distance >= 0 orders like its uint32 bits, so the integer order is the
//   (distance, index) order, a total order.
// - The warp keeps the R*32 least keys so far (R = 1 for k <= 32, 2 for
//   k <= 64), sorted, position p in lane p % 32, register p / 32.
// - A step of 32 points is a distance a lane. A point is a candidate if its
//   distance bits are below those of the k-th key: points come in index
//   order, so a later point at the k-th's distance is behind it anyway.
//   Candidates are appended to a 64-slot buffer in shared memory
//   by ballot compaction (no serial insertion). kUnroll steps share one
//   __any_sync, so a run of steps with no candidate costs one vote.
// - When the buffer holds 32, they are merged into the list with no
//   divergence: a bitonic sort of the 32 across the lanes (15 shuffle
//   stages), then the list's last register against the sorted candidates
//   reversed (the elementwise min of an ascending and a descending run is
//   bitonic and keeps the least of both), a stride-32 exchange within the
//   lane where R = 2, and a bitonic merge (5 stages a register). The k-th
//   key is read back with one shuffle. What is left in the buffer is merged
//   at the end.
// The k-th only falls, and it is always the k-th of a subset of the points
// seen, so a point it rejects has k better points: the list's first k are
// exact. NaN distances (and the NaN pads of a staged tile) never enter. The
// wrapper requires 1 <= k <= min(64, N), so with finite coordinates every
// slot is filled. The point width C is a template parameter; only C = 3 is
// wired. Measured and not kept (PERF.md, PR 9): 2 or 4 queries a warp
// sharing each point's load (slower: the merges of a warp's queries queue
// up behind each other); 2 or 8 steps between votes and 12-byte point loads
// (no faster).
#include "common.cuh"

namespace {

using Key = unsigned long long;
constexpr int kUnroll = 4;      // steps of 32 points between two votes
constexpr int kGroup = 32 * kUnroll;
constexpr int kBuf = 64;        // candidate slots a warp
constexpr int kRowMax = 8192;   // ops/grouping.py STAGE_ROW_MAX
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
// above +inf (0x7f800000) and below every NaN the card computes
// (0x7fffffff): the bound of an empty list
constexpr unsigned kNoBound = 0x7f800001u;
constexpr Key kEmpty = ((Key)kNoBound << 32) | 0xffffffffu;

// One compare-exchange of a bitonic network: the lower key where keep_min.
__device__ __forceinline__ Key exchange(Key v, int stride, bool keep_min) {
  const Key o = __shfl_xor_sync(kFull, v, stride);
  return (o < v) == keep_min ? o : v;
}

// 32 keys, one a lane, into ascending lane order.
__device__ __forceinline__ Key warp_sort(Key v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool ascending = (lane & size) == 0;  // every lane at size 32
      v = exchange(v, stride, ((lane & stride) == 0) == ascending);
    }
  }
  return v;
}

// A bitonic run over the 32 lanes into ascending order.
__device__ __forceinline__ Key warp_merge(Key v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    v = exchange(v, stride, (lane & stride) == 0);
  }
  return v;
}

// list <- the R*32 least of list (ascending) and the 32 candidates c.
template <int R>
__device__ __forceinline__ void merge(Key (&list)[R], Key c, int lane) {
  c = warp_sort(c, lane);
  const Key rev = __shfl_sync(kFull, c, 31 - lane);
  list[R - 1] = rev < list[R - 1] ? rev : list[R - 1];
  if (R == 2) {
    const Key lo = list[0] < list[1] ? list[0] : list[1];
    list[1] = list[0] < list[1] ? list[1] : list[0];
    list[0] = lo;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) list[r] = warp_merge(list[r], lane);
}

// Distance bits of the k-th key.
template <int R>
__device__ __forceinline__ unsigned kth_bits(const Key (&list)[R], int k) {
  const Key at = (R == 2 && k > 32) ? list[R - 1] : list[0];
  return (unsigned)(__shfl_sync(kFull, at, (k - 1) & 31) >> 32);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int R, int C>
__global__ void __launch_bounds__(1024)
    knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
               int* __restrict__ idx_out, float* __restrict__ d2_out, int n,
               int s, int k, int tile) {
  static_assert(C == 3, "only 3-D points are wired (ops/grouping.py::knn_cuda)");
  static_assert(R == 1 || R == 2, "k <= 64");
  extern __shared__ __align__(16) unsigned char smem[];
  const int padded = round_up(tile, kGroup);
  const int ring = tile < n ? 2 : 1;
  float4* tiles = reinterpret_cast<float4*>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Key* buf = reinterpret_cast<Key*>(tiles + ring * padded) + warp * kBuf;
  const int b = blockIdx.y;
  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  const bool active = q < s;  // uniform over the warp
  const float* row = xyz + (size_t)b * n * C;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* c = query + ((size_t)b * s + q) * C;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }
  Key list[R];
#pragma unroll
  for (int r = 0; r < R; ++r) list[r] = kEmpty;
  unsigned bound = kNoBound;  // distance bits of the k-th key
  int count = 0;              // candidates in buf, the same in every lane

  const int tiles_n = (n + tile - 1) / tile;
  {
    const int lim = min(tile, n);
    stage_points(tiles, row, lim, round_up(lim, kGroup));
  }
  for (int j = 0; j < tiles_n; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    const int base = j * tile;
    const int lim = min(tile, n - base);
    if (j + 1 < tiles_n) {
      const int next = min(tile, n - base - tile);
      stage_points(tiles + ((j + 1) & 1) * padded, row + (size_t)(base + tile) * C,
                   next, round_up(next, kGroup));
    }
    if (!active) continue;
    const float4* pts = tiles + (j & 1) * padded;
    for (int t0 = 0; t0 < lim; t0 += kGroup) {
      unsigned bits[kUnroll];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 p = pts[t0 + u * 32 + lane];
        bits[u] = __float_as_uint(sq_dist3(qx, qy, qz, p.x, p.y, p.z));
        any |= bits[u] < bound;
      }
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool hit = bits[u] < bound;
        const unsigned m = __ballot_sync(kFull, hit);
        if (m == 0u) continue;
        if (hit) {
          buf[count + __popc(m & lanes_below(lane))] =
              ((Key)bits[u] << 32) | (unsigned)(base + t0 + u * 32 + lane);
        }
        count += __popc(m);
        if (count >= 32) {
          __syncwarp();
          count -= 32;
          merge<R>(list, buf[count + lane], lane);
          bound = kth_bits<R>(list, k);
          __syncwarp();  // read before the next appends overwrite
        }
      }
    }
  }
  if (!active) return;
  if (count > 0) {
    __syncwarp();
    merge<R>(list, lane < count ? buf[lane] : kEmpty, lane);
  }
  const size_t out = ((size_t)b * s + q) * k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < k) {
      const bool filled = (unsigned)list[r] != 0xffffffffu;
      idx_out[out + p] = filled ? (int)(unsigned)list[r] : 0;
      d2_out[out + p] = filled ? __uint_as_float((unsigned)(list[r] >> 32))
                               : __int_as_float(0x7f800000);
    }
  }
}

template <int R>
cudaError_t launch_knn(const float* xyz, const float* query, int* idx_out,
                       float* d2_out, int b, int n, int s, int k, int warps,
                       int tile, int device, cudaStream_t stream) {
  const int ring = tile < n ? 2 : 1;
  const size_t smem = (size_t)ring * round_up(tile, kGroup) * sizeof(float4) +
                      (size_t)warps * kBuf * sizeof(Key);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // opt in once a device, to the most a block may have; a refusal raises
    static unsigned opted = 0;
    if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
    if (!((opted >> device) & 1u)) {
      const cudaError_t err = cudaFuncSetAttribute(
          knn_kernel<R, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      opted |= 1u << device;
    }
  }
  const dim3 grid((s + warps - 1) / warps, b);
  knn_kernel<R, 3><<<grid, warps * 32, smem, stream>>>(xyz, query, idx_out, d2_out,
                                                       n, s, k, tile);
  return cudaGetLastError();
}

}  // namespace

// plan (ops/grouping.py KNN_PLAN): B, N, S, k, warps a block, points a
// staged tile (N for the whole row, else a ring of two). The wrapper keeps
// 1 <= k <= min(64, N), B <= 65535, warps in {4, 8, 16, 32} and a tile of
// N <= STAGE_ROW_MAX or STAGE_TILE.
PCB_API int pcb_knn(const float* xyz, const float* query, int* idx_out,
                    float* d2_out, const int* plan, int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int warps = plan[4];
  const int tile = plan[5];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 64 || k > n || warps < 1 || warps > 32 || tile < 1 ||
      (tile < n && tile > kRowMax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = k > 32 ? launch_knn<2>(xyz, query, idx_out, d2_out, b, n, s, k, warps, tile, device, st)
               : launch_knn<1>(xyz, query, idx_out, d2_out, b, n, s, k, warps, tile, device, st);
  return (int)err;
}
