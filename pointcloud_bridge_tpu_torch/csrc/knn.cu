// K5 and K5c: exact k nearest neighbours, nearest first, of 3-D points (K5)
// and of points of any width C (K5c, DGCNN's feature-space graphs).
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
// slot is filled. This kernel takes 3-D points; K5c below (pcb_knn_c) takes
// points of any width with the same selection. Measured and not kept
// (PERF.md, PR 9): 2 or 4 queries a warp
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

// The k-th key's bound, the candidates in the warp's buffer and the sorted
// list: the selection state of one query, the same in every lane but list.
template <int R>
struct Selection {
  Key list[R];
  unsigned bound;  // distance bits of the k-th key
  int count;       // candidates in buf

  __device__ __forceinline__ Selection() : bound(kNoBound), count(0) {
#pragma unroll
    for (int r = 0; r < R; ++r) list[r] = kEmpty;
  }

  // Offer a group of kUnroll steps: bits[u] is the distance of point
  // first + u * 32 + lane. Candidates go to buf by ballot compaction, 32 at a
  // time into the list. The whole warp calls it.
  __device__ __forceinline__ void offer(const unsigned (&bits)[kUnroll], int first,
                                        Key* buf, int k, int lane) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) any |= bits[u] < bound;
    if (!__any_sync(kFull, any)) return;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool hit = bits[u] < bound;
      const unsigned m = __ballot_sync(kFull, hit);
      if (m == 0u) continue;
      if (hit) {
        buf[count + __popc(m & lanes_below(lane))] =
            ((Key)bits[u] << 32) | (unsigned)(first + u * 32 + lane);
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

  // Merge what is left in buf and write the k nearest of query row `out`.
  __device__ __forceinline__ void finish(const Key* buf, int k, int lane, size_t out,
                                         int* __restrict__ idx_out,
                                         float* __restrict__ d2_out) {
    if (count > 0) {
      __syncwarp();
      merge<R>(list, lane < count ? buf[lane] : kEmpty, lane);
    }
    out *= k;
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
};

template <int R>
__global__ void __launch_bounds__(1024)
    knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
               int* __restrict__ idx_out, float* __restrict__ d2_out, int n,
               int s, int k, int tile) {
  constexpr int C = 3;  // 3-D points; knn_c_kernel takes any width
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
  Selection<R> sel;

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
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 p = pts[t0 + u * 32 + lane];
        bits[u] = __float_as_uint(sq_dist3(qx, qy, qz, p.x, p.y, p.z));
      }
      sel.offer(bits, base + t0, buf, k, lane);
    }
  }
  if (!active) return;
  sel.finish(buf, k, lane, (size_t)b * s + q, idx_out, d2_out);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once a
// device: `opted` is the caller's own bit mask of devices.
// With `most_shared`, also prefer the largest shared-memory carveout, so that
// two blocks that fit an SM together are not held to one by a smaller one.
template <typename F>
cudaError_t opt_in_smem(F* kernel, size_t smem, int device, unsigned& opted,
                        bool most_shared = false) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024 && !most_shared) return cudaSuccess;
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (!((opted >> device) & 1u)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && most_shared)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted |= 1u << device;
  }
  return cudaSuccess;
}

template <int R>
cudaError_t launch_knn(const float* xyz, const float* query, int* idx_out,
                       float* d2_out, int b, int n, int s, int k, int warps,
                       int tile, int device, cudaStream_t stream) {
  const int ring = tile < n ? 2 : 1;
  const size_t smem = (size_t)ring * round_up(tile, kGroup) * sizeof(float4) +
                      (size_t)warps * kBuf * sizeof(Key);
  static unsigned opted = 0;
  const cudaError_t err = opt_in_smem(knn_kernel<R>, smem, device, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + warps - 1) / warps, b);
  knn_kernel<R><<<grid, warps * 32, smem, stream>>>(xyz, query, idx_out, d2_out, n, s, k,
                                                    tile);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5c: the same k nearest over points of C channels (DGCNN's EdgeConv builds
// its graph over 64-channel features). The selection is K5's (Selection, one
// state a query); what changes is the staging, since a 64-channel point is
// 256 bytes and a row of 4096 no longer fits shared memory, and the scan,
// which takes several queries a warp.
//
// Distance: the left fold d0*d0, then + dc*dc for c = 1 .. C-1 with dc =
// q_c - p_c, every operation rounded on its own, which is what
// ops/core.py::pairwise_sq_dist computes: idx and d2 are the same bits as
// knn_plain's. (C = 3 goes to knn_kernel, whose association is the same.)
//
// What bounds it on the H100: operations, 3C - 1 rounded float32 operations
// and a compare a pair (0.39 ms of issue at B=4, N=S=4096, C=64 over 128
// lanes x 132 SMs at 1.98 GHz). The bytes in and out (4.2 MB there) do not
// bound it. Beside the arithmetic stand the shared-memory reads: a lane
// reads every channel of its point, C * 4 bytes a pair, and an SM reads 128
// bytes a cycle. With one query a warp (the first design, Q = 1 below) a
// group of four channels costs 17 cycles of shared memory (four 512-byte
// point loads and a broadcast) against 12 of arithmetic, so the loads bound
// the scan.
//
// Design: Q queries a warp (1 or 2: the plan's `queries`), Q
// consecutive queries of one row, `warps` warps a block; lanes over points,
// kUnroll points a lane. For each group of four channels a lane loads each of
// its points once, each of the Q queries' four channels as a broadcast, and
// updates Q x kUnroll sums, so one point load feeds Q queries: 16 + Q
// cycles of shared memory against 12Q of arithmetic. A pair's sum never
// mixes with another's, so every distance keeps its bits. Each query has its
// own Selection and its own kBuf candidate slots, and sees the points in
// index order as before, so its candidates and merges are exactly those of
// a warp a query; one vote over all Q queries skips a group that offers a
// candidate to none of them. A warp past the last query does no scan; a
// warp with fewer than Q queries left scans zeros for the missing ones and
// writes nothing for them.
// - The block stages the row through a ring of two tiles (the whole row
//   where it fits) with cp.async, channel-major, so that the 32 lanes' reads
//   of one channel of 32 neighbouring points are 32 consecutive words, free
//   of bank conflicts:
//   - VEC (C a multiple of 4, 16-byte aligned rows): [C/4][tile] float4s, one
//     16-byte load a lane for four channels; staged 16 bytes a copy, eight
//     points a channel group at a time, so that a warp's copies read whole
//     sectors and write whole 128-byte rows of shared memory;
//   - otherwise [C][tile] floats, 4 bytes a copy.
// - The queries' C values sit in shared memory, Q slices a warp, read 4
//   bytes at a time from device memory (no alignment asked of them).
// CC = 64, the width the models use, is compiled with the channel loop
// unrolled; CC = 0 reads C from the plan. The wrapper
// (ops/grouping.py::knn_c_cuda) picks warps, Q and the tile by shape so that
// the ring, the queries and the candidate slots fit 227 KB, and refuses what
// does not fit.
// Measured (PERF.md §6, DGCNN's four shapes): 32 warps of Q = 2 with
// 256-point tiles is the fastest launch, 21-24% under a warp a query; the
// warps an SM keep the scan fed more than Q does, so Q = 4 and Q = 8
// (probes/k2_k5_probe.py compiles them: 16 or 8 warps a block, or 32 and 16
// held to 64 registers a thread) were slower, as were 128-point tiles for
// two blocks an SM, the channel loop unrolled 8 or fully, and an exact early
// exit every 16 channels (no group left early on DGCNN's features).

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Points [0, count) of `pts` (C channels each) into `dst` channel-major with
// row stride `padded`, NaN in slots [count, padded): their distance is NaN,
// never a candidate. The caller waits and synchronises before reading.
template <bool VEC>
__device__ __forceinline__ void stage_channels(float* dst, const float* pts, int c,
                                               int count, int padded) {
  const float nan = __int_as_float(0x7fffffff);
  if (VEC) {
    const int c4 = c >> 2;
    const int total = round_up(count, 8) * c4;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int rest = i >> 3;
      const int g = rest % c4;
      const int p = (rest / c4) * 8 + (i & 7);
      if (p < count) cp_async_16(dst + ((size_t)g * padded + p) * 4, pts + (size_t)p * c + g * 4);
    }
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int pad = padded - count;
    for (int i = threadIdx.x; i < pad * c4; i += blockDim.x) {
      d4[(i / pad) * padded + count + i % pad] = make_float4(nan, nan, nan, nan);
    }
  } else {
    const int total = round_up(count, 32) * c;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int rest = i >> 5;
      const int ch = rest % c;
      const int p = (rest / c) * 32 + (i & 31);
      if (p < count) cp_async_f32(dst + (size_t)ch * padded + p, pts + (size_t)p * c + ch);
    }
    const int pad = padded - count;
    for (int i = threadIdx.x; i < pad * c; i += blockDim.x) {
      dst[(size_t)(i / pad) * padded + count + i % pad] = nan;
    }
  }
}

__device__ __forceinline__ float sq_add(float acc, float q, float p) {
  const float d = __fsub_rn(q, p);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

// acc + the four channels of p against q, in channel order.
__device__ __forceinline__ float sq_add4(float acc, const float4& q, const float4& p) {
  acc = sq_add(acc, q.x, p.x);
  acc = sq_add(acc, q.y, p.y);
  acc = sq_add(acc, q.z, p.z);
  return sq_add(acc, q.w, p.w);
}

// Shared memory of K5c, in bytes: the ring, the warps' Q queries each
// (rounded to 16 bytes) and their candidate slots. ops/grouping.py::knn_c_smem
// mirrors it.
__host__ __device__ constexpr size_t knn_c_smem(int c, int tile, int ring, int warps,
                                                int queries) {
  return (size_t)ring * c * round_up(tile, kGroup) * 4 +
         (size_t)round_up(warps * queries * c * 4, 16) +
         (size_t)warps * queries * kBuf * sizeof(Key);
}

template <int R, int CC, bool VEC, int Q>
__global__ void __launch_bounds__(1024)
    knn_c_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                 int* __restrict__ idx_out, float* __restrict__ d2_out, int n, int s,
                 int k, int c_plan, int tile) {
  static_assert(R == 1 || R == 2, "k <= 64");
  static_assert(Q == 1 || Q == 2, "1 or 2 queries a warp");
  static_assert(CC % 4 == 0 || !VEC, "float4 staging needs whole groups of 4 channels");
  const int c = CC ? CC : c_plan;
  extern __shared__ __align__(16) unsigned char smem[];
  const int padded = round_up(tile, kGroup);
  const int ring = tile < n ? 2 : 1;
  const int warps = blockDim.x >> 5;
  float* tiles = reinterpret_cast<float*>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* qs = tiles + (size_t)ring * c * padded + (size_t)warp * Q * c;
  Key* bufs = reinterpret_cast<Key*>(smem + knn_c_smem(c, tile, ring, warps, Q) -
                                     (size_t)warps * Q * kBuf * sizeof(Key)) +
              warp * Q * kBuf;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * warps + warp) * Q;
  const int live = min(Q, s - q0);  // this warp's queries, uniform; <= 0: none
  const float* row = xyz + (size_t)b * n * c;

  if (live > 0) {
    // the warp's queries are consecutive rows: one run of live * C floats
    const float* src = query + ((size_t)b * s + q0) * c;
    for (int t = lane; t < Q * c; t += 32) qs[t] = t < live * c ? src[t] : 0.f;
  }
  Selection<R> sel[Q];

  const int tiles_n = (n + tile - 1) / tile;
  {
    const int lim = min(tile, n);
    stage_channels<VEC>(tiles, row, c, lim, padded);
  }
  for (int j = 0; j < tiles_n; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j (and the queries) are in; tile j - 1 is done
    const int base = j * tile;
    const int lim = min(tile, n - base);
    if (j + 1 < tiles_n) {
      const int next = min(tile, n - base - tile);
      stage_channels<VEC>(tiles + (size_t)((j + 1) & 1) * c * padded,
                          row + (size_t)(base + tile) * c, c, next, padded);
    }
    if (live <= 0) continue;
    const float* pts = tiles + (size_t)(j & 1) * c * padded;
    for (int t0 = 0; t0 < lim; t0 += kGroup) {
      float acc[Q][kUnroll];
      const int at = t0 + lane;
      if (VEC) {
        const int c4 = c >> 2;
        const float4* p4 = reinterpret_cast<const float4*>(pts) + at;
        const float4* q4 = reinterpret_cast<const float4*>(qs);
        {
          float4 p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) p[u] = p4[u * 32];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float4 qv = q4[i * c4];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const float d = __fsub_rn(qv.x, p[u].x);
              float a = __fmul_rn(d, d);
              a = sq_add(a, qv.y, p[u].y);
              a = sq_add(a, qv.z, p[u].z);
              acc[i][u] = sq_add(a, qv.w, p[u].w);
            }
          }
        }
#pragma unroll 4
        for (int g = 1; g < c4; ++g) {
          float4 p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) p[u] = p4[(size_t)g * padded + u * 32];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float4 qv = q4[i * c4 + g];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) acc[i][u] = sq_add4(acc[i][u], qv, p[u]);
          }
        }
      } else {
        {
          float p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) p[u] = pts[at + u * 32];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float qv = qs[i * c];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const float d = __fsub_rn(qv, p[u]);
              acc[i][u] = __fmul_rn(d, d);
            }
          }
        }
#pragma unroll 4
        for (int ch = 1; ch < c; ++ch) {
          float p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) p[u] = pts[(size_t)ch * padded + at + u * 32];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float qv = qs[i * c + ch];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) acc[i][u] = sq_add(acc[i][u], qv, p[u]);
          }
        }
      }
      // one vote for the group over all Q queries, then each query's own
      unsigned bits[Q][kUnroll];
      bool any = false;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          bits[i][u] = __float_as_uint(acc[i][u]);
          any |= bits[i][u] < sel[i].bound;
        }
      }
      if (!__any_sync(kFull, any)) continue;
#pragma unroll
      for (int i = 0; i < Q; ++i) sel[i].offer(bits[i], base + t0, bufs + i * kBuf, k, lane);
    }
  }
  if (live <= 0) return;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (i < live) sel[i].finish(bufs + i * kBuf, k, lane, (size_t)b * s + q0 + i, idx_out, d2_out);
  }
}

template <int R, int CC, bool VEC, int Q>
cudaError_t launch_knn_c(const float* xyz, const float* query, int* idx_out,
                         float* d2_out, int b, int n, int s, int k, int c, int warps,
                         int tile, int device, cudaStream_t stream) {
  const size_t smem = knn_c_smem(c, tile, tile < n ? 2 : 1, warps, Q);
  static unsigned opted = 0;
  // the most shared memory an SM can give: two blocks of up to ~113 KB share one
  const cudaError_t err =
      opt_in_smem(knn_c_kernel<R, CC, VEC, Q>, smem, device, opted, true);
  if (err != cudaSuccess) return err;
  const int per_block = warps * Q;
  const dim3 grid((s + per_block - 1) / per_block, b);
  knn_c_kernel<R, CC, VEC, Q><<<grid, warps * 32, smem, stream>>>(xyz, query, idx_out,
                                                                  d2_out, n, s, k, c, tile);
  return cudaGetLastError();
}

template <int R, int CC, bool VEC>
cudaError_t launch_knn_c_queries(const float* xyz, const float* query, int* idx_out,
                                 float* d2_out, int b, int n, int s, int k, int c, int warps,
                                 int queries, int tile, int device, cudaStream_t stream) {
  switch (queries) {
    case 1:
      return launch_knn_c<R, CC, VEC, 1>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                         tile, device, stream);
    default:
      return launch_knn_c<R, CC, VEC, 2>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                         tile, device, stream);
  }
}

template <int R>
cudaError_t launch_knn_c_width(const float* xyz, const float* query, int* idx_out,
                               float* d2_out, int b, int n, int s, int k, int c, int warps,
                               int queries, int tile, bool vec, int device,
                               cudaStream_t stream) {
  if (c == 64 && vec)
    return launch_knn_c_queries<R, 64, true>(xyz, query, idx_out, d2_out, b, n, s, k, c,
                                             warps, queries, tile, device, stream);
  if (vec)
    return launch_knn_c_queries<R, 0, true>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                            queries, tile, device, stream);
  return launch_knn_c_queries<R, 0, false>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                           queries, tile, device, stream);
}

}  // namespace

// plan (ops/grouping.py KNN_C_PLAN): B, N, S, k, C, warps a block, queries a
// warp, points a staged tile (N for the whole row, else a ring of two), vec
// (1: float4 staging; C a multiple of 4 and 16-byte aligned rows). The
// wrapper keeps 1 <= k <= min(64, N), B <= 65535, N * C < 2^31, warps in
// {4, 8, 16, 32}, queries in {1, 2} and a tile whose shared memory fits.
PCB_API int pcb_knn_c(const float* xyz, const float* query, int* idx_out,
                      float* d2_out, const int* plan, int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int k = plan[3];
  const int c = plan[4];
  const int warps = plan[5];
  const int queries = plan[6];
  const int tile = plan[7];
  const int vec = plan[8];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 64 || k > n || c < 1 || warps < 1 || warps > 32 || tile < 1 ||
      (queries != 1 && queries != 2) || (vec && c % 4 != 0) ||
      knn_c_smem(c, tile, tile < n ? 2 : 1, warps, queries) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = k > 32 ? launch_knn_c_width<2>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                       queries, tile, vec != 0, device, st)
               : launch_knn_c_width<1>(xyz, query, idx_out, d2_out, b, n, s, k, c, warps,
                                       queries, tile, vec != 0, device, st);
  return (int)err;
}

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
