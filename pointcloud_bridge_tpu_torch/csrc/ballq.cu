// K2: exact ball query.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/ballq.py, _ballq_kernel
// (called by _ballq_call; entry ball_query_pallas).
//
// Semantics (pointnet2_utils.py:97-112): for each query centre, the first K
// point indices in ascending order whose squared distance is <= r2 (r2 is
// radius*radius rounded to float32 by the caller); slots past the last hit
// hold the first hit; an empty ball gives N in every slot. K may exceed N.
// One launch answers up to three radii of the same points and centres (the
// scales of a multi-scale set abstraction), each with its own K and output,
// each bit-identical to ops/grouping.py::ball_query_plain at its radius.
//
// What bounds it on the H100: compare-and-scan work. A query scans points in
// index order until it has K hits at every radius, so the cost is the number
// of points scanned times B*S: the 8 rounded operations of a distance, a
// compare a radius, and the shared-memory load of the point (a float4 for 32
// lanes is 512 bytes, four cycles of an SM's 128 bytes a cycle). There is no
// [B, S, N] distance matrix and no sort.
//
// Design: a warp scans for Q queries (1 or 4), `warps` warps a block (the
// wrapper's plan picks both by the number of queries:
// ops/grouping.py::ball_queries_a_warp and neighbour_launch).
// - The block stages the row in dynamic shared memory as float4 points with
//   cp.async (common.cuh stage_points): the whole row at once where it fits
//   (one barrier), else a ring of two tiles, the next in flight while this
//   one is scanned (one barrier a tile, which also ends the block once every
//   query of it has its K hits).
// - A step loads 32 points, one a lane, once for the warp's Q queries: the
//   shared-memory traffic a pair falls by Q. A distance is computed once and
//   compared with each radius's r2 as uint32 bits (the order of non-negative
//   floats; a NaN never hits).
// - For each query and radius a ballot gives the hits of the 32 in index
//   order and a popcount of the lower lanes gives each hit its slot, so the
//   ascending order falls out without a cumsum. kUnroll steps share one vote
//   a query; a radius stops at its K hits, a query when all its radii have
//   (uniform branches skip them), the warp when all its queries have.
// - Padding the tail slots with the first hit is one store a slot.
// Measured and not kept (PERF.md, PR 9): a thread a query, every lane
// reading the same point (slower at every model level); 2 queries a warp,
// 2 or 8 steps between votes and 12-byte point loads (no faster).
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;      // steps of 32 points between two votes
constexpr int kGroup = 32 * kUnroll;
constexpr int kRowMax = 8192;   // ops/grouping.py STAGE_ROW_MAX
constexpr int kMaxSmem = 232448;
constexpr int kMaxRadii = 3;    // ops/grouping.py BALL_MAX_RADII

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The radii of one scan: output [B, S, k[r]], K and r2's float32 bits.
struct Balls {
  int* out[kMaxRadii];
  int k[kMaxRadii];
  unsigned r2_bits[kMaxRadii];
};

template <int Q, int NR>
__global__ void __launch_bounds__(1024)
    ballq_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                 const Balls balls, int n, int s, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int padded = round_up(tile, kGroup);
  float4* tiles = reinterpret_cast<float4*>(smem);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * Q;
  const float* row = xyz + (size_t)b * n * 3;

  float qx[Q], qy[Q], qz[Q];
  int count[Q][NR];  // hits so far; the same in every lane of the warp
  int first[Q][NR];  // index of the first hit, N while the ball is empty
  bool done = true;  // every query of the warp has its K hits at every radius
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float* c = centers + ((size_t)b * s + min(q0 + i, s - 1)) * 3;
    qx[i] = c[0];
    qy[i] = c[1];
    qz[i] = c[2];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      count[i][r] = q0 + i < s ? 0 : balls.k[r];  // a query past S is done
      first[i][r] = n;
      done &= count[i][r] >= balls.k[r];
    }
  }

  const int tiles_n = (n + tile - 1) / tile;
  {
    const int lim = min(tile, n);
    stage_points(tiles, row, lim, round_up(lim, kGroup));
  }
  for (int j = 0; j < tiles_n; ++j) {
    cp_async_wait_all();
    // tile j is in; every warp is done with tile j - 1; the block stops
    // once all its queries have their hits
    if (__syncthreads_and(done)) break;
    const int base = j * tile;
    const int lim = min(tile, n - base);
    if (j + 1 < tiles_n) {
      const int next = min(tile, n - base - tile);
      stage_points(tiles + ((j + 1) & 1) * padded, row + (size_t)(base + tile) * 3, next,
                   round_up(next, kGroup));
    }
    const float4* pts = tiles + (j & 1) * padded;
    for (int t0 = 0; t0 < lim && !done; t0 += kGroup) {
      float4 p[kUnroll];  // read once for the warp's Q queries
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) p[u] = pts[t0 + u * 32 + lane];
      done = true;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        bool live = false;
#pragma unroll
        for (int r = 0; r < NR; ++r) live |= count[i][r] < balls.k[r];
        if (!live) continue;  // uniform over the warp
        unsigned bits[kUnroll];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          bits[u] = __float_as_uint(sq_dist3(qx[i], qy[i], qz[i], p[u].x, p[u].y, p[u].z));
#pragma unroll
          for (int r = 0; r < NR; ++r) any |= bits[u] <= balls.r2_bits[r];
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            if (count[i][r] >= balls.k[r]) continue;
            int* o = balls.out[r] + ((size_t)b * s + q0 + i) * balls.k[r];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const bool hit = bits[u] <= balls.r2_bits[r];
              const unsigned m = __ballot_sync(0xffffffffu, hit);
              if (m == 0u) continue;
              const int at = base + t0 + u * 32;
              if (count[i][r] == 0) first[i][r] = at + __ffs(m) - 1;
              if (hit) {
                const int slot = count[i][r] + __popc(m & lanes_below(lane));
                if (slot < balls.k[r]) o[slot] = at + lane;
              }
              count[i][r] += __popc(m);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) done &= count[i][r] >= balls.k[r];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (q0 + i >= s) break;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      int* o = balls.out[r] + ((size_t)b * s + q0 + i) * balls.k[r];
      for (int slot = count[i][r] + lane; slot < balls.k[r]; slot += 32) o[slot] = first[i][r];
    }
  }
}

template <int Q, int NR>
cudaError_t launch_ballq(const float* xyz, const float* centers, const Balls& balls,
                         int b, int n, int s, int warps, int tile, int device,
                         cudaStream_t stream) {
  const int ring = tile < n ? 2 : 1;
  const size_t smem = (size_t)ring * round_up(tile, kGroup) * sizeof(float4);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // opt in once a device, to the most a block may have; a refusal raises
    static unsigned opted = 0;
    if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
    if (!((opted >> device) & 1u)) {
      const cudaError_t err = cudaFuncSetAttribute(
          ballq_kernel<Q, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      opted |= 1u << device;
    }
  }
  const int per_block = warps * Q;
  const dim3 grid((s + per_block - 1) / per_block, b);
  ballq_kernel<Q, NR><<<grid, warps * 32, smem, stream>>>(xyz, centers, balls, n, s, tile);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_ballq_radii(const float* xyz, const float* centers, const Balls& balls,
                               int radii, int b, int n, int s, int warps, int tile,
                               int device, cudaStream_t stream) {
  switch (radii) {
    case 1:
      return launch_ballq<Q, 1>(xyz, centers, balls, b, n, s, warps, tile, device, stream);
    case 2:
      return launch_ballq<Q, 2>(xyz, centers, balls, b, n, s, warps, tile, device, stream);
    case 3:
      return launch_ballq<Q, 3>(xyz, centers, balls, b, n, s, warps, tile, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out0-out2: the outputs of up to three radii (null past `radii`).
// plan (ops/grouping.py BALL_PLAN): B, N, S, warps a block, queries a warp
// (1 or 4), points a staged tile (N for the whole row, else a ring of two),
// the number of radii (1-3), then K and r2's float32 bits of each radius.
// The wrapper keeps B <= 65535, warps in {4, 8, 16, 32}, every K >= 1 and
// a tile of N <= STAGE_ROW_MAX or STAGE_TILE.
PCB_API int pcb_ball_query(const float* xyz, const float* centers, int* out0, int* out1,
                           int* out2, const int* plan, int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int s = plan[2];
  const int warps = plan[3];
  const int queries = plan[4];
  const int tile = plan[5];
  const int radii = plan[6];
  const int k0 = plan[7];
  const int r2_bits0 = plan[8];
  const int k1 = plan[9];
  const int r2_bits1 = plan[10];
  const int k2 = plan[11];
  const int r2_bits2 = plan[12];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Balls balls = {{out0, out1, out2}, {k0, k1, k2},
                       {(unsigned)r2_bits0, (unsigned)r2_bits1, (unsigned)r2_bits2}};
  if (n < 1 || warps < 1 || warps > 32 || tile < 1 || (tile < n && tile > kRowMax) ||
      radii < 1 || radii > kMaxRadii)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < radii; ++r) {
    if (balls.k[r] < 1 || balls.out[r] == nullptr) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (queries) {
    case 1:
      return (int)launch_ballq_radii<1>(xyz, centers, balls, radii, b, n, s, warps, tile,
                                        device, st);
    case 4:
      return (int)launch_ballq_radii<4>(xyz, centers, balls, radii, b, n, s, warps, tile,
                                        device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
