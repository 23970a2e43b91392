// K3: grouped gather, fused with the centre subtraction and the feature
// gather of group_points.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/gather3.py,
// _gather3_kernel (called by _gather3_call; entry gather3_pallas), a
// two-level one-hot gather on the MXU of the 3 xyz channels, which
// ops/grouping.py::group_points reaches through index_points; XLA gathers the
// features beside it (ops/grouping.py:280-300). Here one kernel writes the
// whole [B, S, K, 3 + C] result of group_points:
//   out[b,s,k,0:3]   = xyz[b, j] - centers[b, s]   (__fsub_rn)
//   out[b,s,k,3:3+C] = feats[b, j]                 with j = clamp(idx[b,s,k], 0, N-1)
// The clamp is index_points' (ops/core.py:93): a ball-query miss is N. The
// result is bit-identical to group_plain and the same from run to run.
//
// What bounds it on the H100: bytes, and of those the output. The features
// it gathers (4 MB at BriStruNet's sa2) stay in the 50 MB L2, so device
// memory sees the index, the output rows and one read of the inputs. A
// thread an output element, as this kernel first ran, spends its issue slots
// on three 32-bit divisions by runtime values an element and on reloading idx
// once a channel: 28% of the card's bandwidth.
//
// Design:
// - G lanes own a neighbour row (b, s, k): 4, 8, 16 or 32 by the width, so
//   that a warp writes whole rows and G is a compile-time constant. A warp
//   owns a tile of (32 / G) * R consecutive rows of one batch element
//   (blockIdx.y = b), and its step r writes rows r * (32 / G) + group.
// - One coalesced load a warp brings the tile's indices, one lane a row;
//   that lane clamps j and finds s = row / K by a fast divmod (FastDiv,
//   constants from the wrapper), and __shfl_sync hands both to the row's
//   group. No division per element.
// - R rows are in flight a group (8 where the tile fits shared memory and
//   a lane, else 4): the dependent load idx -> feats is issued for all of
//   them before the first store.
// - The lanes walk the channels with a stride of G, so the loads of a
//   feature row (from L2) are coalesced.
// - Stores: a row of 3 + C floats is 16-byte aligned only where the width is a
//   multiple of 4, and the models' widths (6, 131, 259, 515) never are. 4-byte
//   stores straight from the lanes wrote 0.98 TB/s at width 259 and K = 32,
//   where the output (68 MB) outgrows L2; the sectors they leave half written
//   at both ends of every warp's store are the likely cost (not measured). So
//   the warp gathers its tile into shared memory and writes the tile, one
//   contiguous span of the output, with aligned 16-byte stores (the buffer is
//   shifted so that its 16-byte boundaries fall on the output's), streaming
//   (st.global.cs: the output is written once and should not push the gathered
//   features out of L2). A tile that does not fit its warp's share of 48 KB
//   (widths above 767) is stored 4 bytes a lane. PERF.md has the times of each
//   step on an H100 80GB HBM3.
// The one-hot MXU gather of the Pallas kernel was a TPU artefact and has no
// counterpart.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kStagedFloats = 48 * 1024 / 4 / kWarps;  // shared floats a warp

// Floats of shared memory a warp stages: its tile, aligned to 16 bytes
// after a shift of up to 3 floats.
__host__ __device__ constexpr int staged_floats(int tile, int width) {
  return (tile * width + 3 + 3) / 4 * 4;
}

template <int G, int R, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    group_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                 const int* __restrict__ idx, const float* __restrict__ feats,
                 float* __restrict__ out, int n, int s, int rows, int c,
                 FastDiv by_k) {
  constexpr int kGroups = 32 / G;
  constexpr int kTile = kGroups * R;
  static_assert(kTile <= 32, "a lane loads the index of one row of the tile");
  extern __shared__ __align__(16) float staged[];
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int l = lane % G;
  const int b = blockIdx.y;
  const int tile = (blockIdx.x * kWarps + threadIdx.x / 32) * kTile;
  if (tile >= rows) return;  // uniform across the warp
  const int width = 3 + c;
  const float* xb = xyz + (size_t)b * n * 3;
  const float* fb = feats + (size_t)b * n * c - 3;  // channel ch >= 3 at fb[j * c + ch]
  const float* cb = centers + (size_t)b * s * 3;
  float* ob = out + ((size_t)b * rows + tile) * width;

  // the tile's indices, a lane a row; then each group's R rows
  int jl = 0, sl = 0;
  if (lane < kTile && tile + lane < rows) {
    jl = clamp_index(__ldg(idx + (size_t)b * rows + tile + lane), n);
    sl = by_k.div(tile + lane);
  }
  int j[R], t[R];
  bool ok[R];
  float cen[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    t[r] = r * kGroups + grp;
    j[r] = __shfl_sync(0xffffffffu, jl, t[r]);
    const int sr = __shfl_sync(0xffffffffu, sl, t[r]);
    ok[r] = tile + t[r] < rows;
    // lanes 0-2 of the group write the xyz channels: lane e loads coordinate e
    cen[r] = l < 3 ? __ldg(cb + sr * 3 + l) : 0.0f;
  }

  // the staged tile starts `pad` floats into the warp's buffer, so that the
  // output's 16-byte boundaries fall on the buffer's
  const int pad = (int)((reinterpret_cast<size_t>(ob) >> 2) & 3);
  float* sw = staged + (threadIdx.x / 32) * staged_floats(kTile, width) + pad;
// store v[r] as channel ch of the group's row r: into the staged tile, or
// straight into the output where that row exists
#define PCB_PUT(r, ch)                        \
  if (kStaged)                                \
    sw[t[r] * width + (ch)] = v[r];           \
  else if (ok[r])                             \
    ob[t[r] * width + (ch)] = v[r]
  // first pass: the xyz channels on lanes 0-2 (G >= 4 > 3), features beyond
  if (l < 3) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __fsub_rn(__ldg(xb + j[r] * 3 + l), cen[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) PCB_PUT(r, l);
  } else if (l < width) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __ldg(fb + j[r] * c + l);
#pragma unroll
    for (int r = 0; r < R; ++r) PCB_PUT(r, l);
  }
  for (int ch = l + G; ch < width; ch += G) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __ldg(fb + j[r] * c + ch);
#pragma unroll
    for (int r = 0; r < R; ++r) PCB_PUT(r, ch);
  }
#undef PCB_PUT
  if (!kStaged) return;

  // the tile's rows are one contiguous span of the output: a head of up to
  // 3 floats, 16-byte stores, a tail
  __syncwarp();
  const int span = (rows - tile < kTile ? rows - tile : kTile) * width;
  const int head = min((4 - pad) & 3, span);
  const int body = (span - head) >> 2;
  if (lane < head) ob[lane] = sw[lane];
  for (int u = lane; u < body; u += 32)
    __stcs(reinterpret_cast<float4*>(ob + head + 4 * u),
           *reinterpret_cast<const float4*>(sw + head + 4 * u));
  const int done = head + 4 * body;
  if (done + lane < span) ob[done + lane] = sw[done + lane];
}

template <int G, int R, bool kStaged>
cudaError_t launch(const float* xyz, const float* centers, const int* idx, const float* feats,
                   float* out, int b, int n, int s, int k, int c, FastDiv by_k,
                   cudaStream_t st) {
  constexpr int kTile = 32 / G * R;
  const int rows = s * k;
  const dim3 grid((unsigned)((rows + kTile * kWarps - 1) / (kTile * kWarps)), (unsigned)b);
  const size_t shared = kStaged ? kWarps * staged_floats(kTile, 3 + c) * sizeof(float) : 0;
  group_kernel<G, R, kStaged><<<grid, kThreads, shared, st>>>(xyz, centers, idx, feats, out,
                                                              n, s, rows, c, by_k);
  return cudaGetLastError();
}

}  // namespace

// `plan` holds the integers of a launch, laid out once a shape by the wrapper
// (ops/grouping.py::_group_plan, fields GROUP_PLAN): one pointer instead of ten
// arguments, which ctypes would convert on every call. Lanes a row (4, 8, 16 or
// 32), rows in flight a group (8 only with 8 lanes or more) and `staged` (the
// tile through shared memory, where it fits kStagedFloats; else rows is 4) are
// the wrapper's choice, which also checks 1 <= B <= 65535 and every offset
// inside a batch element below 2^31; feats may be null when c == 0; (k_mul,
// k_shift) divide by K.
PCB_API int pcb_group(const float* xyz, const float* centers, const int* idx,
                      const float* feats, float* out, const unsigned* plan, int device,
                      void* stream) {
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int b = (int)plan[0];
  const int n = (int)plan[1];
  const int s = (int)plan[2];
  const int k = (int)plan[3];
  const int c = (int)plan[4];
  const int lanes = (int)plan[5];
  const int rows = (int)plan[6];
  const int staged = (int)plan[7];
  const FastDiv by_k{plan[8], plan[9]};  // k_mul, k_shift
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_GROUP(GG, RR, SS)                                                          \
  if (lanes == GG && rows == RR && (staged != 0) == SS)                                \
    return (int)launch<GG, RR, SS>(xyz, centers, idx, feats, out, b, n, s, k, c, by_k, \
                                   st);
  PCB_GROUP(4, 4, true) PCB_GROUP(8, 8, true) PCB_GROUP(16, 8, true) PCB_GROUP(32, 8, true)
  PCB_GROUP(8, 4, true) PCB_GROUP(16, 4, true) PCB_GROUP(32, 4, true)
  PCB_GROUP(4, 4, false) PCB_GROUP(8, 4, false) PCB_GROUP(16, 4, false) PCB_GROUP(32, 4, false)
#undef PCB_GROUP
  return (int)cudaErrorInvalidValue;
}
