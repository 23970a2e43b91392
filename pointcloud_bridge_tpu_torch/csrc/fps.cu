// K1: farthest point sampling.
//
// Replaces: pointcloud_bridge_tpu/ops/pallas_kernels/fps.py, _fps_kernel
// (flat layout, called by _fps_pallas_call) and _fps2_kernel (the
// sublane-packed layout of the same function, a TPU-only layout that has no
// counterpart here).
//
// Semantics (pointnet2_utils.py:63-80, ops/sampling.py::_fps_jnp): the
// running distance starts at 1e10; step i records the current farthest
// index, folds the squared distance to it in with min(), and takes the first
// maximum (lowest index on equal values) as the next one. The result is
// bit-identical to fps_plain: the distance is sq_dist3 (common.cuh) under
// -fmad=false, and the selection is exact.
//
// What bounds it on the H100: sequential latency. Every selection depends on
// the one before, so 4096->1024, 1024->256 and 256->64 at B=4 are 1,344
// dependent steps, each a pass over N points and a block-wide argmax. The
// bytes (N*12 per row) and the arithmetic are negligible; with one SM a
// row, the distance pass alone issues about N * 12 / 128 cycles a step.
//
// Design: one thread block per batch row, so a step never leaves the SM.
// - Each thread keeps PPT points (coordinates and running distances) in
//   registers, point i = thread + j * blockDim for j = 0..PPT-1, so a strict
//   > over j keeps the lowest index. Slots past N hold distance 0 and never
//   win: a real point ties them at worst, with a lower index. At 16 points a
//   thread (1024 threads, N > 8192) only the distances fit the registers,
//   and the coordinates are read from the shared copy below.
// - The warp argmax is two redux.sync operations on (distance bits, index)
//   (common.cuh warp_argmax).
// - One barrier a step: each warp's lane 0 writes its (bits, index) into a
//   slot double-buffered by step parity; after __syncthreads every warp
//   reduces the <= 32 slots itself, so no second barrier and no broadcast.
//   A warp can write step i+1's slots while another still reads step i's:
//   they are the other buffer, and step i+2's writes wait for step i+1's
//   barrier.
// - The winner's coordinates come from a structure-of-arrays copy of the row
//   in dynamic shared memory (12 bytes a point: 48 KB at N = 4096, 192 KB at
//   the N = 16384 cap, opted in with cudaFuncSetAttribute), not from a
//   dependent global load.
// - The selected indices are staged in a ring of 2 x 1024 in shared memory
//   and written in coalesced runs of 1024 and once at the end, not one store
//   a step.
// - N <= 256 runs one warp a row, with no barrier at all.
// The wrapper (ops/sampling.py::fps_launch) picks the threads and PPT by N.
// Measured slower on an H100 and left out (PERF.md, PR 8): a thread-block
// cluster of 2-8 blocks a row exchanging winners through distributed shared
// memory; the block's argmax as a 64-bit shared atomicMax; points blocked per
// thread with ballots; a Morton-sorted row whose threads skip a step when a
// bound on their box says no distance can change (the step is latency-bound,
// and the warp that holds the new centroid never skips).
#include "common.cuh"

namespace {

constexpr int kChunk = 1024;          // indices written out together
constexpr int kMaxPoints = 16384;     // ops/sampling.py FPS_MAX_POINTS
constexpr int kMaxSmem = 12 * kMaxPoints + 2 * kChunk * 4;
constexpr unsigned kNoIndex = 0xffffffffu;

// out[0:count] = buf[0:count] by the whole block
__device__ __forceinline__ void flush(const int* buf, int* out, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) out[t] = buf[t];
}

template <int PPT, bool kOneWarp>
__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, int n, int npoint) {
  extern __shared__ __align__(16) float row[];  // x[n], y[n], z[n], ring
  __shared__ unsigned slot_key[2][32];
  __shared__ unsigned slot_idx[2][32];
  float* sx = row;
  float* sy = sx + n;
  float* sz = sy + n;
  int* ring = reinterpret_cast<int*>(sz + n);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;

  // 16 points a thread take 1024 threads (N > 8192): their coordinates do not
  // fit the 64 registers a thread has there, and are read from the row copy
  constexpr bool kRegs = PPT <= 8;
  constexpr int R = kRegs ? PPT : 1;
  float px[R], py[R], pz[R], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + j * threads;
    float x = 0.f, y = 0.f, z = 0.f;
    dist[j] = 0.f;  // min(0, d >= 0) stays 0: never ahead of a real point
    if (i < n) {
      x = p[3 * i];
      y = p[3 * i + 1];
      z = p[3 * i + 2];
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
      dist[j] = 1e10f;
    }
    if (kRegs) {
      px[j % R] = x;
      py[j % R] = y;
      pz[j % R] = z;
    }
  }
  __syncthreads();

  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) ring[it & (2 * kChunk - 1)] = far;
    const float cx = sx[far];
    const float cy = sy[far];
    const float cz = sz[far];
    float best = -1.f;  // every distance is >= 0
    int bi = tid;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      float x, y, z;
      if (kRegs) {
        x = px[j % R];
        y = py[j % R];
        z = pz[j % R];
      } else {
        const int i = min(tid + j * threads, n - 1);  // a slot past N stays 0
        x = sx[i];
        y = sy[i];
        z = sz[i];
      }
      dist[j] = fminf(dist[j], sq_dist3(x, y, z, cx, cy, cz));
      if (dist[j] > best) {
        best = dist[j];
        bi = tid + j * threads;
      }
    }
    KeyIndex m = warp_argmax(__float_as_uint(best), (unsigned)bi);
    if (!kOneWarp) {
      const int par = it & 1;
      if (lane == 0) {
        slot_key[par][warp] = m.key;
        slot_idx[par][warp] = m.idx;
      }
      __syncthreads();
      m = warp_argmax(lane < nwarps ? slot_key[par][lane] : 0u,
                      lane < nwarps ? slot_idx[par][lane] : kNoIndex);
    }
    far = (int)m.idx;
    if ((it & (kChunk - 1)) == kChunk - 1) {
      // the ring entry of this step was written before this step's barrier
      if (kOneWarp) __syncwarp();
      flush(ring + ((it / kChunk) & 1) * kChunk, o + it - (kChunk - 1), kChunk);
    }
  }
  const int rest = npoint & (kChunk - 1);
  if (rest) {
    __syncthreads();
    flush(ring + ((npoint / kChunk) & 1) * kChunk, o + npoint - rest, rest);
  }
}

template <int PPT, bool kOneWarp>
cudaError_t launch_fps(const float* xyz, const int* start, int* out, int b,
                       int n, int npoint, int threads, int device,
                       cudaStream_t stream) {
  const size_t smem = (size_t)n * 12 + 2 * kChunk * sizeof(int);
  if (smem > 48 * 1024) {
    // opt in once a device, to the size the cap needs; a refusal raises
    static unsigned opted = 0;
    if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
    if (!((opted >> device) & 1u)) {
      const cudaError_t err = cudaFuncSetAttribute(
          fps_kernel<PPT, kOneWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return err;
      opted |= 1u << device;
    }
  }
  fps_kernel<PPT, kOneWarp><<<b, threads, smem, stream>>>(xyz, start, out, n, npoint);
  return cudaGetLastError();
}

}  // namespace

// plan (ops/sampling.py FPS_PLAN): B, N, npoint, threads, points a thread.
// The wrapper keeps 1 <= N <= 16384, threads a multiple of 32 up to 1024
// (32 for a one-warp row) and threads * ppt >= N, ppt in {1, 2, 4, 8, 16}.
PCB_API int pcb_fps(const float* xyz, const int* start, int* out, const int* plan,
                    int device, void* stream) {
  const int b = plan[0];
  const int n = plan[1];
  const int npoint = plan[2];
  const int threads = plan[3];
  const int ppt = plan[4];
  cudaError_t err = pcb_use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxPoints || threads * ppt < n) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PCB_FPS(P)                                                               \
  case P:                                                                        \
    err = threads == 32                                                          \
              ? launch_fps<P, true>(xyz, start, out, b, n, npoint, threads, device, st) \
              : launch_fps<P, false>(xyz, start, out, b, n, npoint, threads, device, st); \
    break
  switch (ppt) {
    PCB_FPS(1);
    PCB_FPS(2);
    PCB_FPS(4);
    PCB_FPS(8);
    PCB_FPS(16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PCB_FPS
  return (int)err;
}

// Shared by every wrapper to turn a returned code into a message.
PCB_API const char* pcb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
