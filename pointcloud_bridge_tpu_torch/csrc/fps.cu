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
// maximum (lowest index on equal values) as the next one.
//
// What bounds it on the H100: sequential latency. Every selection depends on
// the one before, so 4096->1024, 1024->256 and 256->64 at B=4 are 1,344
// dependent steps, each a pass over N points and a block-wide argmax. The
// bytes (N*12 per row) and the arithmetic are negligible.
//
// Design: one thread block per batch row, so a step never leaves the SM.
// Each thread keeps its points' coordinates and running distances in
// registers (PPT points a thread, strided so that loads coalesce); a step
// is a register pass, a warp-shuffle argmax, one shared-memory exchange
// between warps and two barriers. The centroid's coordinates come from a
// cached global load of the winner. Rows run on separate SMs in parallel.
#include "common.cuh"

namespace {

__device__ __forceinline__ void argmax_merge(float& best, int& bi, float v,
                                             int i) {
  if (v > best || (v == best && i < bi)) {
    best = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    argmax_merge(best, bi, ov, oi);
  }
}

template <int PPT>
__global__ void fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ start,
                           int* __restrict__ out, int n, int npoint) {
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
    } else {
      px[j] = py[j] = pz[j] = 0.f;
    }
    dist[j] = 1e10f;
  }

  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    if (threadIdx.x == 0) o[it] = far;
    const float cx = __ldg(p + 3 * far);
    const float cy = __ldg(p + 3 * far + 1);
    const float cz = __ldg(p + 3 * far + 2);

    // distances are >= 0, so -1 loses to every real point
    float best = -1.f;
    int bi = n;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < n) {
        dist[j] = fminf(dist[j], sq_dist3(px[j], py[j], pz[j], cx, cy, cz));
        // i grows with j, so a strict > keeps the lowest index on ties
        if (dist[j] > best) {
          best = dist[j];
          bi = i;
        }
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? s_val[lane] : -1.f;
      bi = lane < nwarps ? s_idx[lane] : n;
      warp_argmax(best, bi);
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
    far = s_far;
  }
}

template <int PPT>
void launch_fps(const float* xyz, const int* start, int* out, int b, int n,
                int npoint, int threads, cudaStream_t stream) {
  fps_kernel<PPT><<<b, threads, 0, stream>>>(xyz, start, out, n, npoint);
}

}  // namespace

// The wrapper keeps N <= 16384 (PPT <= 16 at 1024 threads).
PCB_API int pcb_fps(const float* xyz, const int* start, int* out, int b,
                    int n, int npoint, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // about four points a thread, whole warps, at most 1024 threads
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int ppt = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (ppt <= 1) {
    launch_fps<1>(xyz, start, out, b, n, npoint, threads, st);
  } else if (ppt <= 2) {
    launch_fps<2>(xyz, start, out, b, n, npoint, threads, st);
  } else if (ppt <= 4) {
    launch_fps<4>(xyz, start, out, b, n, npoint, threads, st);
  } else if (ppt <= 8) {
    launch_fps<8>(xyz, start, out, b, n, npoint, threads, st);
  } else if (ppt <= 16) {
    launch_fps<16>(xyz, start, out, b, n, npoint, threads, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Shared by every wrapper to turn a returned code into a message.
PCB_API const char* pcb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
