// Variants of K1 (csrc/fps.cu) for measurement on the card, never on the main
// path: k1_k4_probe.py beside this file builds and times them against fps_plain.
// - probe_fps: the design of csrc/fps.cu (points strided over the threads,
//   two redux.sync a stage, one barrier), with clock64() stamps of warp 0
//   and of the last warp around each phase of a step;
// - probe_fps3: the same with the block stage as one 64-bit shared atomicMax
//   of (key << 32 | ~index) from the lanes that hold their warp's maximum;
// - probe_fps4: points blocked per thread (thread t holds t*PPT + j), so that
//   the lowest lane and the lowest warp with the maximum hold the lowest
//   index: one redux and a ballot a stage;
// - cluster_fps: C blocks a row in a thread-block cluster, each holding the
//   row and 1/C of the distances; the warps' winners go to every block's
//   slots through distributed shared memory, one cluster barrier a step.
#include <cooperative_groups.h>

#include "../csrc/common.cuh"
namespace cg = cooperative_groups;

constexpr unsigned kNone = 0xffffffffu;

// phase clocks: [0] centroid, [1] distance pass, [2] warp reduce, [3] barrier, [4] block reduce
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT) probe_fps(const float* __restrict__ xyz, const int* __restrict__ start,
                          int* __restrict__ out, int n, int npoint, long long* clocks) {
  extern __shared__ __align__(16) float row[];
  __shared__ unsigned slot_key[2][32], slot_idx[2][32];
  float* sx = row; float* sy = sx + n; float* sz = sy + n;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + j * T; float x = 0, y = 0, z = 0; dist[j] = 0.f;
    if (i < n) { x = p[3*i]; y = p[3*i+1]; z = p[3*i+2]; sx[i] = x; sy[i] = y; sz[i] = z; dist[j] = 1e10f; }
    px[j] = x; py[j] = y; pz[j] = z;
  }
  __syncthreads();
  long long acc[5] = {0, 0, 0, 0, 0};
  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    long long t0 = clock64();
    if (tid == 0) out[(size_t)b * npoint + it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    long long t1 = clock64();
    float best = -1.f; int bi = tid;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      dist[j] = fminf(dist[j], sq_dist3(px[j], py[j], pz[j], cx, cy, cz));
      if (dist[j] > best) { best = dist[j]; bi = tid + j * T; }
    }
    long long t2 = clock64();
    KeyIndex m = warp_argmax(__float_as_uint(best), (unsigned)bi);
    long long t3 = clock64();
    const int par = it & 1;
    if (lane == 0) { slot_key[par][warp] = m.key; slot_idx[par][warp] = m.idx; }
    __syncthreads();
    long long t4 = clock64();
    m = warp_argmax(lane < nw ? slot_key[par][lane] : 0u, lane < nw ? slot_idx[par][lane] : kNone);
    far = (int)m.idx;
    long long t5 = clock64();
    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2; acc[3] += t4 - t3; acc[4] += t5 - t4;
  }
  if (tid == 0 && b == 0) for (int q = 0; q < 5; ++q) clocks[q] = acc[q];
  if (tid == T - 1 && b == 0) for (int q = 0; q < 5; ++q) clocks[5 + q] = acc[q];
}

// cluster of C blocks a row: each block keeps the whole row in shared memory and the
// distances of points tid + rank*T + j*C*T; the warps' winners go to every block's slots.
template <int PPT, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(512)
    cluster_fps(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
                int n, int npoint) {
  extern __shared__ __align__(16) float row[];
  __shared__ unsigned slot_key[2][32], slot_idx[2][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* sx = row; float* sy = sx + n; float* sz = sy + n;
  const int b = blockIdx.x / C, tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  for (int i = tid; i < n; i += T) { sx[i] = p[3*i]; sy[i] = p[3*i+1]; sz[i] = p[3*i+2]; }
  __syncthreads();
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + rank * T + j * C * T;
    dist[j] = 0.f; px[j] = py[j] = pz[j] = 0.f;
    if (i < n) { px[j] = sx[i]; py[j] = sy[i]; pz[j] = sz[i]; dist[j] = 1e10f; }
  }
  unsigned* rkey[C]; unsigned* ridx[C];
  for (int r = 0; r < C; ++r) {
    rkey[r] = cluster.map_shared_rank(&slot_key[0][0], r);
    ridx[r] = cluster.map_shared_rank(&slot_idx[0][0], r);
  }
  cluster.sync();
  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    if (rank == 0 && tid == 0) out[(size_t)b * npoint + it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best = -1.f; int bi = tid;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      dist[j] = fminf(dist[j], sq_dist3(px[j], py[j], pz[j], cx, cy, cz));
      if (dist[j] > best) { best = dist[j]; bi = tid + rank * T + j * C * T; }
    }
    KeyIndex m = warp_argmax(__float_as_uint(best), (unsigned)bi);
    const int par = it & 1;
    const int s = par * 32 + rank * nw + warp;
    if (lane < C) { rkey[lane][s] = m.key; ridx[lane][s] = m.idx; }
    cluster.sync();
    const int ns = C * nw;
    m = warp_argmax(lane < ns ? slot_key[par][lane] : 0u, lane < ns ? slot_idx[par][lane] : kNone);
    far = (int)m.idx;
  }
  cluster.sync();
}


extern "C" int probe_launch(const float* xyz, const int* start, int* out, int b, int n, int npoint,
                            int threads, int ppt, long long* clocks, void* stream) {
  size_t smem = (size_t)n * 12;
  cudaStream_t st = (cudaStream_t)stream;
#define GO(P, M) { auto k = probe_fps<P, M>; cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000); \
  k<<<b, threads, smem, st>>>(xyz, start, out, n, npoint, clocks); }
  if (ppt == 8) GO(8, 1024) else if (ppt == 16) GO(16, 256) else if (ppt == 4) GO(4, 1024) else return 1;
  return (int)cudaGetLastError();
}

extern "C" int cluster_launch(const float* xyz, const int* start, int* out, int b, int n, int npoint,
                              int threads, int ppt, int c, void* stream) {
  size_t smem = (size_t)n * 12;
  cudaStream_t st = (cudaStream_t)stream;
#define CL(P, CC) { auto k = cluster_fps<P, CC>; cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000); \
  if (e) return (int)e; k<<<b * CC, threads, smem, st>>>(xyz, start, out, n, npoint); }
  if (c == 2 && ppt == 8) CL(8, 2) else if (c == 2 && ppt == 4) CL(4, 2) else if (c == 4 && ppt == 8) CL(8, 4)
  else if (c == 4 && ppt == 4) CL(4, 4) else if (c == 8 && ppt == 4) CL(4, 8) else if (c == 8 && ppt == 2) CL(2, 8) else return 1;
  return (int)cudaGetLastError();
}

// strided points; warp redux on the key, the lanes holding it do one 64-bit
// shared atomicMax of (key << 32 | ~idx); one barrier; one 8-byte load
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT) probe_fps3(const float* __restrict__ xyz, const int* __restrict__ start,
                          int* __restrict__ out, int n, int npoint, long long* clocks) {
  extern __shared__ __align__(16) float row[];
  __shared__ unsigned long long best3[3];
  float* sx = row; float* sy = sx + n; float* sz = sy + n;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const float* p = xyz + (size_t)b * n * 3;
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + j * T; float x = 0, y = 0, z = 0; dist[j] = 0.f;
    if (i < n) { x = p[3*i]; y = p[3*i+1]; z = p[3*i+2]; sx[i] = x; sy[i] = y; sz[i] = z; dist[j] = 1e10f; }
    px[j] = x; py[j] = y; pz[j] = z;
  }
  if (tid < 3) best3[tid] = 0ull;
  __syncthreads();
  long long acc[5] = {0, 0, 0, 0, 0};
  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    long long t0 = clock64();
    if (tid == 0) { out[(size_t)b * npoint + it] = far; best3[(it + 1) % 3] = 0ull; }
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    long long t1 = clock64();
    float best = -1.f; int bi = tid;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      dist[j] = fminf(dist[j], sq_dist3(px[j], py[j], pz[j], cx, cy, cz));
      if (dist[j] > best) { best = dist[j]; bi = tid + j * T; }
    }
    long long t2 = clock64();
    const unsigned key = __float_as_uint(best);
    const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
    if (key == wkey) atomicMax(&best3[it % 3], ((unsigned long long)key << 32) | (0xffffffffu - (unsigned)bi));
    long long t3 = clock64();
    __syncthreads();
    long long t4 = clock64();
    far = (int)(0xffffffffu - (unsigned)(best3[it % 3] & 0xffffffffull));
    long long t5 = clock64();
    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2; acc[3] += t4 - t3; acc[4] += t5 - t4;
  }
  if (tid == 0 && b == 0) for (int q = 0; q < 5; ++q) clocks[q] = acc[q];
  if (tid == T - 1 && b == 0) for (int q = 0; q < 5; ++q) clocks[5 + q] = acc[q];
}

extern "C" int probe3_launch(const float* xyz, const int* start, int* out, int b, int n, int npoint,
                            int threads, int ppt, long long* clocks, void* stream) {
  size_t smem = (size_t)n * 12;
  cudaStream_t st = (cudaStream_t)stream;
#define GO3(P, M) { auto k = probe_fps3<P, M>; cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000); \
  k<<<b, threads, smem, st>>>(xyz, start, out, n, npoint, clocks); }
  if (ppt == 8) GO3(8, 1024) else if (ppt == 16) GO3(16, 256) else if (ppt == 4) GO3(4, 1024) else return 1;
  return (int)cudaGetLastError();
}

// blocked points, index tracked in the pass; the lowest lane and the lowest warp holding the
// maximum by ballot (points rise with lane and warp), one redux a stage
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT) probe_fps4(const float* __restrict__ xyz, const int* __restrict__ start,
                          int* __restrict__ out, int n, int npoint, long long* clocks) {
  extern __shared__ __align__(16) float row[];
  __shared__ unsigned slot_key[2][32], slot_idx[2][32];
  float* sx = row; float* sy = sx + n; float* sz = sy + n;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  for (int i = tid; i < n; i += T) { sx[i] = p[3*i]; sy[i] = p[3*i+1]; sz[i] = p[3*i+2]; }
  __syncthreads();
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  for (int j = 0; j < PPT; ++j) {
    const int i = tid * PPT + j; float x = 0, y = 0, z = 0; dist[j] = 0.f;
    if (i < n) { x = sx[i]; y = sy[i]; z = sz[i]; dist[j] = 1e10f; }
    px[j] = x; py[j] = y; pz[j] = z;
  }
  long long acc[5] = {0, 0, 0, 0, 0};
  int far = start[b];
  for (int it = 0; it < npoint; ++it) {
    long long t0 = clock64();
    if (tid == 0) out[(size_t)b * npoint + it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    long long t1 = clock64();
    float best = -1.f; int bj = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      dist[j] = fminf(dist[j], sq_dist3(px[j], py[j], pz[j], cx, cy, cz));
      if (dist[j] > best) { best = dist[j]; bj = j; }
    }
    long long t2 = clock64();
    const unsigned key = __float_as_uint(best);
    const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
    const int par = it & 1;
    if (lane == __ffs(__ballot_sync(0xffffffffu, key == wkey)) - 1) {
      slot_key[par][warp] = wkey; slot_idx[par][warp] = tid * PPT + bj;
    }
    long long t3 = clock64();
    __syncthreads();
    long long t4 = clock64();
    const unsigned k2 = lane < nw ? slot_key[par][lane] : 0u;
    const unsigned bkey = __reduce_max_sync(0xffffffffu, k2);
    far = (int)slot_idx[par][__ffs(__ballot_sync(0xffffffffu, k2 == bkey)) - 1];
    long long t5 = clock64();
    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2; acc[3] += t4 - t3; acc[4] += t5 - t4;
  }
  if (tid == 0 && b == 0) for (int q = 0; q < 5; ++q) clocks[q] = acc[q];
  if (tid == T - 1 && b == 0) for (int q = 0; q < 5; ++q) clocks[5 + q] = acc[q];
}

extern "C" int probe4_launch(const float* xyz, const int* start, int* out, int b, int n, int npoint,
                            int threads, int ppt, long long* clocks, void* stream) {
  size_t smem = (size_t)n * 12;
  cudaStream_t st = (cudaStream_t)stream;
#define GO4(P, M) { auto k = probe_fps4<P, M>; cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 200000); \
  k<<<b, threads, smem, st>>>(xyz, start, out, n, npoint, clocks); }
  if (ppt == 8) GO4(8, 1024) else if (ppt == 16) GO4(16, 256) else if (ppt == 4) GO4(4, 1024) else return 1;
  return (int)cudaGetLastError();
}
