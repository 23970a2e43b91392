// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function, so the library is loaded with
// ctypes and never includes PyTorch's headers. Each one takes the device
// index and the caller's stream, launches without synchronising, and
// returns cudaGetLastError() as an int (0 = success).
#pragma once

#include <cuda_runtime.h>

#define PCB_API extern "C" __attribute__((visibility("default")))

// Make `device` current for the launch that follows. cudaGetDevice reads a
// thread-local value; cudaSetDevice is called only when it differs, which it
// does not on the common path of one card.
static inline cudaError_t pcb_use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Squared distance in the reference's association, (dx*dx + dy*dy) + dz*dz,
// with every operation rounded on its own: the JAX kernels and the plain
// PyTorch versions compute it that way, and an FMA contraction would change
// the last bit and with it FPS and ball-query indices. (a - b)^2 equals
// (b - a)^2 exactly, so the operand order of the subtraction is free.
__device__ __forceinline__ float sq_dist3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// n / d for 0 <= n < 2^31 without a division: q = umulhi(n, mul) >> shift,
// with mul = ceil(2^(31 + l) / d) and shift = l - 1, l = ceil(log2 d), for
// d >= 2, and mul = 0 for d = 1 (q = n). The wrapper computes the two
// constants (ops/grouping.py::fast_divisor), where the CPU tests hold them
// to Python's // over the shapes the kernels see.
struct FastDiv {
  unsigned mul;
  unsigned shift;
  __device__ __forceinline__ int div(int n) const {
    return mul ? (int)(__umulhi((unsigned)n, mul) >> shift) : n;
  }
};

// Warp argmax over (key, index) pairs: the largest key and, among the lanes
// that hold it, the lowest index. A non-negative float32 orders like its
// uint32 bits, so a distance d >= 0 goes in as __float_as_uint(d). Two
// redux.sync operations (compute capability 8.0 and up) take the place of a
// five-level tree of shuffles and merges. Every lane gets the result; all 32
// lanes must call it.
struct KeyIndex {
  unsigned key;
  unsigned idx;
};
__device__ __forceinline__ KeyIndex warp_argmax(unsigned key, unsigned idx) {
  const unsigned best = __reduce_max_sync(0xffffffffu, key);
  const unsigned at = __reduce_min_sync(0xffffffffu, key == best ? idx : 0xffffffffu);
  return {best, at};
}

// Clamp an index into [0, n - 1], as index_points does: a ball-query miss
// is n and reads point n - 1.
__device__ __forceinline__ int clamp_index(int j, int n) {
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

// out[0:4] += v as one 16-byte reduction (RED.E.ADD.F32x4 on compute
// capability 9.x); out must be 16-byte aligned.
__device__ __forceinline__ void red_add4(float* out, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(out), v);
}

// 4 bytes from device to shared memory without passing through registers
// (cp.async, compute capability 8.0 and up). A 3-D point is 12 bytes, so no
// wider copy keeps every point aligned.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Commit this thread's copies and wait for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Points [0, count) of `pts` (x, y, z interleaved) into dst[0, count) as
// float4 (x, y, z, unused) by the whole block, copied asynchronously; slots
// [count, padded) get NaN coordinates, whose distance to any point is NaN:
// never within a radius, never among the nearest. A float4 a point is one
// 16-byte shared load, conflict-free across a warp. The caller waits
// (cp_async_wait_all) and synchronises before reading.
__device__ __forceinline__ void stage_points(float4* dst, const float* pts,
                                             int count, int padded) {
  float* d = reinterpret_cast<float*>(dst);
  for (int t = threadIdx.x; t < 3 * count; t += blockDim.x) {
    const int p = t / 3;
    cp_async_f32(d + 4 * p + (t - 3 * p), pts + t);
  }
  const float nan = __int_as_float(0x7fffffff);
  for (int p = count + threadIdx.x; p < padded; p += blockDim.x) {
    dst[p] = make_float4(nan, nan, nan, nan);
  }
}

// Lanes below this one, as a mask.
__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}
