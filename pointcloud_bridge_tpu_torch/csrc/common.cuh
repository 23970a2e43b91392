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
