// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function, so the library is loaded with
// ctypes and never includes PyTorch's headers. Each one takes the device
// index and the caller's stream, launches without synchronising, and
// returns cudaGetLastError() as an int (0 = success).
#pragma once

#include <cuda_runtime.h>

#define PCB_API extern "C" __attribute__((visibility("default")))

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
