// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) share: the head widths, the asynchronous staging of a
// tile of rows into shared memory, the split of a float32 into two TF32
// numbers, and the two tensor-core products over staged tiles.
//
// Arithmetic. Every product runs on the tensor cores as
// mma.sync.aligned.m16n8k8 in TF32 with float32 accumulators, at float32
// accuracy: each float32 operand x is split in registers into
// big = tf32(x) (10 mantissa bits, nearest, ties away, as cvt.rna.tf32.f32
// rounds) and small = x - big, and a product is
// small . big + big . small + big . big (3xTF32). What is dropped,
// small . small and the bits of small below TF32, is under 2^-20 of the
// product. A single TF32 pass is never used.
//
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A 16 x 8 row-major: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                       a3 = A[g+8][t+4]
//   B 8 x 8 "col":      b0 = B[k=t][n=g], b1 = B[k=t+4][n=g]
//   C 16 x 8:           c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                       c3 = C[g+8][2t+1]
// A warp owns 16 rows. In a product of rows by rows (q . k^T), B[k][n] is
// row n of the second tile at channel k, so a row-major tile serves as it
// lies. In the second product (p . v) the C fragment of the first is used as
// an A fragment without leaving its registers: the contraction index of an
// mma may be permuted at will if both operands agree, so slot t stands for
// key 2t and slot t+4 for key 2t+1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3), and
// the B fragment reads rows 2t and 2t+1 of the value tile. A staged row has
// D + 4 floats, which is 4 modulo 32: both B reads then touch 32 different
// banks.
#pragma once

#include <cstdint>

#include "common.cuh"

// err = CALL(D) for the head width d the kernels are instantiated for (a
// multiple of 32 up to 256), cudaErrorInvalidValue for any other.
#define PCB_FOR_HEAD_DIMS(CALL)           \
  switch (d) {                            \
    case 32: err = CALL(32); break;       \
    case 64: err = CALL(64); break;       \
    case 96: err = CALL(96); break;       \
    case 128: err = CALL(128); break;     \
    case 160: err = CALL(160); break;     \
    case 192: err = CALL(192); break;     \
    case 224: err = CALL(224); break;     \
    case 256: err = CALL(256); break;     \
    default: err = cudaErrorInvalidValue; \
  }

namespace flash {

constexpr int kPad = 4;                // floats added to a staged row
constexpr size_t kMaxShared = 232448;  // bytes a block may have on sm_90
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Let `kernel` use `bytes` of dynamic shared memory on `device`. The
// attribute sticks to the function on that device, so `done` (the caller's
// flag for this kernel and device, null where the device index is past the
// caller's table) spares every later launch the call.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, bool* done) {
  if (bytes <= 48 * 1024 || (done != nullptr && *done)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && done != nullptr) *done = true;
  return err;
}
constexpr int kDevices = 64;  // device indices with a flag of their own

// 16 bytes from device to shared memory without passing through registers;
// zeros where !valid (src must be readable all the same).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Ask for ROWS rows of D floats from row0 on, rows past n as zeros, into dst
// with row stride D + kPad, by the THREADS threads of the block. src rows
// are ld floats apart and 16-byte aligned. The caller commits and waits.
// A thread keeps one column of 4 floats and walks down the rows, THREADS /
// (D / 4) rows a pass, so that a copy costs an addition and a comparison
// (the threads past the last whole row of a pass stay idle).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile_async(float* __restrict__ dst,
                                                 const float* __restrict__ src,
                                                 int row0, int n,
                                                 long long ld) {
  constexpr int V4 = D / 4;
  constexpr int LD = D + kPad;
  constexpr int RP = THREADS / V4;  // rows a pass
  static_assert(RP >= 1, "a row a pass at least");
  const int r = threadIdx.x / V4;
  const int c = (threadIdx.x % V4) * 4;
  if (r >= RP) return;
  const float* from = src + (size_t)(row0 + r) * ld + c;
  float* to = dst + r * LD + c;
#pragma unroll
  for (int k = 0; k < (ROWS + RP - 1) / RP; ++k) {
    if (r + k * RP < ROWS) {
      const bool valid = row0 + r + k * RP < n;
      // src itself stands in for a row past n: nothing is read from it
      cp_async16(to + k * RP * LD, valid ? from + (size_t)(k * RP) * ld : src, valid);
    }
  }
}

// x = big + small + (a rest below 2^-21 |x|). The tensor core reads the upper
// 19 bits of a TF32 operand and ignores the rest, so big is x's bit pattern
// plus half a TF32 ulp: cut to 19 bits, that is x rounded to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds (an integer addition; on an H100
// the kernels took a sixth longer with the cvt, and the split is most of what
// they execute). small is the exact rest, x minus the cut
// pattern, of which the tensor core again reads the upper 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big & 0xffffe000u)));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two properties of the tensor core shape both products.
//  - It adds into its float32 accumulator with truncation, one ulp of the
//    running sum at worst and always towards zero, so a long chain of mma
//    into one accumulator drifts (measured on an H100: 3e-6 on outputs
//    below 1 over 1,536 mma, five times a float32 FMA kernel's error). A
//    product therefore runs short chains into zeroed scratch fragments
//    (kChain channel steps, or the rows of one staged tile) and adds those
//    to the sums with a rounded float32 addition.
//  - An mma that adds into the fragment the mma before it wrote waits for
//    that one to finish. So kChains independent scratch fragments are in
//    flight at a time, and the three terms of 3xTF32 run as three
//    passes over all of them, not one fragment after the other.
constexpr int kChain = 4;   // channel steps of 8 a chain in dot_rows
constexpr int kChains = 8;  // independent scratch fragments in flight

// The largest power of two that is at most want (at least 1) and divides len.
__host__ __device__ constexpr int side_by_side(int want, int len) {
  int kp = 1;
  while (2 * kp <= want && len % (2 * kp) == 0) kp *= 2;
  return kp;
}

// One chain of dot_rows: LEN channel steps from step k0 on, added to acc.
template <int LD, int NT, int NP, int LEN>
__device__ __forceinline__ void dot_chain(const float* const (&pa)[NP],
                                          const float* const (&pb)[NP],
                                          int k0, float (&acc)[NP][NT][4]) {
  // channel steps side by side where the products and tiles are too few
  constexpr int KP = side_by_side(kChains / (NP * NT), LEN);
  float part[KP][NP][NT][4];
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[kp][p][j][e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < LEN; kk += KP) {
    FragA a[KP][NP];
    FragB b[KP][NP][NT];
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float* xa = pa[p] + 8 * (k0 + kk + kp);
        split_tf32(xa[0], a[kp][p].big[0], a[kp][p].small[0]);
        split_tf32(xa[8 * LD], a[kp][p].big[1], a[kp][p].small[1]);
        split_tf32(xa[4], a[kp][p].big[2], a[kp][p].small[2]);
        split_tf32(xa[8 * LD + 4], a[kp][p].big[3], a[kp][p].small[3]);
        const float* xb = pb[p] + 8 * (k0 + kk + kp);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(xb[8 * j * LD], b[kp][p][j].big[0], b[kp][p][j].small[0]);
          split_tf32(xb[8 * j * LD + 4], b[kp][p][j].big[1], b[kp][p][j].small[1]);
        }
      }
    }
#pragma unroll
    for (int term = 0; term < 3; ++term) {  // the small terms first
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(part[kp][p][j], term == 0 ? a[kp][p].small : a[kp][p].big,
                     term == 1 ? b[kp][p][j].small : b[kp][p][j].big);
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = part[0][p][j][e];
#pragma unroll
        for (int kp = 1; kp < KP; ++kp) sum += part[kp][p][j][e];
        acc[p][j][e] += sum;
      }
    }
  }
}

// NP products of rows by rows at once: acc[p][j] = rows 0..15 of sa[p] times
// rows 8j..8j+7 of sb[p], transposed, over 8 * KSTEPS channels, so acc[p][j]
// is the 16 x 8 tile C[r][c] = sum_d sa[p][r][d] * sb[p][8j + c][d]. sa[p] and
// sb[p] point at the first row and channel to use; LD is the row stride.
template <int LD, int NT, int KSTEPS, int NP>
__device__ __forceinline__ void dot_rows(const float* const (&sa)[NP],
                                         const float* const (&sb)[NP], int g,
                                         int t, float (&acc)[NP][NT][4]) {
  const float* pa[NP];
  const float* pb[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    pa[p] = sa[p] + g * LD + t;
    pb[p] = sb[p] + g * LD + t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
    }
  }
#pragma unroll 1
  for (int c = 0; c < KSTEPS / kChain; ++c) {
    dot_chain<LD, NT, NP, kChain>(pa, pb, c * kChain, acc);
  }
  if (KSTEPS % kChain != 0) {
    dot_chain<LD, NT, NP, KSTEPS % kChain == 0 ? kChain : KSTEPS % kChain>(
        pa, pb, KSTEPS / kChain * kChain, acc);
  }
}

// acc[c] += w . x: w is 16 rows by 8 * NT weights as the C fragments of
// dot_rows hold them (w[j] covers the staged rows 8j..8j+7 of sx), sx the
// staged tile of those rows, and acc[c] the 16 x 8 tile of channels
// 8c..8c+7 from sx's first channel on, NCH tiles.
template <int LD, int NT, int NCH>
__device__ __forceinline__ void weighted_rows(const float (&w)[NT][4],
                                              const float* __restrict__ sx,
                                              int g, int t,
                                              float (&acc)[NCH][4]) {
  const float* px = sx + 2 * t * LD + g;
  FragA a[NT];  // slot t is row 2t of the 8, slot t + 4 row 2t + 1
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(w[j][0], a[j].big[0], a[j].small[0]);
    split_tf32(w[j][2], a[j].big[1], a[j].small[1]);
    split_tf32(w[j][1], a[j].big[2], a[j].small[2]);
    split_tf32(w[j][3], a[j].big[3], a[j].small[3]);
  }
  // G output fragments a group, JP blocks of 8 rows side by side where the
  // output fragments are too few
  constexpr int G = NCH < kChains ? NCH : kChains;
  constexpr int JP = side_by_side(kChains / G, NT);
#pragma unroll
  for (int c0 = 0; c0 < NCH; c0 += G) {
    float part[JP][G][4];
#pragma unroll
    for (int jp = 0; jp < JP; ++jp) {
#pragma unroll
      for (int cc = 0; cc < G; ++cc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jp][cc][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; j += JP) {
      FragB b[JP][G];
#pragma unroll
      for (int jp = 0; jp < JP; ++jp) {
#pragma unroll
        for (int cc = 0; cc < G; ++cc) {
          if (c0 + cc < NCH) {
            const float* xb = px + 8 * (j + jp) * LD + 8 * (c0 + cc);
            split_tf32(xb[0], b[jp][cc].big[0], b[jp][cc].small[0]);
            split_tf32(xb[LD], b[jp][cc].big[1], b[jp][cc].small[1]);
          }
        }
      }
#pragma unroll
      for (int term = 0; term < 3; ++term) {  // the small terms first
#pragma unroll
        for (int jp = 0; jp < JP; ++jp) {
#pragma unroll
          for (int cc = 0; cc < G; ++cc) {
            if (c0 + cc < NCH) {
              mma_tf32(part[jp][cc], term == 0 ? a[j + jp].small : a[j + jp].big,
                       term == 1 ? b[jp][cc].small : b[jp][cc].big);
            }
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < G; ++cc) {
      if (c0 + cc < NCH) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = part[0][cc][e];
#pragma unroll
          for (int jp = 1; jp < JP; ++jp) sum += part[jp][cc][e];
          acc[c0 + cc][e] += sum;
        }
      }
    }
  }
}

// Two warps share 16 rows and split the channels between them (flash_attn_bwd.cu):
// each computes the half of S and dP that its channels contribute, the
// helper hands its halves to the leader through the pair's buffer in shared
// memory (2 * NT * 128 floats), the leader adds them in a fixed order, turns
// the sums into the NOUT weight tiles of the second product and hands those
// back through the same buffer. Both meet twice a step at the pair's named
// barrier `bar` (64 threads); the buffer is free again after the block's
// next __syncthreads().
__device__ __forceinline__ void pair_barrier(int bar) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(bar) : "memory");
}

template <int NOUT, int NT>
__device__ __forceinline__ void pair_write(const float (&x)[2][NT][4],
                                           float* __restrict__ buf, int lane) {
#pragma unroll
  for (int p = 0; p < NOUT; ++p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[(4 * (NT * p + j) + e) * 32 + lane] = x[p][j][e];
    }
  }
}

// x = buf (ADD false) or x += buf (ADD true) over the first NOUT tiles
template <int NOUT, bool ADD, int NT>
__device__ __forceinline__ void pair_read(float (&x)[2][NT][4],
                                          const float* __restrict__ buf, int lane) {
#pragma unroll
  for (int p = 0; p < NOUT; ++p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = buf[(4 * (NT * p + j) + e) * 32 + lane];
        x[p][j][e] = ADD ? x[p][j][e] + val : val;
      }
    }
  }
}

}  // namespace flash
