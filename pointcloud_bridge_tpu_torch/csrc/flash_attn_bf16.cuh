// What the bfloat16 flash-attention forward (flash_attn_bf16.cu) and
// backward (flash_attn_bwd_bf16.cu) share: the tile plan, the Hopper copy
// engine (TMA loads of tiles under mbarriers, the tensor maps that describe
// them) and the warpgroup products (wgmma) over the tiles.
//
// Arithmetic. Every product is wgmma.mma_async m64nNk16 with bf16 operands
// and float32 accumulators: a product of two bf16 numbers is exact in
// float32, so what a product adds to the float32 rounding of its sum is
// nothing. Where an operand is computed in float32 (the probabilities P, the
// gradient dS), it is rounded to bf16, to nearest even, in registers as it
// enters the second product.
//
// Roles. A block has one or two consumer warpgroups of 64 rows each (warps
// 0-3 and 4-7), which run the products, and a producer warpgroup after them,
// of which one thread issues every TMA load (and, in dk/dv, one warp stages
// the row statistics). A block of 384 threads starts at 168 registers a
// thread; the producer gives its registers up to the consumers (setmaxnreg:
// 24 against 240), whose sums need more than 168 from D = 96 up. With the
// producer in front of the consumers instead, ptxas kept the consumers to
// 168: they spilled and their products were serialized.
//
// Pipeline. Each consumer loop runs a step behind on its second products:
// step j asks for its first products, then for the second products of step
// j - 1, and computes step j's softmax or gradient while those run, from
// the first products' accumulators, which it only reads (ptxas serializes
// the products where ordinary instructions write an accumulator while a
// product is in flight, and where a wait is conditional: step 0 is peeled
// off). A stage goes back to the producer once its second products are
// done.
//
// Tiles in shared memory. A tile of R rows by D bf16 channels lies as D / 32
// column blocks of R rows by 32 channels (64 bytes a row), each block
// R * 64 bytes after the one before, with the 64-byte swizzle (the 16-byte
// chunk c of row r at chunk c ^ ((r / 2) % 4)). One layout serves every D
// in 32..256: a multiple of 32 is all it asks. A TMA box is {32 channels, R
// rows, 1 batch row} and lands one column block; the tensor map clips rows
// past N to zeros. Every tile starts 1024-byte aligned, so the swizzle is
// the one a wgmma descriptor with base offset 0 reads.
//
// Products (PTX ISA, wgmma; g = lane / 4, t = lane % 4, warp w of the
// warpgroup owns rows 16 w .. 16 w + 15):
//   accumulator m64nN float32: d[4 j + 2 i + e] = D[16 w + g + 8 i][8 j + 2 t + e]
//   A from registers, m64k16 bf16: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//                                 a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9]
// so the accumulator of a first product is the A operand of the second
// without leaving the registers: the 16 keys of a k-step are the column
// tiles j = 2s and 2s + 1, a = (d[8s], d[8s+1]), (d[8s+2], d[8s+3]),
// (d[8s+4], d[8s+5]), (d[8s+6], d[8s+7]) rounded to bf16 pairs.
//  - rows by rows (q . k^T): A and B are tiles as they lie, K-major (the
//    channels are the contraction); a k-step of 16 channels is 32 bytes
//    into a 64-byte row, two k-steps a column block.
//  - weights by rows (p . v): B = the tile of rows is K x N with N (the
//    channels) contiguous, MN-major: 8 rows of 64 bytes are 512 bytes (the
//    stride byte offset), the next 32 channels a column block further (the
//    leading byte offset); a k-step of 16 rows is 1024 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>

#include <cstdint>

#include "flash_attn.cuh"

namespace flash_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;         // rows a consumer warpgroup owns
constexpr int kBox = 32;          // channels a TMA box and a column block
constexpr int kGroup = 128;       // threads a warpgroup
constexpr int kMaxThreads = 3 * kGroup;  // two consumer warpgroups and the producer
constexpr int kAlign = 1024;      // bytes a tile's start is aligned to

// The tile plan, a row a head width D: keys a forward step, forward ring
// stages; keys a dq step, dq stages; queries a dk/dv step, dk/dv stages, and
// whether dk/dv splits its two sums between the consumer warpgroups (1).
// ops/attention.py BF16_PLAN mirrors it, and the CPU tests hold the two
// equal and every row within the shared memory a block may have.
// Registers bound the plan: a consumer thread holds D/2 floats of its
// output sum a 64-row sum, and BN/2 floats a first product of BN keys.
// Each kernel's loop runs a step behind on its second products, so a stage
// is held for two steps and a ring needs three stages for the producer to
// load ahead.
//  - forward: the sum O and S: 128 keys a step to D = 96, 64 beyond, 32 at
//    D = 256 (whose tiles fit four stages only so).
//  - dq: dq, S and dP: 64 keys to D = 160, 32 beyond.
//  - dk/dv: dK and dV together are D floats a thread for 64 keys. They fit
//    beside S^T and dP^T to D = 128 (32 queries a step at 128). From
//    D = 160 up they do not, and the block's two warpgroups share 64 keys:
//    one sums dV (it computes S^T and P), the other dK (S^T, dP^T and dS),
//    D/2 floats each; S^T is computed twice, five products for four.
#define PCB_BF16_PLAN(X)                  \
  X(32, 128, 4, 64, 4, 64, 4, 0)         \
  X(64, 128, 4, 64, 4, 64, 4, 0)         \
  X(96, 128, 3, 64, 4, 64, 4, 0)         \
  X(128, 64, 4, 64, 4, 32, 4, 0)         \
  X(160, 64, 4, 64, 3, 64, 4, 1)         \
  X(192, 64, 3, 32, 4, 64, 3, 1)         \
  X(224, 64, 3, 32, 4, 32, 4, 1)         \
  X(256, 32, 4, 32, 3, 32, 4, 1)

template <int D>
struct Plan;
#define PCB_BF16_PLAN_ROW(d, fbn, fst, qbn, qst, kbq, kst, ksplit)  \
  template <>                                                      \
  struct Plan<d> {                                                 \
    static constexpr int fwd_bn = fbn, fwd_stages = fst;           \
    static constexpr int dq_bn = qbn, dq_stages = qst;             \
    static constexpr int dkv_bq = kbq, dkv_stages = kst;           \
    static constexpr bool dkv_split = ksplit != 0;                 \
  };
PCB_BF16_PLAN(PCB_BF16_PLAN_ROW)
#undef PCB_BF16_PLAN_ROW

// bytes of a tile of `rows` rows by d channels
__host__ __device__ constexpr uint32_t tile_bytes(int rows, int d) {
  return (uint32_t)rows * d * sizeof(bf16);
}

// Dynamic shared memory of a block: `resident` tiles of 64 rows, a ring of
// `stages` x 2 tiles of `bn` rows, `stats` floats, the mbarriers (a full and
// an empty one a stage, one for the resident tiles) and the slack that
// aligns the first tile.
__host__ __device__ constexpr size_t smem_bytes(int d, int resident, int bn, int stages,
                                                int stats) {
  return kAlign + (size_t)resident * tile_bytes(kRows, d) +
         (size_t)stages * 2 * tile_bytes(bn, d) + (size_t)stats * sizeof(float) +
         (size_t)(2 * stages + 1) * sizeof(uint64_t);
}

// ------------------------------------------------------------ host side

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The tensor map of one [B, N, H, D] bf16 view with row stride ld (elements;
// the batch stride is N rows): dims {H * D, N, B}, boxes of {32, rows, 1},
// the 64-byte swizzle, rows past N read as zeros. A failed encode returns
// its CUresult (which shares cudaError_t's numbers where both name an
// error).
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int b, int n, int hd,
                            long long ld, int rows) {
  EncodeTiled fn = nullptr;
  cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(bf16),
                                 (cuuint64_t)n * ld * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : (cudaError_t)res;
}

// streaming multiprocessors of `device`, read once a device
inline int sm_count(int device) {
  static int counts[flash::kDevices] = {};
  if (device < flash::kDevices && counts[device] > 0) return counts[device];
  int c = 0;
  if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) c = 1;
  if (device < flash::kDevices) counts[device] = c;
  return c;
}

// Consumer warpgroups a block: two (128 rows a block) where the grid of
// 128-row tiles fills every SM at least once, else one (64 rows), so that a
// small grid (the pooled model's levels) spreads over twice the SMs.
inline int consumer_groups(int b, int heads, int n, int device) {
  const long long tiles = (long long)b * heads * ((n + 2 * kRows - 1) / (2 * kRows));
  return tiles >= sm_count(device) ? 2 : 1;
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the first kAlign-aligned shared address of the dynamic shared memory
__device__ __forceinline__ uint32_t aligned_base(const void* smem) {
  return (smem_u32(smem) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA copies to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed. A wait past 2^34
// cycles (about 9 s) traps: a copy or an arrival that never comes raises a
// launch error in the caller instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Ask for the tile of `rows` rows (the map's box) by D channels from
// (column col, row row, batch row b) into dst, a column block a box, with
// completion on bar.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int b) {
#pragma unroll
  for (int c = 0; c < D / kBox; ++c) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst + c * tile_bytes(ROWS, kBox)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(bar), "r"(col + c * kBox), "r"(row), "r"(b)
        : "memory");
  }
}

// the producer's and the consumers' share of the register file
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// The backward kernels' two consumer warpgroups issue their products in
// turns, so that one's gradient runs under the other's products: warpgroup
// wg waits on named barrier 1 + wg (both warpgroups' 256 threads: its own
// wait and the other's arrival), issues, and passes the turn to the other.
// Warpgroup 1 passes once before its loop, warpgroup 0 waits once after its
// loop, so that every arrival is matched. (In the forward the turns cost
// 2.5% at the prod shape and are left out.)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// wgmma shared-memory descriptor, 64-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// k-step ks (channels 16 ks .. 16 ks + 15) of a K-major tile of `rows` rows
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows, int ks) {
  return descriptor(tile + (ks >> 1) * tile_bytes(rows, kBox) + (ks & 1) * 32, 16);
}

// k-step ks (rows 16 ks .. 16 ks + 15) of an MN-major tile of `rows` rows
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int rows, int ks) {
  return descriptor(tile + ks * 16 * 64, tile_bytes(rows, kBox));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most PENDING committed groups of products are in flight
template <int PENDING = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (after wgmma_wait, before the next use).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define PCB_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PCB_D16(i) PCB_D4(i), PCB_D4(i + 4), PCB_D4(i + 8), PCB_D4(i + 12)
#define PCB_R16                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PCB_R32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PCB_R64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d = (acc ? d : 0) + A . B, A and B K-major in shared memory; d holds N/2
// floats a thread
__device__ __forceinline__ void ss_n32(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PCB_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : PCB_D16(0)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void ss_n64(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PCB_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PCB_D16(0), PCB_D16(16)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void ss_n128(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PCB_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PCB_D16(0), PCB_D16(16), PCB_D16(32), PCB_D16(48)
      : "l"(a), "l"(b), "r"(acc));
}

// d += A . B, A in registers (four bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void rs_n32(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PCB_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : PCB_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void rs_n64(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PCB_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PCB_D16(0), PCB_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef PCB_D4
#undef PCB_D16
#undef PCB_R16
#undef PCB_R32
#undef PCB_R64

// s (N/2 floats) = a . b^T over D channels: a the warpgroup's 64 rows, b a
// tile of N rows, both K-major tiles in shared memory. Issued, not waited.
template <int D, int N>
__device__ __forceinline__ void dot_rows(float (&s)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 32 || N == 64 || N == 128, "N = 32, 64 or 128");
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint64_t da = k_major(a, kRows, ks), db = k_major(b, N, ks);
    if constexpr (N == 128) {
      ss_n128(s, da, db, ks > 0);
    } else if constexpr (N == 64) {
      ss_n64(s, da, db, ks > 0);
    } else {
      ss_n32(s, da, db, ks > 0);
    }
  }
}

// 2^x in float32 on the SFU (ex2.approx.ftz: within 2 ulp, as exp2f; a
// result below 2^-126 is 0, where exp2f would take extra instructions to
// keep it subnormal)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two float32 -> two bf16 in one register, lo in the lower half (nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A operand of a second product from the accumulator of a first one
// (K/2 floats a thread over K columns), rounded to bf16: a[s] is k-step s.
template <int K>
__device__ __forceinline__ void to_operand(const float (&w)[K / 2], uint32_t (&a)[K / 16][4]) {
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[s][r] = pack_bf16(w[8 * s + 2 * r], w[8 * s + 2 * r + 1]);
  }
}

// acc (N/2 floats a thread over N channels) += w . x: w the A operand of K
// rows (to_operand), x the MN-major tile of those K rows (`rows` rows in
// all) from its first channel on. Issued after a fence; the caller commits
// (a group, empty where a fault planted by probes/bf16_fault_probe.py
// skips the call) and waits.
template <int N, int K>
__device__ __forceinline__ void weighted_rows(float (&acc)[N / 2], const uint32_t (&w)[K / 16][4],
                                              uint32_t x, int rows) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const uint64_t b = mn_major(x, rows, s);
    const uint64_t block = tile_bytes(rows, kBox) >> 4;  // a column block, in 16 bytes
#pragma unroll
    for (int c = 0; c < N / 64; ++c) rs_n64(acc + 32 * c, w[s], b + 2 * c * block);
    if constexpr (N % 64 != 0) rs_n32(acc + 32 * (N / 64), w[s], b + 2 * (N / 64) * block);
  }
}

}  // namespace flash_bf16
