// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (conv3x3.cu, attention_gate.cu), written by hand from inline PTX: mbarriers,
// TMA tiled loads and stores, the wgmma shared-memory descriptors and the
// wgmma.mma_async instruction for the widths the two kernels use.
//
// Which TPU mechanism each replaces. The Pallas kernels
// (unet_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas,
// unet_tpu/ops/pallas/attention_gate.py::attention_gate_fused) let BlockSpec index
// maps cut the arrays into VMEM blocks and hand whole blocks to the 128 x 128 MXU
// through jnp.dot. Here the TMA unit takes the BlockSpec's place (one thread asks
// for a box of a tensor described once on the host; the hardware computes the
// addresses, zero-fills what lies outside the tensor and reports the bytes to an
// mbarrier), and wgmma takes the MXU's (four warps start an asynchronous
// 64 x N x 16 product whose operands are read from shared memory through a 64-bit
// descriptor and whose f32 sum stays in registers).
//
// What bounds kernels built from these on an H100: the tensor cores only run at
// their rate when shared memory is refilled behind them without the warps that
// start the products spending instructions on it. Hence the shape both kernels
// share: persistent blocks; rings of stages in shared memory; one producer thread
// (a warp of its own) that keeps TMA loads in flight against "empty" barriers,
// across tile boundaries; two consumer warpgroups that wait on "full" barriers,
// start wgmma and release a stage one group behind. Registers come from the
// launch bound alone (288 threads a block), so there is no setmaxnreg here.
//
// Layout rules the helpers assume (a mismatch gives wrong numbers silently, which
// is what the on-card comparison with the plain versions is for):
//   * every TMA destination and wgmma operand tile starts on a 1024-byte boundary
//     (the 128-byte swizzle repeats every 8 rows of 128 bytes);
//   * an operand tile is rows of 64 bf16 (128 bytes) written by TMA with
//     CU_TENSOR_MAP_SWIZZLE_128B, or by threads at swizzle128_offset();
//   * A (pixels x channels) is K-major: the row is a pixel, its 128 bytes are 64
//     channels. B (channels x outputs, as the weights lie in memory) is MN-major:
//     the row is one input channel, its 128 bytes are 64 output channels, and
//     blocks of 64 outputs lie `lbo` bytes apart; the instruction transposes it.
//
// Host side: cuTensorMapEncodeTiled lives in libcuda. Its address is fetched with
// cudaGetDriverEntryPoint, so the libraries link against the runtime only.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ------------------------------------------------------------------ addresses

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a tile of 128-byte
// rows under the 128-byte swizzle (what TMA's SWIZZLE_128B writes and wgmma's
// layout type 1 reads): the chunk index is XORed with the row index modulo 8.
__device__ __forceinline__ uint32_t swizzle128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic still to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`. A barrier starts in phase
// 0, so a consumer's first wait passes parity 0 and a producer's first wait on an
// "empty" barrier passes parity 1 (and falls through).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A position in a ring of N stages: the stage and the parity of its round. A
// consumer starts at phase 0, a producer at phase 1 (the ring starts empty).
template <int N>
struct RingPos {
  int stage = 0;
  uint32_t phase;
  __device__ explicit RingPos(uint32_t first_phase) : phase(first_phase) {}
  // `by` divides `wrap`, so a group of `by` stages never straddles the end
  __device__ __forceinline__ void advance(int wrap = N, int by = 1) {
    stage += by;
    if (stage == wrap) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------------------------ TMA

// Tiled loads: the box the tensor map describes, with its corner at the given
// coordinates (innermost first; may be negative or past the end: what lies outside
// the tensor arrives as zeros), lands at `dst` and its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Tiled store of a box from shared memory; what falls outside the tensor is
// dropped. Threads that wrote the box call fence_proxy_async() and meet at a
// barrier first; the storing thread then commits and waits before the shared
// memory is reused or the block exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's committed stores still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Makes shared-memory writes of ordinary stores visible to the asynchronous units
// (TMA stores, wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads of the block.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// The 14-bit descriptor fields hold byte quantities in units of 16.
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

constexpr uint64_t kDescSwizzle128 = 1ull << 62;

// K-major operand under the 128-byte swizzle: rows of 128 bytes starting at
// `first_row`, groups of 8 rows `group_bytes` apart (stride byte offset); the
// leading byte offset is not used. The next 16 channels (one k16 step) lie 32
// bytes on: add kDescKStepA. `first_row` may be any 128-byte row of a swizzled
// region (a shifted window of a larger tile TMA wrote) if `group_bytes` is a
// multiple of 1024: the unit applies the swizzle to the absolute shared-memory
// address (bits 4-6 XOR bits 7-9), exactly as TMA did when it wrote the region, so
// a window that starts off a 1024-byte boundary reads the right chunks with the
// base-offset field left 0 (measured on an H100: setting it to (address >> 7) & 7
// gives wrong numbers for every shifted window, 0 gives the right ones).
__device__ __forceinline__ uint64_t desc_k_major_at(const void* first_row,
                                                    uint32_t group_bytes) {
  return desc_field(smem_u32(first_row)) | (desc_field(16) << 16) |
         (desc_field(group_bytes) << 32) | kDescSwizzle128;
}
// A whole tile: 8-row groups packed 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return desc_k_major_at(tile, 1024);
}
constexpr uint64_t kDescKStepA = 32 >> 4;

// MN-major tile under the 128-byte swizzle: each row is one k with 64 outputs in
// its 128 bytes; groups of 8 k are 1024 bytes apart (stride byte offset) and blocks
// of 64 outputs `lbo_bytes` apart (leading byte offset). One k16 step is two groups
// on: add kDescKStepB.
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, uint32_t lbo_bytes) {
  return desc_field(smem_u32(tile)) | (desc_field(lbo_bytes) << 16) |
         (desc_field(1024) << 32) | kDescSwizzle128;
}
constexpr uint64_t kDescKStepB = 2048 >> 4;

// Orders register and shared-memory accesses before the first wgmma of a batch.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across an asynchronous
// product's start or completion.
template <int R>
__device__ __forceinline__ void fence_accumulator(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, N/2 registers a thread) = A (64 x 16 bf16, K-major) . B (16 x N
// bf16, MN-major) + (scale_d ? D : 0). Thread t of the warpgroup holds, for
// j = 0 .. N/8 - 1, d[4j], d[4j+1] = row 16*(t/32) + (t%32)/4, columns
// 8j + 2*(t%4) and +1, and d[4j+2], d[4j+3] = the same columns eight rows down.

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "widths the kernels use");
  if constexpr (N == 64) wgmma_m64n64k16(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16(d, desc_a, desc_b, scale_d);
  if constexpr (N == 256) wgmma_m64n256k16(d, desc_a, desc_b, scale_d);
}

// ------------------------------------------------------------------ host

// Multiprocessors of the current device (the size of a persistent grid), or 0.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the loaded libcuda, or null.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Describes a bf16 tensor of `rank` (2..5) dimensions to TMA: dims innermost
// first, strides_bytes for dimensions 1 .. rank-1 (multiples of 16), box the tile
// one load or store moves (at most 256 per dimension; 64 innermost under the
// 128-byte swizzle). Outside the tensor, loads read zeros and stores write nothing.
inline cudaError_t make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                        const uint64_t* dims,
                                        const uint64_t* strides_bytes,
                                        const uint32_t* box, bool swizzle128) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = strides_bytes[i - 1];
  }
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), gdim, gstride, bdim, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
