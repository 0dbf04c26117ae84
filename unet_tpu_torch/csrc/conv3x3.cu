// 3x3 stride-1 SAME convolution (no bias) as an implicit GEMM for Hopper
// (sm_90a), with an optional per-channel affine + ReLU epilogue.
//
// Replaces the Pallas TPU kernel
//   unet_tpu/ops/pallas/conv3x3.py::_conv3x3_pallas
// reached from conv3x3 (forward, and the data gradient of its custom VJP, which
// is this same convolution on the rot180, channel-transposed weights) and from
// conv3x3_bn_relu (the eval epilogue). For x (N, H, W, Cin) in NHWC memory (torch
// channels_last) and weights k (3, 3, Cin, Cout) already cast to x's type:
//
//   acc[n, y, x, o] = sum_{dy, dx, c} xpad[n, y + dy, x + dx, c] * k[dy, dx, c, o]
//   out             = T(relu?(acc * mul[o] + add[o]))       (affine optional)
//
// with every product exact in f32 and every sum taken in f32, and one rounding to
// the input type T at the end: the rounding points of the TPU kernel
// (preferred_element_type=f32, then acc.astype(out_dtype)). The affine is a
// separate f32 multiply and add (__fmul_rn, __fadd_rn), as the plain version
// (unet_tpu_torch/ops/conv3x3.py::conv3x3_plain) computes it.
//
// What bounds it on an H100: operations at most of AttentionUNet-64's levels. Per
// output pixel it does 2*9*Cin*Cout flops and must move Cin + Cout values; at the
// 512^2 / 64-channel level that is 288 bf16 flops per byte, right at the card's
// balance point (989 TFLOP/s over 3.35 TB/s = 295), and every deeper level has more
// channels per pixel and is bound by the tensor cores. Two limits lie between
// device memory and the tensor cores, and both were measured to bind before this
// design: the operand traffic from L2 into shared memory (a version that loaded
// one shifted 128-pixel box per tap ran every shape at the same rate of L2 reads,
// whatever its tile), and, where Cout = 64, shared-memory bandwidth itself (a
// m64n64k16 product reads 4 KB of operands for 32 cycles of tensor-core work).
//
// What the design does about it (bf16, the main path's type; building blocks in
// hopper.cuh). A tile is 8 rows x 16 columns = 128 output pixels of one image by
// BN output channels, BN = 256, 128 or 64 by what divides Cout (the wider the
// tile, the fewer operand bytes per flop). Blocks are persistent: one per
// multiprocessor, each walking tiles blockIdx.x, + gridDim.x, ... The K loop walks
// Cin in chunks of 64 channels and, inside a chunk, the 9 taps, through two rings
// of stages in shared memory fed by one producer thread with TMA:
//   * the halo ring: per chunk ONE 4-D box load of x at (c0, x0 - 1, y0 - 1, n),
//     10 rows x 24 columns of pixels x 64 channels. The hardware zero-fills the
//     SAME padding on the low side and whatever a ragged last tile leaves on the
//     high side, so any N, H, W >= 1 works with no address arithmetic in the
//     kernel. All 9 taps read their shifted 8 x 16 window out of this one copy,
//     which cuts x's traffic from L2 ninefold: wgmma's descriptor may start at
//     any 128-byte row of a swizzled region, because the swizzle is a function of
//     the absolute shared-memory address (hopper.cuh, desc_k_major_at), as long
//     as the 8-row groups lie a multiple of 1024 bytes apart. Hence the halo's
//     row pitch of 24 pixels (3072 bytes; 18 are needed), and hence warpgroup wg
//     owns the tile's columns 8*wg .. 8*wg+7 in all 8 rows: its 64 product rows
//     are 8 groups of 8 consecutive halo pixels, one halo row apart;
//   * the weight ring: per chunk and tap, BN / 64 2-D box loads of the weights
//     seen as (9 * Cin, Cout). Where Cout = BN and all 9 * Cin / 64 boxes fit the
//     ring (64 -> 64: 72 KB; 128 -> 64: 144 KB), they are loaded for the block's
//     first tile and stay for all its tiles.
// Two consumer warpgroups wait on the stages' "full" mbarriers, start four
// wgmma m64nBNk16 per tap (A K-major from the halo, B MN-major as the weights lie
// in memory), commit, wait one group behind and release the stages before
// through their "empty" mbarriers. At BN = 64 a tap is only 2 x 128 cycles of
// tensor-core work, less than the consumer warps need from one group's end to the
// next one's start, so there three taps go into one group (measured: 0.36 ms ->
// 0.29 ms at 512^2 64 -> 64; the whole chunk in one group is slower again, as is
// grouping at BN = 128). The producer runs ahead into the next tile
// while they are in the epilogue. The epilogue runs on the accumulator registers
// (affine, ReLU, one rounding), writes the bf16 tile 64 channels at a time into a
// staging block in the swizzled layout, and one thread stores it with TMA, which
// also clips the ragged edge. Registers: 288 threads, one block per SM, so the
// launch bound alone gives each thread up to 224 (BN = 256 keeps 128
// accumulators); no setmaxnreg. Tried and dropped: blocks of one tile each
// (slower at every shape: every block paid the rings' start-up), and two
// pairs of warpgroups taking turns on alternate tiles so one's epilogue hides
// under the other's products (slower at every shape: at Cout = 64 the K loop, not
// the epilogue, fills the time). The TPU kernel's tap packing (K = 3*Cin,
// N = 3*Cout with shifted adds, to fill the 128 x 128 MXU) and its W padding have
// no counterpart here.
//
// The float32 variant (for tight checks; no TF32, which would change the numbers)
// is a register-blocked FMA loop on the CUDA cores: 64 pixels x 64 channels per
// block of 256 threads, 4 x 4 outputs per thread, K chunks of 16 channels.
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libconv3x3.so conv3x3.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float epilogue(float v, const float* mul, const float* add,
                                          int o, int relu) {
  if (mul != nullptr) v = __fadd_rn(__fmul_rn(v, mul[o]), add[o]);
  return relu ? fmaxf(v, 0.f) : v;
}

// ---------------------------------------------------------------- bf16 (wgmma)

constexpr int kTileH = 8;                  // output rows per tile
constexpr int kTileW = 16;                 // output columns per tile: 8 per warpgroup
constexpr int kBM = kTileH * kTileW;       // 128 output pixels
constexpr int kBK = 64;                    // input channels per chunk: 128-byte rows
constexpr int kHaloH = kTileH + 2;         // input rows a tile's taps touch
constexpr int kHaloW = 24;                 // 18 input columns, padded so that a row
                                           // of the halo is 3 x 1024 bytes
constexpr int kHaloBytes = kHaloH * kHaloW * kBK * 2;  // 30 KB
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer's warp
constexpr int kBBlockBytes = kBK * 64 * 2; // 64 k x 64 outputs: 8 KB
constexpr int kOutBlockBytes = kBM * 128;  // 128 pixels x 64 outputs: 16 KB
static_assert(kHaloBytes % 1024 == 0 && (kHaloW * 128) % 1024 == 0, "swizzle phase");

// Halo ring, weight ring, output staging blocks, barriers.
template <int BN, int AST, int BST, int NOUT>
__host__ __device__ constexpr int smem_bytes() {
  return AST * kHaloBytes + BST * (BN / 64) * kBBlockBytes + NOUT * kOutBlockBytes +
         16 * (AST + BST);
}

struct Tile {
  int img, y0, x0, n0;
};

// Tiles are numbered with the channel block fastest, then the tile column, the
// tile row and the image, so the tiles in flight at one time are neighbours in x
// and share the weights' channel blocks in L2.
template <int BN>
__device__ __forceinline__ Tile decode_tile(int t, int tiles_x, int tiles_y, int cout) {
  const int n_blocks = cout / BN;
  Tile tile;
  tile.n0 = (t % n_blocks) * BN;
  t /= n_blocks;
  tile.x0 = (t % tiles_x) * kTileW;
  t /= tiles_x;
  tile.y0 = (t % tiles_y) * kTileH;
  tile.img = t / tiles_y;
  return tile;
}

// BN output channels a tile; AST halo stages, BST weight stages, NOUT staging
// blocks for the output; G taps' products go into one wgmma group (a group is the
// unit the consumers wait for and release). One block on an SM.
template <int BN, int AST, int BST, int NOUT, int G>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap omap,
                        const float* __restrict__ mul, const float* __restrict__ add,
                        int tiles_x, int tiles_y, int n_tiles, int cin, int cout,
                        int relu) {
  using namespace hopper;
  constexpr int kBBytes = (BN / 64) * kBBlockBytes;
  static_assert((BN / 64) % NOUT == 0, "staging blocks are used in turn");
  static_assert(9 % G == 0 && BST % G == 0, "groups of taps tile the weight ring");

  extern __shared__ __align__(1024) unsigned char halos[];
  unsigned char* weights = halos + AST * kHaloBytes;
  unsigned char* staging = weights + BST * kBBytes;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(staging + NOUT * kOutBlockBytes);
  uint64_t* a_empty = a_full + AST;
  uint64_t* b_full = a_empty + AST;
  uint64_t* b_empty = b_full + BST;

  const int chunks = cin / kBK;
  const int ksteps = 9 * chunks;
  // All of a channel block's weights fit the weight ring and every tile of this
  // block wants the same ones: they are loaded for the first tile and stay.
  const bool resident = ksteps <= BST && cout == BN;
  const int b_wrap = resident ? ksteps : BST;

  if (threadIdx.x == 0) {
    for (int s = 0; s < AST; ++s) {
      mbar_init(a_full + s, 1);   // the producer's arrive.expect_tx
      mbar_init(a_empty + s, 2);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < BST; ++s) {
      mbar_init(b_full + s, 1);
      mbar_init(b_empty + s, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    // One thread walks this block's tiles and keeps both rings full: the next
    // tile's halo and first weights load while the consumers are in this tile's
    // epilogue.
    if (threadIdx.x == kConsumers) {
      RingPos<AST> ap(1);  // the rings start empty
      RingPos<BST> bp(1);
      bool first = true;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = decode_tile<BN>(t, tiles_x, tiles_y, cout);
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(a_empty + ap.stage, ap.phase);
          mbar_arrive_expect_tx(a_full + ap.stage, kHaloBytes);
          tma_load_4d(halos + ap.stage * kHaloBytes, &xmap, a_full + ap.stage, c * kBK,
                      tile.x0 - 1, tile.y0 - 1, tile.img);
          ap.advance();
          if (resident && !first) continue;
          for (int tap = 0; tap < 9; ++tap) {
            unsigned char* b = weights + bp.stage * kBBytes;
            mbar_wait(b_empty + bp.stage, bp.phase);
            mbar_arrive_expect_tx(b_full + bp.stage, kBBytes);
#pragma unroll
            for (int jb = 0; jb < BN / 64; ++jb)
              tma_load_2d(b + jb * kBBlockBytes, &wmap, b_full + bp.stage,
                          tile.n0 + 64 * jb, tap * cin + c * kBK);
            bp.advance(b_wrap);
          }
        }
        first = false;
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    // Warpgroup wg owns the tile's columns 8*wg .. 8*wg+7 in all 8 rows: its 64
    // product rows are 8 groups (one per tile row) of 8 consecutive halo pixels,
    // a halo row (3072 bytes) apart.
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    const int prow = (tw >> 5) * 16 + ((tw & 31) >> 2);  // product row, and +8
    // its pixel's row in the [8][16] staging block (the one below: + 16)
    const int srow = (prow >> 3) * kTileW + wg * 8 + (prow & 7);
    const int q = tw & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    RingPos<AST> ap(0);
    RingPos<BST> bp(0);
    int held_a = -1, held_b = -1;  // stages whose products may still be running
    bool first = true;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tile = decode_tile<BN>(t, tiles_x, tiles_y, cout);
      for (int c = 0; c < chunks; ++c) {
        const unsigned char* halo = halos + ap.stage * kHaloBytes;
        mbar_wait(a_full + ap.stage, ap.phase);
        for (int tap0 = 0; tap0 < 9; tap0 += G) {
          if (!resident || first) {
#pragma unroll
            for (int g = 0; g < G; ++g) mbar_wait(b_full + bp.stage + g, bp.phase);
          }
          fence_accumulator(acc);
          wgmma_fence();
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int tap = tap0 + g;
            const int dy = tap / 3, dx = tap - 3 * dy;
            const uint64_t da = desc_k_major_at(
                halo + ((dy * kHaloW) + dx + 8 * wg) * 128, kHaloW * 128);
            const uint64_t db =
                desc_mn_major(weights + (bp.stage + g) * kBBytes, kBBlockBytes);
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_k16<BN>(acc, da + kk * kDescKStepA, db + kk * kDescKStepB,
                            (c | tap | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the group before has finished reading its stages
          if (tw == 0) {
            if (held_b >= 0) {
#pragma unroll
              for (int g = 0; g < G; ++g) mbar_arrive(b_empty + held_b + g);
            }
            if (held_a >= 0) mbar_arrive(a_empty + held_a);
          }
          held_b = resident ? -1 : bp.stage;
          held_a = tap0 + G == 9 ? ap.stage : -1;
          bp.advance(b_wrap, G);
        }
        ap.advance();
      }
      wgmma_wait<0>();
      fence_accumulator(acc);
      if (tw == 0) {
        if (held_b >= 0) {
#pragma unroll
          for (int g = 0; g < G; ++g) mbar_arrive(b_empty + held_b + g);
        }
        if (held_a >= 0) mbar_arrive(a_empty + held_a);
      }
      held_a = held_b = -1;
      first = false;

      // epilogue on the registers, 64 channels at a time: the bf16 block goes to
      // a staging block as [128 pixels][64 channels], swizzled as TMA expects,
      // once the store that last used that block has read it
#pragma unroll
      for (int jb = 0; jb < BN / 64; ++jb) {
        unsigned char* blk = staging + (jb % NOUT) * kOutBlockBytes;
        if (threadIdx.x == 0) tma_store_wait_read<NOUT - 1>();
        named_barrier_sync(1, kConsumers);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = jb * 8 + jj;
          const int o = tile.n0 + 8 * j + 2 * q;
          const __nv_bfloat162 top =
              __floats2bfloat162_rn(epilogue(acc[4 * j], mul, add, o, relu),
                                    epilogue(acc[4 * j + 1], mul, add, o + 1, relu));
          const __nv_bfloat162 bot =
              __floats2bfloat162_rn(epilogue(acc[4 * j + 2], mul, add, o, relu),
                                    epilogue(acc[4 * j + 3], mul, add, o + 1, relu));
          *reinterpret_cast<__nv_bfloat162*>(blk + swizzle128_offset(srow, jj) + 4 * q) =
              top;
          *reinterpret_cast<__nv_bfloat162*>(blk + swizzle128_offset(srow + kTileW, jj) +
                                             4 * q) = bot;
        }
        fence_proxy_async();
        named_barrier_sync(1, kConsumers);
        if (threadIdx.x == 0) {
          tma_store_4d(&omap, blk, tile.n0 + 64 * jb, tile.x0, tile.y0, tile.img);
          tma_store_commit();
        }
      }
    }
    if (threadIdx.x == 0) tma_store_wait_read<0>();
  }
}

template <int BN, int AST, int BST, int NOUT, int G>
cudaError_t launch_bf16(const void* x, const void* wk, const float* mul, const float* add,
                        void* out, int n, int h, int w, int cin, int cout, int relu,
                        cudaStream_t stream) {
  CUtensorMap xmap, wmap, omap;
  const uint32_t halo_box[4] = {kBK, kHaloW, kHaloH, 1};
  const uint32_t out_box[4] = {64, kTileW, kTileH, 1};
  const uint64_t xdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(w),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t xstrides[3] = {xdims[0] * 2, xdims[0] * xdims[1] * 2,
                                xdims[0] * xdims[1] * xdims[2] * 2};
  const uint64_t odims[4] = {static_cast<uint64_t>(cout), xdims[1], xdims[2], xdims[3]};
  const uint64_t ostrides[3] = {odims[0] * 2, odims[0] * odims[1] * 2,
                                odims[0] * odims[1] * odims[2] * 2};
  const uint64_t wdims[2] = {static_cast<uint64_t>(cout), 9ull * cin};
  const uint64_t wstrides[1] = {wdims[0] * 2};
  const uint32_t wbox[2] = {64, kBK};
  cudaError_t err =
      hopper::make_tensor_map_bf16(&xmap, x, 4, xdims, xstrides, halo_box, true);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map_bf16(&wmap, wk, 2, wdims, wstrides, wbox, true);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map_bf16(&omap, out, 4, odims, ostrides, out_box, true);
  if (err != cudaSuccess) return err;

  auto kernel = conv3x3_bf16_kernel<BN, AST, BST, NOUT, G>;
  constexpr int smem = smem_bytes<BN, AST, BST, NOUT>();
  static_assert(smem <= 232448, "a block's shared memory on sm_90");
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const long long tiles = static_cast<long long>(n) * tiles_y * tiles_x * (cout / BN);
  const int sms = hopper::sm_count();
  if (tiles > INT_MAX || sms <= 0) return cudaErrorInvalidValue;
  // persistent blocks: one on each multiprocessor, each walking tiles
  const long long blocks = tiles < sms ? tiles : sms;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      xmap, wmap, omap, mul, add, tiles_x, tiles_y, static_cast<int>(tiles), cin, cout,
      relu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32 (FMA)

constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                       const float* __restrict__ mul, const float* __restrict__ add,
                       float* __restrict__ out, int n, int h, int w, int cin, int cout,
                       int relu) {
  __shared__ float as[kFK][kFM + 4];  // K-major: as[k][pixel]
  __shared__ float bs[kFK][kFN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channels tx*4 .. +3
  const int ty = tid >> 4;  // pixels ty*4 .. +3
  const long long plane = static_cast<long long>(h) * w;
  const long long m_total = plane * n;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;

  // A loads: pixel p = tid/4, channels q*4 .. +3 of the chunk
  const int p = tid >> 2;
  const int q = tid & 3;
  const long long m = m0 + p;
  const bool pin = m < m_total;
  const long long mm = pin ? m : 0;
  const long long img = mm / plane;
  const long long rem = mm - img * plane;
  const int py = static_cast<int>(rem / w);
  const int px = static_cast<int>(rem - static_cast<long long>(py) * w);
  const long long pimg = img * plane;
  // B loads: row r = tid/16, channels c4*4 .. +3
  const int r = tid >> 4;
  const int c4 = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int chunks = cin / kFK;
  for (int ks = 0; ks < 9 * chunks; ++ks) {
    const int tap = ks / chunks;
    const int c0 = (ks - tap * chunks) * kFK;
    const int ys = py + tap / 3 - 1;
    const int xs = px + tap % 3 - 1;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pin && ys >= 0 && ys < h && xs >= 0 && xs < w)
      av = *reinterpret_cast<const float4*>(
          x + ((pimg + static_cast<long long>(ys) * w + xs) * cin + c0 + q * 4));
    as[q * 4 + 0][p] = av.x;
    as[q * 4 + 1][p] = av.y;
    as[q * 4 + 2][p] = av.z;
    as[q * 4 + 3][p] = av.w;
    *reinterpret_cast<float4*>(&bs[r][c4 * 4]) = *reinterpret_cast<const float4*>(
        wk + (static_cast<long long>(tap * cin + c0 + r) * cout + n0 + c4 * 4));
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int o = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long mo = m0 + ty * 4 + i;
    if (mo >= m_total) continue;
    float4 v;
    v.x = epilogue(acc[i][0], mul, add, o + 0, relu);
    v.y = epilogue(acc[i][1], mul, add, o + 1, relu);
    v.z = epilogue(acc[i][2], mul, add, o + 2, relu);
    v.w = epilogue(acc[i][3], mul, add, o + 3, relu);
    *reinterpret_cast<float4*>(out + mo * cout + o) = v;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as void*). dtype 0 = float32, 1 = bfloat16.
// x (N, H, W, Cin) and out (N, H, W, Cout) contiguous NHWC in that type, wk
// (3, 3, Cin, Cout) contiguous in that type, mul/add (Cout,) float32 or both null,
// relu 0/1. Cin and Cout multiples of 64; every pointer 16-byte aligned. Returns the
// launch's cudaError_t (0 on success); never synchronises.
int conv3x3_launch(int dtype, const void* x, const void* wk, const void* mul,
                   const void* add, void* out, int n, int h, int w, int cin, int cout,
                   int relu, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (cin <= 0 || cout <= 0 || cin % 64 || cout % 64 || (mul == nullptr) != (add == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(mul);
  const float* fa = static_cast<const float*>(add);
  if (dtype == 1) {
    // The widest tile that divides Cout (every multiple of 64 has one), with the
    // stages that fit 227 KB: <BN, halo stages, weight stages, staging blocks,
    // taps per wgmma group>. At BN = 64 the 18 weight stages hold all of a
    // 64- or 128-channel input's weights, which then stay resident.
    if (cout % 256 == 0)
      return static_cast<int>(
          launch_bf16<256, 2, 4, 2, 1>(x, wk, fm, fa, out, n, h, w, cin, cout, relu, s));
    if (cout % 128 == 0)
      return static_cast<int>(
          launch_bf16<128, 3, 6, 2, 1>(x, wk, fm, fa, out, n, h, w, cin, cout, relu, s));
    return static_cast<int>(
        launch_bf16<64, 2, 18, 1, 3>(x, wk, fm, fa, out, n, h, w, cin, cout, relu, s));
  }
  if (dtype == 0) {
    const long long m = static_cast<long long>(n) * h * w;
    const long long blocks = (m + kFM - 1) / kFM;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), cout / kFN);
    conv3x3_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk), fm, fa,
        static_cast<float*>(out), n, h, w, cin, cout, relu);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
