// Fused eval-mode attention gate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   unet_tpu/ops/pallas/attention_gate.py::attention_gate_fused
// (body _gate_kernel). With BatchNorm folded into the 1x1 convs it computes,
// per output pixel of the skip map x (NHWC memory = torch channels_last):
//
//   g_up = bilinear_align_corners(g)             (rounded to T after W, then H)
//   t    = relu(g_up . wg + x . wx + badd)       (f32 accumulation, rounded to T)
//   att  = sigmoid(t . wpsi + bpsi)              (f32, rounded to T)
//   out  = x * att
//
// with T the compute type. Two kernels: bf16 (the main path) rounds at the points
// _gate_kernel has, so it computes the same function as the TPU one; f32 (for
// tight checks) rounds nowhere but in its f32 arithmetic.
//
// What bounds it on an H100: bytes. Per output pixel it reads Cx + Cg/4 channels
// and writes Cx, and does 2*(Cg+Cx)*I flops (I = inter channels = Cx/2). In bf16
// that is ~60 flops per byte for the largest gate, far under the card's balance
// point of 295: at 512^2, batch 8, ~1.13 GB moved = ~0.34 ms at 3.35 TB/s against
// ~0.07 ms of tensor-core math. It only stays bound by bytes if the products run
// on the tensor cores (the same 69 GFLOP take ~1 ms as f32 FMAs) and if nothing
// but g, x and out touches device memory.
//
// What the bf16 design does about it (building blocks in hopper.cuh). A tile is
// 8 rows x 16 columns = 128 output pixels of one image with the whole of I
// (padded to NP = 64, 128 or 256, each a wgmma width), so t lives only in the
// accumulator registers; an I beyond 256 is walked in chunks of 256, the K loop
// once per chunk, psi summed over them. Blocks are persistent, each walking tiles
// blockIdx.x, + gridDim.x, ... K = Cg + Cx is walked in chunks of 64 channels
// through a ring of stages fed by one producer thread with TMA, which runs ahead
// into the next tile while the consumers finish this one:
//   * a g chunk brings the 6 x 10 source pixels the tile's taps touch (a 4-D box
//     of g, read once per tile instead of four gathers per output element) and the
//     chunk's 64 rows of wg. Each of the two consumer warpgroups interpolates its
//     64 pixels (4 rows x 16 columns) from it, along W then along H with the
//     rounding to bf16 after each, 16 bytes (8 channels) a thread at a time,
//     straight into the swizzled K-major layout wgmma reads: NHWC memory already
//     is K-contiguous, so nothing is transposed;
//   * an x chunk is one 4-D box of x written by TMA in that same layout, with the
//     chunk's 64 rows of wx;
//   * either way each warpgroup starts four wgmma m64nNPk16 on its 64 pixels
//     (A K-major, the weights MN-major as they lie in memory), commits, and
//     releases the stage one group behind. The warpgroups share the ring and
//     nothing else: each has its own taps, barrier and attention values.
// Channels past Cg, Cx or I in a last chunk arrive as zeros (TMA fills what lies
// outside a tensor). The epilogue runs on the registers: round(relu(acc + badd))
// (one cvt.rn.relu.bf16x2 for two values) times wpsi, both read as f32 pairs from
// a table staged in shared memory once per block, summed over a thread's columns,
// two shuffles across the four lanes that share a row, sigmoid, one rounding.
// out = x * att then re-reads the tile's x, 16 bytes a thread and four loads in
// flight, and multiplies in bf16 (one rounding, as the f32 product rounded): the
// tile was loaded microseconds before and is still in L2, so device memory sees x
// once (keeping it resident instead would cost up to 128 KB of shared memory at
// Cx = 512).
//
// Blocks on an SM and ring depth, settled by timing variants at AttentionUNet-64's
// gates (b8, H100): with the products on the tensor cores the narrow gates are
// bound by how well the interpolation, the epilogue and the final multiply of one
// block overlap the loads of another, and registers decide that. NP = 64 runs two
// blocks of two stages on an SM (three blocks, capped at 72 registers a thread,
// were slower), NP = 128 one block of four stages (two blocks of two were slower),
// NP = 256 one block of three stages (its 128 accumulators need the registers and
// a stage is 56 KB). Tried and dropped, each slower: asking TMA to prefetch the
// block's next tile into L2, and skipping the fourth source row of the
// interpolation where a tile touches three (the branch costs more than the row).
// Applying W_g at low resolution (exact by linearity) would move a rounding point
// and buys nothing once the kernel is bound by bytes; it is left out.
//
// The bf16 kernel takes shapes with exactly 2x upsampling per axis (what the
// model's guard, fused_shapes_supported, admits) and Cg, Cx, I multiples of 8
// (16-byte rows for TMA; the wrapper pads all three with zeros, which is exact
// for the reason above); the launch function refuses the rest. The float32 kernel
// (for tight checks) is the first version's: a register-blocked f32 FMA loop on the
// CUDA cores over a tile staged K-major in shared memory; it takes any shape.
//
// Row bands. The height-sharded forward (core/spatial.py) asks for rows
// [y_off, y_off + h_out) of the output of a map h_out_full rows high, with g
// holding rows [g_off, g_off + h_in) of a source h_in_full rows high (at least
// the rows those output rows read). Every tap is computed on the global rows,
// with the same float arithmetic as the whole map's, so a band's output equals
// those rows of the whole map's bit for bit. A whole map is the band y_off =
// g_off = 0, h_in_full = h_in, h_out_full = h_out.
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libattention_gate.so attention_gate.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- f32 (FMA)

constexpr int kThreads = 256;  // 16 pixel groups x 16 inter-channel groups
constexpr int kKC = 32;        // weight rows staged per step
constexpr size_t kMaxTileBytes = 96 * 1024;  // budget for the staged tile

template <int N> struct alignas(sizeof(float) * N) Vec { float v[N]; };

// Where a band of rows lies in the whole map (see the note at the head).
struct Band {
  int y_off;   // global row of x's and out's first row
  int g_off;   // global row of g's first row
  int g_last;  // the whole source's last row, h_in_full - 1
};

__host__ __device__ constexpr int tile_stride(int tp, int pt) {
  // Row stride of the K-major tile: padded off a multiple of 32 words to spread
  // the transposed stores over banks, and a multiple of PT for vector loads.
  return tp + (pt > 2 ? pt : 2);
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

template <int PT>
__host__ __device__ constexpr size_t tile_bytes(int kp) {
  return align16(static_cast<size_t>(kp) * tile_stride(16 * PT, PT) * sizeof(float));
}

template <int PT, int IPT>
__host__ __device__ constexpr size_t smem_bytes(int kp) {
  // tile + weight chunk + per-pixel taps (2 row offsets, 2 columns, 4 weights)
  // + per-pixel attention
  return tile_bytes<PT>(kp) + sizeof(float) * kKC * 16 * IPT +
         16 * PT * (2 * sizeof(long long) + 2 * sizeof(int) + 5 * sizeof(float));
}

// A tile of 16 * PT output pixels per block; each thread accumulates PT pixels
// x IPT inter channels, walking I in chunks of 16 * IPT.
template <int PT, int IPT>
__global__ void __launch_bounds__(kThreads)
gate_f32_kernel(const float* __restrict__ g, const float* __restrict__ x,
                const float* __restrict__ wg, const float* __restrict__ wx,
                const float* __restrict__ badd, const float* __restrict__ wpsi,
                const float* __restrict__ bpsi, float* __restrict__ out, int n,
                int h_in, int w_in, int h_out, int w_out, int cg, int cx, int inter,
                Band band, float scale_h, float scale_w) {
  constexpr int TP = 16 * PT;
  constexpr int IC = 16 * IPT;
  constexpr int TPS = tile_stride(TP, PT);
  const int K = cg + cx;
  const int Kp = (K + kKC - 1) / kKC * kKC;

  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [Kp][TPS]: rows [0,cg) g_up, [cg,K) x
  float* Bs = reinterpret_cast<float*>(smem + tile_bytes<PT>(Kp));  // [kKC][IC]
  long long* row = reinterpret_cast<long long*>(Bs + kKC * IC);     // [TP][2]
  int* col = reinterpret_cast<int*>(row + 2 * TP);                  // [TP][2]
  float* wts = reinterpret_cast<float*>(col + 2 * TP);              // [TP][4]
  float* att_s = wts + 4 * TP;                                      // [TP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // inter-channel group
  const int ty = tid >> 4;  // pixel group
  const long long hw = static_cast<long long>(h_out) * w_out;
  const long long npix = n * hw;
  const long long p0 = static_cast<long long>(blockIdx.x) * TP;
  const int valid = static_cast<int>(npix - p0 < TP ? npix - p0 : TP);

  // 1. Align-corners taps of each pixel: src = i * (in - 1) / (out - 1), on the
  //    global rows, then as rows of g.
  if (tid < TP) {
    const long long q = p0 + (tid < valid ? tid : 0);
    const int b = static_cast<int>(q / hw);
    const int rem = static_cast<int>(q - b * hw);
    const int y = rem / w_out;
    const int xo = rem - y * w_out;
    const float sy = (y + band.y_off) * scale_h;
    const int y0 = min(static_cast<int>(floorf(sy)), band.g_last);
    const float fy = sy - y0;
    const int y1 = min(y0 + 1, band.g_last);
    const float sx = xo * scale_w;
    const int x0 = min(static_cast<int>(floorf(sx)), w_in - 1);
    const float fx = sx - x0;
    row[2 * tid] = (static_cast<long long>(b) * h_in + y0 - band.g_off) * w_in;
    row[2 * tid + 1] = (static_cast<long long>(b) * h_in + y1 - band.g_off) * w_in;
    col[2 * tid] = x0;
    col[2 * tid + 1] = min(x0 + 1, w_in - 1);
    wts[4 * tid] = 1.f - fy;
    wts[4 * tid + 1] = fy;
    wts[4 * tid + 2] = 1.f - fx;
    wts[4 * tid + 3] = fx;
  }
  __syncthreads();

  // 2. Stage the tile K-major. g_up: the W lerp, then the H lerp.
  for (int e = tid; e < TP * cg; e += kThreads) {
    const int p = e / cg;
    const int c = e - p * cg;
    float v = 0.f;
    if (p < valid) {
      const float* r0 = g + row[2 * p] * cg + c;
      const float* r1 = g + row[2 * p + 1] * cg + c;
      const int c0 = col[2 * p] * cg;
      const int c1 = col[2 * p + 1] * cg;
      const float wx0 = wts[4 * p + 2], wx1 = wts[4 * p + 3];
      const float top = wx0 * r0[c0] + wx1 * r0[c1];
      const float bot = wx0 * r1[c0] + wx1 * r1[c1];
      v = wts[4 * p] * top + wts[4 * p + 1] * bot;
    }
    As[c * TPS + p] = v;
  }
  const float* xt = x + p0 * cx;  // the tile's x is one contiguous run
  for (int e = tid; e < TP * cx; e += kThreads) {
    const int p = e / cx;
    const int c = e - p * cx;
    As[(cg + c) * TPS + p] = p < valid ? xt[e] : 0.f;
  }
  for (int e = tid; e < (Kp - K) * TPS; e += kThreads) As[K * TPS + e] = 0.f;

  // 3. GEMM over K in chunks of IC inter channels; fold relu(.)*wpsi at once.
  float psum[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) psum[j] = 0.f;

  for (int i0 = 0; i0 < inter; i0 += IC) {
    float acc[PT][IPT];
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int i = 0; i < IPT; ++i) acc[j][i] = 0.f;

    for (int k0 = 0; k0 < Kp; k0 += kKC) {
      __syncthreads();  // the tile is staged / the last chunk's readers are done
      for (int e = tid; e < kKC * IC; e += kThreads) {
        const int kk = e / IC;
        const int k = k0 + kk;
        const int i = i0 + (e - kk * IC);
        float v = 0.f;
        if (k < K && i < inter)
          v = k < cg ? wg[static_cast<size_t>(k) * inter + i]
                     : wx[static_cast<size_t>(k - cg) * inter + i];
        Bs[e] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const Vec<PT> av = *reinterpret_cast<const Vec<PT>*>(As + (k0 + kk) * TPS + ty * PT);
        const Vec<IPT> bv = *reinterpret_cast<const Vec<IPT>*>(Bs + kk * IC + tx * IPT);
#pragma unroll
        for (int j = 0; j < PT; ++j) {
#pragma unroll
          for (int i = 0; i < IPT; ++i) acc[j][i] = fmaf(av.v[j], bv.v[i], acc[j][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int ii = i0 + tx * IPT + i;
      const float bb = ii < inter ? badd[ii] : 0.f;
      const float wp = ii < inter ? wpsi[ii] : 0.f;
#pragma unroll
      for (int j = 0; j < PT; ++j) psum[j] += fmaxf(acc[j][i] + bb, 0.f) * wp;
    }
  }

  // 4. Reduce psi over the 16 inter-channel groups (lanes of one half-warp).
  const float bp = *bpsi;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    float s = psum[j];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0) att_s[ty * PT + j] = 1.f / (1.f + expf(-(s + bp)));
  }
  __syncthreads();

  // 5. out = x * att, written as one contiguous run.
  float* ot = out + p0 * cx;
  for (int e = tid; e < valid * cx; e += kThreads) {
    const int p = e / cx;
    const int c = e - p * cx;
    ot[e] = As[(cg + c) * TPS + p] * att_s[p];
  }
}

template <int PT, int IPT>
cudaError_t launch_f32(const float* g, const float* x, const float* wg, const float* wx,
                       const float* badd, const float* wpsi, const float* bpsi, float* out,
                       int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                       int inter, Band band, float scale_h, float scale_w,
                       cudaStream_t stream) {
  const int kp = (cg + cx + kKC - 1) / kKC * kKC;
  const size_t smem = smem_bytes<PT, IPT>(kp);
  auto kernel = gate_f32_kernel<PT, IPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long npix = static_cast<long long>(n) * h_out * w_out;
  const long long blocks = (npix + 16 * PT - 1) / (16 * PT);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out, w_out, cg, cx, inter,
      band, scale_h, scale_w);
  return cudaGetLastError();
}

// The largest pixel tile whose staged channel vectors fit the budget (PT = 1 may
// take twice it: Cg + Cx = 1536 at the transposed AttentionUNet-64's widest gate is
// 110.6 KB); the inter-channel chunk follows I (the smallest gate has I = 32).
template <int IPT>
cudaError_t dispatch_f32_pt(const float* g, const float* x, const float* wg,
                            const float* wx, const float* badd, const float* wpsi,
                            const float* bpsi, float* out, int n, int h_in, int w_in,
                            int h_out, int w_out, int cg, int cx, int inter, Band band,
                            float scale_h, float scale_w, cudaStream_t s) {
  const int kp = (cg + cx + kKC - 1) / kKC * kKC;
  if (tile_bytes<4>(kp) <= kMaxTileBytes)
    return launch_f32<4, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                              w_out, cg, cx, inter, band, scale_h, scale_w, s);
  if (tile_bytes<2>(kp) <= kMaxTileBytes)
    return launch_f32<2, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                              w_out, cg, cx, inter, band, scale_h, scale_w, s);
  if (tile_bytes<1>(kp) <= 2 * kMaxTileBytes)
    return launch_f32<1, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                              w_out, cg, cx, inter, band, scale_h, scale_w, s);
  return cudaErrorInvalidValue;  // Cg + Cx too wide for one tile
}

cudaError_t dispatch_f32(const void* g, const void* x, const void* wg, const void* wx,
                         const void* badd, const void* wpsi, const void* bpsi, void* out,
                         int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                         int inter, Band band, float scale_h, float scale_w,
                         cudaStream_t s) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (inter >= 64)
    return dispatch_f32_pt<4>(f(g), f(x), f(wg), f(wx), f(badd), f(wpsi), f(bpsi),
                              static_cast<float*>(out), n, h_in, w_in, h_out, w_out, cg,
                              cx, inter, band, scale_h, scale_w, s);
  return dispatch_f32_pt<2>(f(g), f(x), f(wg), f(wx), f(badd), f(wpsi), f(bpsi),
                            static_cast<float*>(out), n, h_in, w_in, h_out, w_out, cg, cx,
                            inter, band, scale_h, scale_w, s);
}

// ---------------------------------------------------------------- bf16 (wgmma)

constexpr int kTileH = 8;                   // output rows per tile
constexpr int kTileW = 16;                  // output columns per tile
constexpr int kBM = kTileH * kTileW;        // 128 output pixels: 64 per warpgroup
constexpr int kBK = 64;                     // channels per stage: 128-byte rows
constexpr int kPatchH = kTileH / 2 + 2;     // g rows a tile's taps touch
constexpr int kPatchW = kTileW / 2 + 2;     // g columns
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kGateThreads = kConsumers + 32;  // + the producer's warp
constexpr int kABytes = kBM * kBK * 2;      // 16 KB
constexpr int kBBlockBytes = kBK * 64 * 2;  // 64 k x 64 inter channels: 8 KB
constexpr int kPatchBytes = kPatchH * kPatchW * kBK * 2;  // 7680
constexpr int kPatchRoom = 8192;
constexpr int kMaxStages = 5;

template <int NP>
__host__ __device__ constexpr int gate_stage_bytes() {
  return kABytes + (NP / 64) * kBBlockBytes + kPatchRoom;
}

// What follows the ring: the barriers and, for each warpgroup's 4 rows x 16
// columns of the tile, the taps and the attention per pixel.
struct alignas(16) GateTables {
  uint64_t full[kMaxStages], empty[kMaxStages];
  struct Half {
    int row[kTileH / 2][2];      // patch rows of the two H taps
    float row_w[kTileH / 2][2];  // their weights, rounded to bf16 as the TPU kernel's
    int col[kTileW][2];
    float col_w[kTileW][2];
    __nv_bfloat162 att[kBM / 2];  // the pixel's attention, twice
  } half[2];
};

// The ring and the tables; the (badd, wpsi) pairs of the epilogue follow.
template <int NP, int STAGES>
__host__ __device__ constexpr int gate_smem_bytes() {
  return STAGES * gate_stage_bytes<NP>() + static_cast<int>(sizeof(GateTables));
}

// I beyond the widest accumulator is walked in chunks of NP inter channels: the K
// loop runs once per chunk and psi sums over them.
template <int NP>
__host__ __device__ constexpr int gate_n_chunks(int inter) {
  return NP == 256 ? (inter + NP - 1) / NP : 1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// round_bf16(relu(a)), round_bf16(relu(b)): one instruction clamps, rounds and
// packs the pair (rounding keeps the sign, so the clamp may come after it).
__device__ __forceinline__ float2 relu_round2(float a, float b) {
  uint32_t packed;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(packed) : "f"(b), "f"(a));
  return make_float2(__uint_as_float(packed << 16),
                     __uint_as_float(packed & 0xffff0000u));
}

// round_bf16(w0 * u + w1 * v) on eight bf16 channels (16 bytes): one axis of the
// bilinear interpolation, with its rounding.
__device__ __forceinline__ uint4 lerp8(uint4 u, uint4 v, float w0, float w1) {
  uint4 r;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 fa = __bfloat1622float2(a[e]);
    const float2 fb = __bfloat1622float2(b[e]);
    o[e] = __floats2bfloat162_rn(w0 * fa.x + w1 * fb.x, w0 * fa.y + w1 * fb.y);
  }
  return r;
}

// rows[i] for a warp-uniform i in 0..3, without indexing registers at run time.
__device__ __forceinline__ uint4 pick(const uint4 (&rows)[4], int i) {
  return i == 0 ? rows[0] : i == 1 ? rows[1] : i == 2 ? rows[2] : rows[3];
}

struct GateTile {
  int img, y0, x0;
  int gy0, gx0;  // first source row and column of the tile's taps
};

__device__ __forceinline__ GateTile decode_gate_tile(int t, int tiles_x, int tiles_y,
                                                     Band band, int w_in, float scale_h,
                                                     float scale_w) {
  GateTile tile;
  tile.x0 = (t % tiles_x) * kTileW;
  t /= tiles_x;
  tile.y0 = (t % tiles_y) * kTileH;
  tile.img = t / tiles_y;
  // the same arithmetic as the taps below, so the patch starts at the first tap
  // (a row of g, from the global rows)
  tile.gy0 = min(static_cast<int>(floorf((tile.y0 + band.y_off) * scale_h)), band.g_last) -
             band.g_off;
  tile.gx0 = min(static_cast<int>(floorf(tile.x0 * scale_w)), w_in - 1);
  return tile;
}

// NP: I padded to a wgmma width; STAGES ring stages; MINB blocks on an SM (which
// sets the registers a thread may use).
template <int NP, int STAGES, int MINB>
__global__ void __launch_bounds__(kGateThreads, MINB)
    gate_bf16_kernel(const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wgmap,
                     const __grid_constant__ CUtensorMap wxmap,
                     const __nv_bfloat16* __restrict__ x, const float* __restrict__ badd,
                     const __nv_bfloat16* __restrict__ wpsi,
                     const float* __restrict__ bpsi, __nv_bfloat16* __restrict__ out,
                     Band band, int w_in, int h_out, int w_out, int cg, int cx, int inter,
                     float scale_h, float scale_w, int tiles_x, int tiles_y,
                     int n_tiles) {
  using namespace hopper;
  constexpr int kStage = gate_stage_bytes<NP>();
  constexpr int kBBytes = (NP / 64) * kBBlockBytes;
  static_assert(kStage % 1024 == 0 && STAGES <= kMaxStages, "ring layout");

  extern __shared__ __align__(1024) unsigned char ring[];
  GateTables& tab = *reinterpret_cast<GateTables*>(ring + STAGES * kStage);

  const int g_chunks = (cg + kBK - 1) / kBK;
  const int ksteps = g_chunks + (cx + kBK - 1) / kBK;
  const int n_chunks = gate_n_chunks<NP>(inter);

  // (badd[i], wpsi[i]) as f32 pairs, zeros past I, for the epilogue
  float2* bw = reinterpret_cast<float2*>(ring + STAGES * kStage + sizeof(GateTables));
  for (int i = threadIdx.x; i < n_chunks * NP; i += kGateThreads)
    bw[i] = i < inter ? make_float2(badd[i], __bfloat162float(wpsi[i]))
                      : make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(tab.full + s, 1);   // the producer's arrive.expect_tx
      mbar_init(tab.empty + s, 2);  // one thread of each consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    // One thread walks this block's tiles and keeps the ring full: the next
    // tile's chunks load while the consumers are in this tile's epilogue.
    if (threadIdx.x == kConsumers) {
      RingPos<STAGES> pos(1);  // the ring starts empty
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const GateTile tile =
            decode_gate_tile(t, tiles_x, tiles_y, band, w_in, scale_h, scale_w);
        for (int nc = 0; nc < n_chunks; ++nc) {
          const int i0 = nc * NP;
          for (int ks = 0; ks < ksteps; ++ks) {
            unsigned char* a = ring + pos.stage * kStage;
            unsigned char* b = a + kABytes;
            uint64_t* full = tab.full + pos.stage;
            mbar_wait(tab.empty + pos.stage, pos.phase);
            if (ks < g_chunks) {
              const int c0 = ks * kBK;
              mbar_arrive_expect_tx(full, kPatchBytes + kBBytes);
              tma_load_4d(b + kBBytes, &gmap, full, c0, tile.gx0, tile.gy0, tile.img);
#pragma unroll
              for (int jb = 0; jb < NP / 64; ++jb)
                tma_load_2d(b + jb * kBBlockBytes, &wgmap, full, i0 + 64 * jb, c0);
            } else {
              const int c0 = (ks - g_chunks) * kBK;
              mbar_arrive_expect_tx(full, kABytes + kBBytes);
              tma_load_4d(a, &xmap, full, c0, tile.x0, tile.y0, tile.img);
#pragma unroll
              for (int jb = 0; jb < NP / 64; ++jb)
                tma_load_2d(b + jb * kBBlockBytes, &wxmap, full, i0 + 64 * jb, c0);
            }
            pos.advance();
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    // The two warpgroups share the ring's stages and nothing else: each has its
    // own 64 pixels (4 rows x 16 columns), taps, barrier and attention values.
    const int wg = threadIdx.x >> 7;
    const int tw = threadIdx.x & 127;
    GateTables::Half& my = tab.half[wg];
    const int q = tw & 3;
    const int prow = (tw >> 5) * 16 + ((tw & 31) >> 2);  // accumulator row, and +8
    const float bp = *bpsi;
    // the x * att pass walks (pixel, 16-byte vector) items tw, tw + 128, ...
    const int vecs = cx >> 3;
    const int pl0 = tw / vecs, v0 = tw - pl0 * vecs;
    const int dpl = 128 / vecs, dv = 128 - dpl * vecs;

    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;

    RingPos<STAGES> pos(0);
    int held = -1;  // the stage whose products may still be running
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const GateTile tile =
          decode_gate_tile(t, tiles_x, tiles_y, band, w_in, scale_h, scale_w);
      const int ybase = tile.y0 + wg * (kTileH / 2);

      // align-corners taps of this warpgroup's rows and columns, as patch
      // indices: src = i * (in-1)/(out-1), rows on the global rows. A ragged
      // tile's rows and columns past the map are clamped (their pixels are never
      // stored).
      if (tw < kTileH / 2) {
        const int y = min(ybase + tw, h_out - 1);
        const float sy = (y + band.y_off) * scale_h;
        const int ya = min(static_cast<int>(floorf(sy)), band.g_last);
        const float fy = sy - ya;
        const int gy = tile.gy0 + band.g_off;
        my.row[tw][0] = min(max(ya - gy, 0), kPatchH - 1);
        my.row[tw][1] = min(max(min(ya + 1, band.g_last) - gy, 0), kPatchH - 1);
        my.row_w[tw][0] = round_bf16(1.f - fy);
        my.row_w[tw][1] = round_bf16(fy);
      } else if (tw >= 32 && tw < 32 + kTileW) {
        const int i = tw - 32;
        const int xo = min(tile.x0 + i, w_out - 1);
        const float sx = xo * scale_w;
        const int xa = min(static_cast<int>(floorf(sx)), w_in - 1);
        const float fx = sx - xa;
        my.col[i][0] = min(max(xa - tile.gx0, 0), kPatchW - 1);
        my.col[i][1] = min(max(min(xa + 1, w_in - 1) - tile.gx0, 0), kPatchW - 1);
        my.col_w[i][0] = round_bf16(1.f - fx);
        my.col_w[i][1] = round_bf16(fx);
      }
      named_barrier_sync(1 + wg, 128);

      float ps0 = 0.f, ps1 = 0.f;
      for (int nc = 0; nc < n_chunks; ++nc) {
        for (int ks = 0; ks < ksteps; ++ks) {
          unsigned char* a = ring + pos.stage * kStage;
          unsigned char* b = a + kABytes;
          mbar_wait(tab.full + pos.stage, pos.phase);
          if (ks < g_chunks) {
            // g_up of this warpgroup's 64 pixels x 64 channels into the A tile.
            // A thread owns one output column and 8 channels in the 4 rows: it
            // interpolates along W once for each of the (at most 4, at exactly 2x)
            // source rows those output rows touch, then along H from registers.
            const unsigned char* patch = b + kBBytes + (tw & 7) * 16;
            const int tx = tw >> 3;
            const int c0 = my.col[tx][0] * 128, c1 = my.col[tx][1] * 128;
            const float wx0 = my.col_w[tx][0], wx1 = my.col_w[tx][1];
            const int rb = my.row[0][0];  // the lowest source row (rows ascend)
            uint4 along_w[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const unsigned char* src =
                  patch + min(rb + r, kPatchH - 1) * (kPatchW * 128);
              along_w[r] = lerp8(*reinterpret_cast<const uint4*>(src + c0),
                                 *reinterpret_cast<const uint4*>(src + c1), wx0, wx1);
            }
#pragma unroll
            for (int ty = 0; ty < kTileH / 2; ++ty) {
              const uint4 up = lerp8(pick(along_w, min(my.row[ty][0] - rb, 3)),
                                     pick(along_w, min(my.row[ty][1] - rb, 3)),
                                     my.row_w[ty][0], my.row_w[ty][1]);
              *reinterpret_cast<uint4*>(
                  a + swizzle128_offset(wg * 64 + ty * kTileW + tx, tw & 7)) = up;
            }
            fence_proxy_async();
            named_barrier_sync(1 + wg, 128);
          }
          const uint64_t da = desc_k_major(a + wg * 64 * 128);
          const uint64_t db = desc_mn_major(b, kBBlockBytes);
          fence_accumulator(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_k16<NP>(acc, da + kk * kDescKStepA, db + kk * kDescKStepB,
                          (ks | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the step before has finished reading its stage
          if (held >= 0 && tw == 0) mbar_arrive(tab.empty + held);
          held = pos.stage;
          pos.advance();
        }
        wgmma_wait<0>();
        fence_accumulator(acc);
        if (tw == 0) mbar_arrive(tab.empty + held);
        held = -1;

        // psi on the registers: this thread's columns of two rows
        const float4* bw4 = reinterpret_cast<const float4*>(bw + nc * NP) + q;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const float4 c = bw4[4 * j];  // badd, wpsi of columns 8j + 2q and + 1
          const float2 t0 = relu_round2(acc[4 * j] + c.x, acc[4 * j + 1] + c.z);
          const float2 t1 = relu_round2(acc[4 * j + 2] + c.x, acc[4 * j + 3] + c.z);
          ps0 += t0.x * c.y;
          ps1 += t1.x * c.y;
          ps0 += t0.y * c.w;
          ps1 += t1.y * c.w;
        }
      }
      // then the quad that shares a row
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
      if (q == 0) {
        my.att[prow] = __float2bfloat162_rn(1.f / (1.f + expf(-(ps0 + bp))));
        my.att[prow + 8] = __float2bfloat162_rn(1.f / (1.f + expf(-(ps1 + bp))));
      }
      named_barrier_sync(1 + wg, 128);

      // out = x * att over this warpgroup's 64 pixels, 8 channels (16 bytes) a
      // thread a step; a bf16 product rounds once, as the f32 product rounded.
      // Four loads of x are in flight before the first product: the loads are
      // unconditional (an item past the tile or the map re-reads a valid pixel)
      // and only the stores are guarded.
      for (int pl = pl0, v = v0; pl < kBM / 2;) {
        uint4 xv[4];
        size_t off[4];
        __nv_bfloat162 att[4];
        unsigned ok = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = min(pl, kBM / 2 - 1);
          const int y = ybase + (p >> 4), xo = tile.x0 + (p & 15);
          ok |= static_cast<unsigned>(pl < kBM / 2 && y < h_out && xo < w_out) << u;
          off[u] = ((static_cast<size_t>(tile.img) * h_out + min(y, h_out - 1)) * w_out +
                    min(xo, w_out - 1)) * cx + v * 8;
          xv[u] = *reinterpret_cast<const uint4*>(x + off[u]);
          att[u] = my.att[p];
          pl += dpl;
          v += dv;
          if (v >= vecs) {
            v -= vecs;
            ++pl;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          __nv_bfloat162* xe = reinterpret_cast<__nv_bfloat162*>(&xv[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) xe[e] = __hmul2(xe[e], att[u]);
          if (ok >> u & 1) *reinterpret_cast<uint4*>(out + off[u]) = xv[u];
        }
      }
    }
  }
}

template <int NP, int STAGES, int MINB>
cudaError_t launch_bf16(const void* g, const void* x, const void* wg, const void* wx,
                        const void* badd, const void* wpsi, const void* bpsi, void* out,
                        int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                        int inter, Band band, float scale_h, float scale_w,
                        cudaStream_t stream) {
  CUtensorMap gmap, xmap, wgmap, wxmap;
  const uint64_t gdims[4] = {static_cast<uint64_t>(cg), static_cast<uint64_t>(w_in),
                             static_cast<uint64_t>(h_in), static_cast<uint64_t>(n)};
  const uint64_t gstrides[3] = {gdims[0] * 2, gdims[0] * gdims[1] * 2,
                                gdims[0] * gdims[1] * gdims[2] * 2};
  const uint32_t gbox[4] = {kBK, kPatchW, kPatchH, 1};
  const uint64_t xdims[4] = {static_cast<uint64_t>(cx), static_cast<uint64_t>(w_out),
                             static_cast<uint64_t>(h_out), static_cast<uint64_t>(n)};
  const uint64_t xstrides[3] = {xdims[0] * 2, xdims[0] * xdims[1] * 2,
                                xdims[0] * xdims[1] * xdims[2] * 2};
  const uint32_t xbox[4] = {kBK, kTileW, kTileH, 1};
  const uint64_t wgdims[2] = {static_cast<uint64_t>(inter), static_cast<uint64_t>(cg)};
  const uint64_t wxdims[2] = {static_cast<uint64_t>(inter), static_cast<uint64_t>(cx)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(inter) * 2};
  const uint32_t wbox[2] = {64, kBK};
  cudaError_t err =
      hopper::make_tensor_map_bf16(&gmap, g, 4, gdims, gstrides, gbox, false);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map_bf16(&xmap, x, 4, xdims, xstrides, xbox, true);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map_bf16(&wgmap, wg, 2, wgdims, wstrides, wbox, true);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map_bf16(&wxmap, wx, 2, wxdims, wstrides, wbox, true);
  if (err != cudaSuccess) return err;

  auto kernel = gate_bf16_kernel<NP, STAGES, MINB>;
  const int smem = gate_smem_bytes<NP, STAGES>() +
                   gate_n_chunks<NP>(inter) * NP * static_cast<int>(sizeof(float2));
  if (smem > 232448) return cudaErrorInvalidValue;  // a block's shared memory on sm_90
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (w_out + kTileW - 1) / kTileW;
  const int tiles_y = (h_out + kTileH - 1) / kTileH;
  const long long tiles = static_cast<long long>(n) * tiles_y * tiles_x;
  const int sms = hopper::sm_count();
  if (tiles > INT_MAX || sms <= 0) return cudaErrorInvalidValue;
  // persistent blocks: as many as the card holds at once, each walking tiles
  const long long blocks = tiles < MINB * sms ? tiles : MINB * sms;
  kernel<<<static_cast<unsigned>(blocks), kGateThreads, smem, stream>>>(
      gmap, xmap, wgmap, wxmap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(badd), static_cast<const __nv_bfloat16*>(wpsi),
      static_cast<const float*>(bpsi), static_cast<__nv_bfloat16*>(out), band, w_in, h_out,
      w_out, cg, cx, inter, scale_h, scale_w, tiles_x, tiles_y, static_cast<int>(tiles));
  return cudaGetLastError();
}

// NP follows I, as do the ring's depth and the blocks on an SM (see the note at
// the head); what TMA cannot take is refused. The whole map must upsample
// exactly 2x (a band may hold any rows of it).
cudaError_t dispatch_bf16(const void* g, const void* x, const void* wg, const void* wx,
                          const void* badd, const void* wpsi, const void* bpsi, void* out,
                          int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                          int inter, int h_out_full, Band band, float scale_h,
                          float scale_w, cudaStream_t s) {
  if (n <= 0 || h_in <= 0 || w_in <= 0 || h_out_full != 2 * (band.g_last + 1) ||
      w_out != 2 * w_in || cg <= 0 || cx <= 0 || inter <= 0 || cg % 8 || cx % 8 ||
      inter % 8)
    return cudaErrorInvalidValue;
  if (inter <= 64)
    return launch_bf16<64, 2, 2>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                                 w_out, cg, cx, inter, band, scale_h, scale_w, s);
  if (inter <= 128)
    return launch_bf16<128, 4, 1>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                                  h_out, w_out, cg, cx, inter, band, scale_h, scale_w, s);
  return launch_bf16<256, 3, 1>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                                w_out, cg, cx, inter, band, scale_h, scale_w, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. g (n, h_in, w_in, cg) and x / out
// (n, h_out, w_out, cx) are NHWC; wg (cg, inter), wx (cx, inter) and wpsi (inter)
// are in the same type; badd (inter) and bpsi (1) are float32. x and out are rows
// [y_off, y_off + h_out) of a map h_out_full rows high, g rows [g_off, g_off +
// h_in) of a source h_in_full rows high (a whole map: 0, 0, h_in, h_out); g must
// hold every row the band's taps read. bfloat16 wants exactly 2x upsampling of
// the whole map, cg, cx and inter multiples of 8 and 16-byte aligned pointers.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int attention_gate_launch(int dtype, const void* g, const void* x, const void* wg,
                          const void* wx, const void* badd, const void* wpsi,
                          const void* bpsi, void* out, int n, int h_in, int w_in,
                          int h_out, int w_out, int cg, int cx, int inter, int y_off,
                          int g_off, int h_in_full, int h_out_full, float scale_h,
                          float scale_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_out <= 0 || h_in <= 0 || y_off < 0 || g_off < 0 || y_off + h_out > h_out_full ||
      g_off + h_in > h_in_full)
    return cudaErrorInvalidValue;
  const Band band{y_off, g_off, h_in_full - 1};
  // the band's first and last taps, as the kernels compute them, lie in g
  const int first = std::min(static_cast<int>(std::floor(y_off * scale_h)), band.g_last);
  const int last = std::min(
      static_cast<int>(std::floor((y_off + h_out - 1) * scale_h)) + 1, band.g_last);
  if (first < g_off || last >= g_off + h_in) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_f32(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out, w_out,
                        cg, cx, inter, band, scale_h, scale_w, s);
  if (dtype == 1)
    return dispatch_bf16(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out, w_out,
                         cg, cx, inter, h_out_full, band, scale_h, scale_w, s);
  return cudaErrorInvalidValue;
}

const char* attention_gate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
