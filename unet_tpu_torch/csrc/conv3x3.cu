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
// channels per pixel and is bound by the tensor cores.
//
// What the design does about it (bf16, the main path's type): the products run on
// the tensor cores through nvcuda::wmma 16x16x16 (bf16 in, f32 accumulators in
// registers). One block of 128 threads owns a tile of BM = 128 consecutive output
// pixels (flattened over N, H, W, so any N, H, W works) by BN = 64 output
// channels. The K loop walks the 9 taps x Cin in chunks of BK = 32 channels; for
// each chunk, cp.async copies the 128 shifted input pixels (16 bytes per copy,
// zero-filled where the tap falls in the SAME padding or past the last pixel) and
// the 32 x 64 weight slab into shared memory, double-buffered so the next chunk's
// copies overlap this chunk's products. Each tap re-reads the input rather than
// staging a halo: the nine reads of one pixel come from L1/L2, not device memory.
// The f32 accumulators pass through shared memory for the epilogue, which applies
// the affine and ReLU and stores 16 bytes per thread per step. The TPU kernel's
// tap packing (K = 3*Cin, N = 3*Cout with shifted adds, to fill the 128 x 128 MXU)
// and its W padding have no counterpart here. wgmma, TMA, deeper pipelines and
// persistent blocks are left to later versions.
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
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bf16 (wmma)

constexpr int kBM = 128;             // output pixels per block
constexpr int kBN = 64;              // output channels per block
constexpr int kBK = 32;              // input channels per K step
constexpr int kThreads = 128;        // 4 warps, 2 x 2, each 64 pixels x 32 channels
constexpr int kALd = kBK + 8;        // smem row pitch (halves): 80 B rows
constexpr int kBLd = kBN + 8;        // 144 B rows
constexpr int kCLd = kBN + 4;        // f32 epilogue staging pitch
constexpr int kAStage = kBM * kALd;  // halves per A stage
constexpr int kBStage = kBK * kBLd;  // halves per B stage
constexpr int kPipeBytes = 2 * (kAStage + kBStage) * 2;
constexpr int kCBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kCBytes ? kPipeBytes : kCBytes;
static_assert(kSmemBytes <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float epilogue(float v, const float* mul, const float* add,
                                          int o, int relu) {
  if (mul != nullptr) v = __fadd_rn(__fmul_rn(v, mul[o]), add[o]);
  return relu ? fmaxf(v, 0.f) : v;
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wk,
                        const float* __restrict__ mul, const float* __restrict__ add,
                        __nv_bfloat16* __restrict__ out, int n, int h, int w, int cin,
                        int cout, int relu) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBM][kALd]
  __nv_bfloat16* bs = as + 2 * kAStage;                          // [2][kBK][kBLd]
  float* cs = reinterpret_cast<float*>(smem);  // [kBM][kCLd], after the K loop

  const int tid = threadIdx.x;
  const long long plane = static_cast<long long>(h) * w;
  const long long m_total = plane * n;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A copies: thread tid moves 8 channels (part q) of pixels tid/4 + 32*i.
  const int q = tid & 3;
  int py[4], px[4];
  long long pimg[4];  // index of the pixel's image's first pixel
  bool pin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    pin[i] = m < m_total;
    const long long mm = pin[i] ? m : 0;
    const long long img = mm / plane;
    const long long r = mm - img * plane;
    py[i] = static_cast<int>(r / w);
    px[i] = static_cast<int>(r - static_cast<long long>(py[i]) * w);
    pimg[i] = img * plane;
  }

  const int chunks = cin / kBK;
  const int ksteps = 9 * chunks;

  auto load = [&](int stage, int ks) {
    const int tap = ks / chunks;
    const int c0 = (ks - tap * chunks) * kBK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    __nv_bfloat16* a = as + stage * kAStage;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ys = py[i] + dy;
      const int xs = px[i] + dx;
      const bool ok = pin[i] && ys >= 0 && ys < h && xs >= 0 && xs < w;
      const __nv_bfloat16* src =
          ok ? x + ((pimg[i] + static_cast<long long>(ys) * w + xs) * cin + c0 + q * 8)
             : x;
      cp_async16(a + ((tid >> 2) + 32 * i) * kALd + q * 8, src, ok);
    }
    __nv_bfloat16* b = bs + stage * kBStage;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (tid >> 3) + 16 * j;
      const int c8 = tid & 7;
      const __nv_bfloat16* src =
          wk + (static_cast<long long>(tap * cin + c0 + r) * cout + n0 + c8 * 8);
      cp_async16(b + r * kBLd + c8 * 8, src, true);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*64 .. +63 of the tile
  const int wn = warp & 1;   // channels wn*32 .. +31

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {
      load((ks + 1) & 1, ks + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = as + (ks & 1) * kAStage;
    const __nv_bfloat16* b = bs + (ks & 1) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 64 + i * 16) * kALd + kk * 16, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (kk * 16) * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 64 + i * 16) * kCLd + wn * 32 + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < kBM * kBN / 8; idx += kThreads) {
    const int p = idx >> 3;
    const int c8 = idx & 7;
    const long long m = m0 + p;
    if (m >= m_total) continue;
    const float* v = cs + p * kCLd + c8 * 8;
    const int o = n0 + c8 * 8;
    uint4 packed;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h2[e] = __floats2bfloat162_rn(epilogue(v[2 * e], mul, add, o + 2 * e, relu),
                                    epilogue(v[2 * e + 1], mul, add, o + 2 * e + 1, relu));
    *reinterpret_cast<uint4*>(out + m * cout + o) = packed;
  }
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
  const long long m = static_cast<long long>(n) * h * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fm = static_cast<const float*>(mul);
  const float* fa = static_cast<const float*>(add);
  if (dtype == 1) {
    const long long blocks = (m + kBM - 1) / kBM;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), cout / kBN);
    conv3x3_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk), fm,
        fa, static_cast<__nv_bfloat16*>(out), n, h, w, cin, cout, relu);
  } else if (dtype == 0) {
    const long long blocks = (m + kFM - 1) / kFM;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks), cout / kFN);
    conv3x3_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk), fm, fa,
        static_cast<float*>(out), n, h, w, cin, cout, relu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
