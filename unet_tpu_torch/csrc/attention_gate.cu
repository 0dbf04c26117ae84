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
// with T the compute type (bf16 on the main path, f32 for tight checks). The
// rounding points are the ones _gate_kernel has, so the kernel computes the same
// function as the TPU one.
//
// What bounds it on an H100: per output pixel it reads Cx + Cg/4 channels and
// writes Cx, and does 2*(Cg+Cx)*I flops (I = inter channels = Cx/2). In bf16 that
// is ~1 flop per byte for the largest gates: memory-bound with tensor cores (at
// 512^2, batch 8, ~1.13 GB moved = ~0.34 ms at 3.35 TB/s vs ~0.07 ms of bf16
// tensor-core math), but compute-bound on the CUDA cores this first version uses
// (~69 GFLOP at 67 TFLOP/s f32 FMA = ~1 ms).
//
// What the design does about it: everything after the loads stays on chip. g_up
// is interpolated straight into shared memory, so no upsampled gate map, no
// pre-activation t and no attention map ever touch device memory; x is read once
// and the gated output written once. One block of 256 threads owns a tile of TP
// consecutive pixels (TP = 16*PT): it stages the tile's [g_up | x] channel vectors
// K-major in shared memory, then runs a register-blocked f32 GEMM against the
// stacked [wg; wx] weights in chunks of IC = 16*IPT inter channels (32 K-rows of
// weights in shared memory at a time). Each chunk's relu(.) * wpsi is folded into
// a per-pixel running sum at once, so t is never stored; a warp shuffle reduces
// it across the 16 inter-channel groups. Tensor cores (wgmma), TMA and applying
// W_g at low resolution (exact by linearity) are left to later versions.
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libattention_gate.so attention_gate.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 pixel groups x 16 inter-channel groups
constexpr int kKC = 32;        // weight rows staged per step
constexpr size_t kMaxTileBytes = 96 * 1024;  // budget for the staged tile

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Round an f32 value to T and back: the points where the TPU kernel casts.
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T, int N> struct alignas(sizeof(T) * N) Vec { T v[N]; };

__host__ __device__ constexpr int tile_stride(int tp, int pt) {
  // Row stride of the K-major tile: padded off a multiple of 32 words to spread
  // the transposed stores over banks, and a multiple of PT for vector loads.
  return tp + (pt > 2 ? pt : 2);
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

template <typename T, int PT>
__host__ __device__ constexpr size_t tile_bytes(int kp) {
  return align16(static_cast<size_t>(kp) * tile_stride(16 * PT, PT) * sizeof(T));
}

template <typename T, int PT, int IPT>
__host__ __device__ constexpr size_t smem_bytes(int kp) {
  // tile + weight chunk + per-pixel taps (2 row offsets, 2 columns, 4 weights)
  // + per-pixel attention
  return tile_bytes<T, PT>(kp) + sizeof(float) * kKC * 16 * IPT +
         16 * PT * (2 * sizeof(long long) + 2 * sizeof(int) + 5 * sizeof(float));
}

template <typename T, int PT, int IPT>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ g, const T* __restrict__ x,
            const T* __restrict__ wg, const T* __restrict__ wx,
            const float* __restrict__ badd, const T* __restrict__ wpsi,
            const float* __restrict__ bpsi, T* __restrict__ out, int n,
            int h_in, int w_in, int h_out, int w_out, int cg, int cx, int inter,
            float scale_h, float scale_w) {
  constexpr int TP = 16 * PT;
  constexpr int IC = 16 * IPT;
  constexpr int TPS = tile_stride(TP, PT);
  const int K = cg + cx;
  const int Kp = (K + kKC - 1) / kKC * kKC;

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [Kp][TPS]: rows [0,cg) g_up, [cg,K) x
  float* Bs = reinterpret_cast<float*>(smem + tile_bytes<T, PT>(Kp));  // [kKC][IC]
  long long* row = reinterpret_cast<long long*>(Bs + kKC * IC);         // [TP][2]
  int* col = reinterpret_cast<int*>(row + 2 * TP);                      // [TP][2]
  float* wts = reinterpret_cast<float*>(col + 2 * TP);                  // [TP][4]
  float* att_s = wts + 4 * TP;                                          // [TP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // inter-channel group
  const int ty = tid >> 4;  // pixel group
  const long long hw = static_cast<long long>(h_out) * w_out;
  const long long npix = n * hw;
  const long long p0 = static_cast<long long>(blockIdx.x) * TP;
  const int valid = static_cast<int>(npix - p0 < TP ? npix - p0 : TP);

  // 1. Align-corners taps of each pixel: src = i * (in - 1) / (out - 1).
  if (tid < TP) {
    const long long q = p0 + (tid < valid ? tid : 0);
    const int b = static_cast<int>(q / hw);
    const int rem = static_cast<int>(q - b * hw);
    const int y = rem / w_out;
    const int xo = rem - y * w_out;
    const float sy = y * scale_h;
    const int y0 = min(static_cast<int>(floorf(sy)), h_in - 1);
    const float fy = sy - y0;
    const float sx = xo * scale_w;
    const int x0 = min(static_cast<int>(floorf(sx)), w_in - 1);
    const float fx = sx - x0;
    row[2 * tid] = (static_cast<long long>(b) * h_in + y0) * w_in;
    row[2 * tid + 1] = (static_cast<long long>(b) * h_in + min(y0 + 1, h_in - 1)) * w_in;
    col[2 * tid] = x0;
    col[2 * tid + 1] = min(x0 + 1, w_in - 1);
    // the TPU kernel's interpolation matrices are cast to T
    wts[4 * tid] = round_t<T>(1.f - fy);
    wts[4 * tid + 1] = round_t<T>(fy);
    wts[4 * tid + 2] = round_t<T>(1.f - fx);
    wts[4 * tid + 3] = round_t<T>(fx);
  }
  __syncthreads();

  // 2. Stage the tile K-major. g_up: W lerp rounded to T, then H lerp rounded.
  for (int e = tid; e < TP * cg; e += kThreads) {
    const int p = e / cg;
    const int c = e - p * cg;
    float v = 0.f;
    if (p < valid) {
      const T* r0 = g + row[2 * p] * cg + c;
      const T* r1 = g + row[2 * p + 1] * cg + c;
      const int c0 = col[2 * p] * cg;
      const int c1 = col[2 * p + 1] * cg;
      const float wx0 = wts[4 * p + 2], wx1 = wts[4 * p + 3];
      const float top = round_t<T>(wx0 * to_f(r0[c0]) + wx1 * to_f(r0[c1]));
      const float bot = round_t<T>(wx0 * to_f(r1[c0]) + wx1 * to_f(r1[c1]));
      v = wts[4 * p] * top + wts[4 * p + 1] * bot;
    }
    As[c * TPS + p] = from_f<T>(v);
  }
  const T* xt = x + p0 * cx;  // the tile's x is one contiguous run
  for (int e = tid; e < TP * cx; e += kThreads) {
    const int p = e / cx;
    const int c = e - p * cx;
    As[(cg + c) * TPS + p] = p < valid ? xt[e] : from_f<T>(0.f);
  }
  for (int e = tid; e < (Kp - K) * TPS; e += kThreads) As[K * TPS + e] = from_f<T>(0.f);

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
          v = to_f(k < cg ? wg[static_cast<size_t>(k) * inter + i]
                          : wx[static_cast<size_t>(k - cg) * inter + i]);
        Bs[e] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const Vec<T, PT> av =
            *reinterpret_cast<const Vec<T, PT>*>(As + (k0 + kk) * TPS + ty * PT);
        const Vec<float, IPT> bv =
            *reinterpret_cast<const Vec<float, IPT>*>(Bs + kk * IC + tx * IPT);
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const float a = to_f(av.v[j]);
#pragma unroll
          for (int i = 0; i < IPT; ++i) acc[j][i] = fmaf(a, bv.v[i], acc[j][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int ii = i0 + tx * IPT + i;
      const float bb = ii < inter ? badd[ii] : 0.f;
      const float wp = ii < inter ? to_f(wpsi[ii]) : 0.f;
#pragma unroll
      for (int j = 0; j < PT; ++j)
        psum[j] += round_t<T>(fmaxf(acc[j][i] + bb, 0.f)) * wp;
    }
  }

  // 4. Reduce psi over the 16 inter-channel groups (lanes of one half-warp).
  const float bp = *bpsi;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    float s = psum[j];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0) att_s[ty * PT + j] = round_t<T>(1.f / (1.f + expf(-(s + bp))));
  }
  __syncthreads();

  // 5. out = x * att, written as one contiguous run.
  T* ot = out + p0 * cx;
  for (int e = tid; e < valid * cx; e += kThreads) {
    const int p = e / cx;
    const int c = e - p * cx;
    ot[e] = from_f<T>(to_f(As[(cg + c) * TPS + p]) * att_s[p]);
  }
}

template <typename T, int PT, int IPT>
cudaError_t launch(const void* g, const void* x, const void* wg, const void* wx,
                   const void* badd, const void* wpsi, const void* bpsi, void* out,
                   int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                   int inter, float scale_h, float scale_w, cudaStream_t stream) {
  const int kp = (cg + cx + kKC - 1) / kKC * kKC;
  const size_t smem = smem_bytes<T, PT, IPT>(kp);
  auto kernel = gate_kernel<T, PT, IPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long npix = static_cast<long long>(n) * h_out * w_out;
  const long long blocks = (npix + 16 * PT - 1) / (16 * PT);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wx), static_cast<const float*>(badd),
      static_cast<const T*>(wpsi), static_cast<const float*>(bpsi), static_cast<T*>(out),
      n, h_in, w_in, h_out, w_out, cg, cx, inter, scale_h, scale_w);
  return cudaGetLastError();
}

// Largest pixel tile whose staged channel vectors fit the budget; the
// inter-channel chunk follows I (the smallest gate has I = 32).
template <typename T, int IPT>
cudaError_t dispatch_pt(const void* g, const void* x, const void* wg, const void* wx,
                        const void* badd, const void* wpsi, const void* bpsi, void* out,
                        int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                        int inter, float scale_h, float scale_w, cudaStream_t s) {
  const int kp = (cg + cx + kKC - 1) / kKC * kKC;
  if (tile_bytes<T, 4>(kp) <= kMaxTileBytes)
    return launch<T, 4, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                             h_out, w_out, cg, cx, inter, scale_h, scale_w, s);
  if (tile_bytes<T, 2>(kp) <= kMaxTileBytes)
    return launch<T, 2, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                             h_out, w_out, cg, cx, inter, scale_h, scale_w, s);
  if (tile_bytes<T, 1>(kp) <= 2 * kMaxTileBytes)
    return launch<T, 1, IPT>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                             h_out, w_out, cg, cx, inter, scale_h, scale_w, s);
  return cudaErrorInvalidValue;  // Cg + Cx too wide for one tile
}

template <typename T>
cudaError_t dispatch(const void* g, const void* x, const void* wg, const void* wx,
                     const void* badd, const void* wpsi, const void* bpsi, void* out,
                     int n, int h_in, int w_in, int h_out, int w_out, int cg, int cx,
                     int inter, float scale_h, float scale_w, cudaStream_t s) {
  if (inter >= 64)
    return dispatch_pt<T, 4>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                             h_out, w_out, cg, cx, inter, scale_h, scale_w, s);
  return dispatch_pt<T, 2>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                           w_out, cg, cx, inter, scale_h, scale_w, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. g (n, h_in, w_in, cg) and x / out
// (n, h_out, w_out, cx) are NHWC; wg (cg, inter), wx (cx, inter) and wpsi (inter)
// are in the same type; badd (inter) and bpsi (1) are float32. Returns the
// launch's cudaError_t (0 on success); does not synchronise.
int attention_gate_launch(int dtype, const void* g, const void* x, const void* wg,
                          const void* wx, const void* badd, const void* wpsi,
                          const void* bpsi, void* out, int n, int h_in, int w_in,
                          int h_out, int w_out, int cg, int cx, int inter,
                          float scale_h, float scale_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in, h_out,
                           w_out, cg, cx, inter, scale_h, scale_w, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(g, x, wg, wx, badd, wpsi, bpsi, out, n, h_in, w_in,
                                   h_out, w_out, cg, cx, inter, scale_h, scale_w, s);
  return cudaErrorInvalidValue;
}

const char* attention_gate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
