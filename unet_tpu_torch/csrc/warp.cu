// Fused augmentation resample for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   unet_tpu/ops/pallas/warp.py::_warp_pallas (bodies _warp_body_banded2d and
//   _warp_body, reached from grid_sample_fused_pallas)
// and computes unet_tpu/data/augmentations.py::_grid_sample_fused operation for
// operation. For each output pixel with source coordinates (r, c) in an H x W
// plane:
//
//   valid = 0 <= r <= H-1 && 0 <= c <= W-1        (the unclamped coordinates)
//   rc    = clamp(r, 0, H-1);  r0 = min(floor(rc), H-2);  wr = rc - r0
//   cc    = clamp(c, 0, W-1);  c0 = min(floor(cc), W-2);  wc = cc - c0
//   image = (t00*(1-wr)*(1-wc) + t01*(1-wr)*wc + t10*wr*(1-wc) + t11*wr*wc) * valid
//   mask  = valid ? msk[r0 + up(wr, r0)][c0 + up(wc, c0)] : 0
//   up(f, lo) = f > 0.5 || (f == 0.5 && lo odd)    (round half to even)
//
// Every multiply, add and subtract of the lerp is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn never contract into an FMA), in the order
// written above, so the result is bit-identical to the plain PyTorch version
// (unet_tpu_torch/ops/warp.py::grid_sample_fused_reference), where each step is
// a separate ATen op. Masks are uint8 (labels {0, 1}).
//
// What bounds it on an H100: bytes. Per pixel it must read rows and cols
// (8 B), the image (4 B) and the mask (1 B), and write the image (4 B) and the
// mask (1 B): 18 B, 151 MB for the training super-batch of 32 x 512^2, 0.045 ms
// at 3.35 TB/s. It does ~20 flops per pixel, nothing against the card's rate.
//
// What the design does about it: one thread per output pixel. Reads of rows and
// cols and writes of both outputs are coalesced (neighbouring threads,
// neighbouring pixels). The four image taps and the mask tap are gathers; the
// augmentation warp is spatially coherent (rotation <= 15 degrees, smooth
// elastic and grid fields), so neighbouring threads read neighbouring source
// pixels and L1/L2 serve most of the gather. The gathers go through the
// read-only path (__ldg). The TPU kernel's mechanics (whole planes resident in
// VMEM, 128-lane tiles, dynamic_gather, banded row/column windows) have no
// counterpart here. Staging each block's source band in shared memory, vector
// loads and fusing the coordinate composition are left to later versions.
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libwarp.so warp.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool round_up(float frac, int lo) {
  return frac > 0.5f || (frac == 0.5f && (lo & 1));
}

__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ img, const uint8_t* __restrict__ msk,
                const float* __restrict__ rows, const float* __restrict__ cols,
                float* __restrict__ out_img, uint8_t* __restrict__ out_msk,
                int n, int h, int w) {
  const long long plane = static_cast<long long>(h) * w;
  const long long total = plane * n;
  const float hm1 = static_cast<float>(h - 1);
  const float wm1 = static_cast<float>(w - 1);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float r = rows[i];
    const float c = cols[i];
    const bool valid = r >= 0.f && r <= hm1 && c >= 0.f && c <= wm1;
    const float rc = fminf(fmaxf(r, 0.f), hm1);
    const float cc = fminf(fmaxf(c, 0.f), wm1);
    const int r0 = min(static_cast<int>(floorf(rc)), h - 2);
    const int c0 = min(static_cast<int>(floorf(cc)), w - 2);
    const float wr = __fsub_rn(rc, static_cast<float>(r0));
    const float wc = __fsub_rn(cc, static_cast<float>(c0));
    const float omr = __fsub_rn(1.f, wr);
    const float omc = __fsub_rn(1.f, wc);

    const long long base = i - i % plane;  // the plane's first pixel
    const float* src = img + base + static_cast<long long>(r0) * w + c0;
    const float t00 = __ldg(src);
    const float t01 = __ldg(src + 1);
    const float t10 = __ldg(src + w);
    const float t11 = __ldg(src + w + 1);
    float v = __fmul_rn(__fmul_rn(t00, omr), omc);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t01, omr), wc));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t10, wr), omc));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t11, wr), wc));
    out_img[i] = __fmul_rn(v, valid ? 1.f : 0.f);  // as the reference's * valid

    const int rn = r0 + (round_up(wr, r0) ? 1 : 0);
    const int cn = c0 + (round_up(wc, c0) ? 1 : 0);
    out_msk[i] = valid ? __ldg(msk + base + static_cast<long long>(rn) * w + cn)
                       : static_cast<uint8_t>(0);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t as void*). img (N, H, W) f32, msk (N, H, W)
// uint8, rows/cols (N, H, W) f32, all contiguous; H, W >= 2. Returns the launch's
// cudaError_t (0 on success); never synchronises.
int warp_launch(const void* img, const void* msk, const void* rows,
                const void* cols, void* out_img, void* out_msk, int n, int h,
                int w, void* stream) {
  if (n <= 0) return 0;
  if (h < 2 || w < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * h * w;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const uint8_t*>(msk),
      static_cast<const float*>(rows), static_cast<const float*>(cols),
      static_cast<float*>(out_img), static_cast<uint8_t*>(out_msk), n, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* warp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
