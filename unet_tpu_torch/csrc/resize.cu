// Bilinear resize with align_corners=True, forward and backward, on
// channels_last maps whose output is at least as large as the input in each
// dimension, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's resize (unet_tpu/ops/resize.py)
// is gather tables and lerps that XLA fuses. The port's U-Nets and TransUNet
// upsample their decoder maps 2x (64 to 512 channels, 32^2 to 512^2), the
// Attention U-Net's gates resize W_g's output the same way, and deep
// supervision resizes its 2-channel float32 maps 2x, 4x and 8x. ATen's
// channels_last kernels computed one value a thread, and its backward zeroed
// grad_input and scattered every output gradient into four inputs with bf16
// atomics, after copying the gradient (a channel slice of the decoder
// concat's gradient) to a contiguous tensor.
//
//   forward   resize_forward   y = lerp(lerp(x[lo_y, lo_x], x[hi_y, lo_x],
//                              w_y), lerp(x[lo_y, hi_x], x[hi_y, hi_x], w_y),
//                              w_x), lerp(a, b, w) = a + (b - a) * w
//   backward  resize_backward  dx[j_y, j_x] = sum over the outputs whose
//                              taps reach (j_y, j_x) of the adjoint weights
//                              times dy: a gather, without atomics
//
// Taps (ATen's, and ops/resize.py::_taps): src = i * scale in float32, scale
// = f32(in - 1) / f32(out - 1) formed by the caller (0 for out = 1), lo =
// (int)src capped at in - 1, hi = lo + 1 except at in - 1, w = src - lo. The
// outputs whose taps reach input j are those with lo in {j - 1, j}: lo never
// decreases and steps by at most 1 (scale <= 1), so they are the range
// [first(j - 1), first(j + 1)), first(k) the first output with lo >= k.
// first() starts from k / scale and steps to the exact index with the taps'
// own float32 expression: no table, and the same rule as
// ops/resize.py::first_reaching, which the CPU tests hold exhaustively.
//
// Arithmetic is float32, rounded once to the map's type at the store. The
// forward's lerps are unfused multiplies and adds in the order above, so the
// forward equals the plain version (ops/resize.py::resize_rows_align_corners)
// bit for bit. The backward sums in a fixed order: a run repeats bit for bit.
//
// What bounds it on an H100: bytes, at about one operation a byte. The least
// traffic is the input read and the output written once each way (2x: 5 B
// for every 4 B of output in bf16). What the design does about it: a thread
// owns one 16-B vector along C (8 bf16 or 4 f32 channels; narrower where C,
// the gradient's pixel stride or a pointer do not allow 16 B) at one column,
// for a strip of up to kMaxRows rows; neighbouring threads go along C, then
// along the row, so loads and stores coalesce. Down the strip a thread keeps
// the input rows it read (forward) or its running sums (backward) in
// registers, so a row of the larger map is read or written once a strip and
// a thread's taps are computed once a row and once a column. Strips shorten
// for small maps so that the grid still fills the card. The backward reads
// dy at any pixel stride (the concat's gradient is read in place: its pixels
// are C_skip + C_up apart) and writes dx once: no zero-fill, no second pass.
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libresize.so resize.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;                          // rows a thread at most
constexpr long long kFillThreads = 132LL * 1024 * 2;  // two waves, 1024 an SM
constexpr int kCols = 6;  // loads a backward row keeps in flight at once
constexpr int kMaxGridYZ = 65535;

// Element types: f32 as it is, bf16 as its 16 bits.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Elem<uint16_t> {
  static __device__ __forceinline__ float load(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ uint16_t store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = Elem<T>::load(pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) pk.v[k] = Elem<T>::store(in[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

struct Tap {
  int lo, hi;
  float w;
};

__device__ __forceinline__ Tap tap(int i, float scale, int in) {
  const float src = __fmul_rn(static_cast<float>(i), scale);
  Tap t;
  t.lo = min(static_cast<int>(src), in - 1);
  t.hi = t.lo < in - 1 ? t.lo + 1 : t.lo;
  t.w = __fsub_rn(src, static_cast<float>(t.lo));
  return t;
}

// The first output index whose lower tap is at least k: 0 for k <= 0, out
// for k > in - 1.
__device__ __forceinline__ int first_reaching(int k, float scale, int in,
                                              int out) {
  if (k <= 0) return 0;
  if (k > in - 1) return out;
  int i = max(0, static_cast<int>(__fdiv_rn(static_cast<float>(k), scale)) - 2);
  i = min(i, out);
  while (i > 0 && tap(i - 1, scale, in).lo >= k) --i;
  while (i < out && tap(i, scale, in).lo < k) ++i;
  return i;
}

// The adjoint weight of output tap t at input index j (t reaches j).
__device__ __forceinline__ float weight_at(const Tap& t, int j) {
  if (t.lo != j) return t.w;  // lo = j - 1, hi = j
  const float w0 = __fsub_rn(1.0f, t.w);
  return t.hi == j ? __fadd_rn(w0, t.w) : w0;
}

// One thread: channel vector cv of column ox in sample n, output rows
// [oy0, oy1). a = input row lo, b = input row hi; l = column lo, r = column hi.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    resize_forward(const T* __restrict__ x, int c, int in_h, int in_w,
                   int out_h, int out_w, float sh, float sw, int rows,
                   T* __restrict__ y) {
  const int nv = c / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= out_w * nv) return;
  const int cv = t % nv, ox = t / nv, n = blockIdx.z;
  const int oy0 = blockIdx.y * rows, oy1 = min(out_h, oy0 + rows);
  const Tap tx = tap(ox, sw, in_w);
  const long long row_in = static_cast<long long>(in_w) * c;
  const long long row_out = static_cast<long long>(out_w) * c;
  const T* xn = x + static_cast<long long>(n) * in_h * row_in + cv * V;
  const long long xl = static_cast<long long>(tx.lo) * c;
  const long long xr = static_cast<long long>(tx.hi) * c;
  T* yn = y + static_cast<long long>(n) * out_h * row_out +
          static_cast<long long>(ox) * c + cv * V;
  float al[V], ar[V], bl[V], br[V];
  int lo = -1, hi = -1;
  for (int oy = oy0; oy < oy1; ++oy) {
    const Tap ty = tap(oy, sh, in_h);
    if (ty.lo != lo) {
      if (ty.lo == hi) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          al[k] = bl[k];
          ar[k] = br[k];
        }
      } else {
        load_vec<T, V>(xn + ty.lo * row_in + xl, al);
        load_vec<T, V>(xn + ty.lo * row_in + xr, ar);
      }
      if (ty.hi != ty.lo) {
        load_vec<T, V>(xn + ty.hi * row_in + xl, bl);
        load_vec<T, V>(xn + ty.hi * row_in + xr, br);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          bl[k] = al[k];
          br[k] = ar[k];
        }
      }
      lo = ty.lo;
      hi = ty.hi;
    }
    float out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float l = __fadd_rn(al[k], __fmul_rn(__fsub_rn(bl[k], al[k]), ty.w));
      const float r = __fadd_rn(ar[k], __fmul_rn(__fsub_rn(br[k], ar[k]), ty.w));
      out[k] = __fadd_rn(l, __fmul_rn(__fsub_rn(r, l), tx.w));
    }
    store_vec<T, V>(yn + oy * row_out, out);
  }
}

// One thread: channel vector cv of input column jx in sample n, input rows
// [jy0, jy1). For each output row that reaches the strip, r = the row's
// contributors along x weighted (their loads issued kCols at a time, before
// the first is used: 4 or 5 at 2x); r goes into the running sums of the
// input rows lo and hi of that output row (`cur` for row j, `next` for
// j + 1), and row j is stored once no later output row reaches it.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    resize_backward(const T* __restrict__ dy, long long ps, int c, int in_h,
                    int in_w, int out_h, int out_w, float sh, float sw,
                    int rows, T* __restrict__ dx) {
  const int nv = c / V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= in_w * nv) return;
  const int cv = t % nv, jx = t / nv, n = blockIdx.z;
  const int jy0 = blockIdx.y * rows, jy1 = min(in_h, jy0 + rows);
  const int ix0 = first_reaching(jx - 1, sw, in_w, out_w);
  const int ix1 = first_reaching(jx + 1, sw, in_w, out_w);
  const int iy0 = first_reaching(jy0 - 1, sh, in_h, out_h);
  const int iy1 = first_reaching(jy1, sh, in_h, out_h);
  const long long row_out = static_cast<long long>(out_w) * ps;
  const long long row_in = static_cast<long long>(in_w) * c;
  const T* g = dy + static_cast<long long>(n) * out_h * row_out + cv * V;
  T* d = dx + static_cast<long long>(n) * in_h * row_in +
         static_cast<long long>(jx) * c + cv * V;
  float wx0[kCols];  // the first kCols contributors' weights
#pragma unroll
  for (int q = 0; q < kCols; ++q)
    wx0[q] = ix0 + q < ix1 ? weight_at(tap(ix0 + q, sw, in_w), jx) : 0.0f;
  float cur[V], next[V];
#pragma unroll
  for (int k = 0; k < V; ++k) cur[k] = next[k] = 0.0f;
  int j = jy0;
  for (int iy = iy0; iy < iy1; ++iy) {
    const Tap ty = tap(iy, sh, in_h);
    while (ty.lo > j) {
      store_vec<T, V>(d + j * row_in, cur);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        cur[k] = next[k];
        next[k] = 0.0f;
      }
      ++j;
    }
    float r[V];
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = 0.0f;
    const T* gr = g + iy * row_out;
    for (int base = ix0; base < ix1; base += kCols) {
      Pack<T, V> pk[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (base + q < ix1)
          pk[q] = *reinterpret_cast<const Pack<T, V>*>(gr + (base + q) * ps);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (base + q < ix1) {
          const float wx = base == ix0
                               ? wx0[q]
                               : weight_at(tap(base + q, sw, in_w), jx);
#pragma unroll
          for (int k = 0; k < V; ++k)
            r[k] = fmaf(wx, Elem<T>::load(pk[q].v[k]), r[k]);
        }
      }
    }
    // lo is j, or j - 1 above the strip (then only hi = j is summed here)
    const float wj = weight_at(ty, j);
    const bool split = ty.lo == j && ty.hi != j;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cur[k] = fmaf(wj, r[k], cur[k]);
      if (split) next[k] = fmaf(ty.w, r[k], next[k]);
    }
  }
  while (j < jy1) {
    store_vec<T, V>(d + j * row_in, cur);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cur[k] = next[k];
      next[k] = 0.0f;
    }
    ++j;
  }
}

// The widest load along C, 16 B at most and one element at least, that
// divides C, the pixel stride and every pointer.
int vector_bytes(int elem, long long c, long long ps, const void* a,
                 const void* b) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w > elem; w /= 2)
    if ((c * elem) % w == 0 && (ps * elem) % w == 0 && addr % w == 0) return w;
  return elem;
}

// Rows a thread takes: as many as keep two waves of threads on the card,
// between 1 and kMaxRows, and enough that the grid's y fits.
int rows_of(int n, int h, long long row_threads) {
  long long rows = static_cast<long long>(n) * h * row_threads / kFillThreads;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  while ((h + rows - 1) / rows > kMaxGridYZ) ++rows;
  return static_cast<int>(rows);
}

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Vec = std::integral_constant<int, V>;

// Calls launch(Type<T>, Vec<V>) for the element type and V values a load of
// `bytes`.
template <typename Launch>
void dispatch(int bf16, int bytes, Launch launch) {
  if (bf16) {
    switch (bytes) {
      case 16: launch(Type<uint16_t>{}, Vec<8>{}); break;
      case 8: launch(Type<uint16_t>{}, Vec<4>{}); break;
      case 4: launch(Type<uint16_t>{}, Vec<2>{}); break;
      default: launch(Type<uint16_t>{}, Vec<1>{}); break;
    }
  } else {
    switch (bytes) {
      case 16: launch(Type<float>{}, Vec<4>{}); break;
      case 8: launch(Type<float>{}, Vec<2>{}); break;
      default: launch(Type<float>{}, Vec<1>{}); break;
    }
  }
}

// Shapes a call refuses: an empty map, a downsample, a pixel stride below C,
// more samples than the grid holds, or a row of vectors beyond an int.
bool bad_args(int n, int c, int in_h, int in_w, int out_h, int out_w,
              long long ps) {
  return n < 1 || c < 1 || in_h < 1 || in_w < 1 || out_h < in_h ||
         out_w < in_w || ps < c || n > kMaxGridYZ ||
         static_cast<long long>(out_w) * c >= (1LL << 31) - kThreads;
}

}  // namespace

extern "C" {

// y (N, out_h, out_w, C) from x (N, in_h, in_w, C), both channels innermost
// and dense, bf16 if `bf16` else f32; sh, sw the taps' scales. One launch.
// Each entry point returns the launch's cudaError_t (0 on success) and
// never synchronises.
int rs_forward(const void* x, int bf16, int n, int c, int in_h, int in_w,
               int out_h, int out_w, float sh, float sw, void* y,
               void* stream) {
  if (bad_args(n, c, in_h, in_w, out_h, out_w, c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = bf16 ? 2 : 4;
  const int bytes = vector_bytes(elem, c, c, x, y);
  const int nv = c / (bytes / elem);
  const int rows = rows_of(n, out_h, static_cast<long long>(out_w) * nv);
  const dim3 grid((out_w * nv + kThreads - 1) / kThreads,
                  (out_h + rows - 1) / rows, n);
  dispatch(bf16, bytes, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    resize_forward<T, decltype(v)::value>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), c, in_h, in_w, out_h, out_w, sh, sw,
            rows, static_cast<T*>(y));
  });
  return static_cast<int>(cudaGetLastError());
}

// dx (N, in_h, in_w, C), dense, from dy (N, out_h, out_w, C) whose pixels lie
// `ps` elements apart (ps >= C; the pointer carries any channel offset, as a
// channel slice of a wider channels_last tensor has it). One launch.
int rs_backward(const void* dy, long long ps, int bf16, int n, int c,
                int in_h, int in_w, int out_h, int out_w, float sh, float sw,
                void* dx, void* stream) {
  if (bad_args(n, c, in_h, in_w, out_h, out_w, ps))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = bf16 ? 2 : 4;
  const int bytes = vector_bytes(elem, c, ps, dy, dx);
  const int nv = c / (bytes / elem);
  const int rows = rows_of(n, in_h, static_cast<long long>(in_w) * nv);
  const dim3 grid((in_w * nv + kThreads - 1) / kThreads,
                  (in_h + rows - 1) / rows, n);
  dispatch(bf16, bytes, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    resize_backward<T, decltype(v)::value>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(dy), ps, c, in_h, in_w, out_h, out_w, sh,
            sw, rows, static_cast<T*>(dx));
  });
  return static_cast<int>(cudaGetLastError());
}

const char* rs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
