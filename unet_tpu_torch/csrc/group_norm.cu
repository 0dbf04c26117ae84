// GroupNorm, with an optional ReLU after it, forward and backward, on
// channels_last maps, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no GroupNorm (its models are the
// U-Nets). The port's TransUNet R50-ViT-B/16 encoder runs 52 GroupNorms a
// forward. ATen's CUDA GroupNorm computes on the contiguous NCHW layout, so
// each call on the port's channels_last maps copied its input out of
// channels_last and its output back, forward and backward, around broadcast
// elementwise apply steps. Here a call is six kernels on channels_last itself:
//
//   forward   group_norm_stats          per-block sums of d = x - k and d^2 per
//                                       (sample, channel), k the channel's
//                                       value at the map's first pixel
//             group_norm_finalize       per (sample, group) mean and rstd,
//                                       merging the channels' centred sums
//                                       (Chan et al.); per (sample, channel)
//                                       a = rstd * w and b = bias - mean * a
//             group_norm_apply          y = relu?(a * x + b)
//   backward  group_norm_grad_stats     per-block sums of dy' and
//                                       dy' * (x - mean) per (sample, channel)
//             group_norm_grad_finalize  per (sample, channel) sum dy' and
//                                       sum dy' * xhat; per (sample, group)
//                                       c1 = -rstd^2 B, c2 = rstd (rstd B
//                                       mean - A), with A = mean of w dy',
//                                       B = mean of w dy' xhat over the group
//             group_norm_grad_input     dx = a * dy' + c1 * x + c2; one block
//                                       of each column tile also sums the
//                                       samples' sums into dbias, dweight
//
// with xhat = (x - mean) * rstd and dy' = dy where the forward's output was
// positive (the mask is recomputed from x, a and b with the forward's own FMA,
// so it is the forward's bit for bit; nothing but x and the per-(sample,
// channel) constants is kept for backward). Statistics are per (sample,
// group) over H x W x (C / G), with the biased variance. Sums about the shift
// k keep the variance of a group whose mean is large against its spread.
//
// Layout: x (N, C, H, W) in torch.channels_last memory is N row-major [HW, C]
// matrices. Arithmetic is f32 whatever the input (bf16 or f32), rounded once
// to the input's type at the store; weight and bias come in the input's
// type, dweight and dbias go out in it. Reductions write per-block partials
// and sum them in a fixed order: no float atomics, so a run repeats bit for
// bit.
//
// What bounds it on an H100: bytes. Per value the least traffic is x read and
// y written forward, dy and x read and dx written backward: 10 B in bf16. The
// passes move 16 B (bf16): the statistics pass reads x once more, the
// backward's statistics pass reads dy and x before grad_input reads them
// again (a whole-group reduction has to finish before any output can be
// written).
//
// What the design does about it: every thread loads 16 B along C (8 bf16 or
// 4 f32 channels; C has to be a multiple, and each map 16-B aligned) from
// neighbouring addresses, and keeps kUnroll loads in flight. A block of 256
// threads covers TX <= 16 vector columns by TY rows of one sample's map;
// column tiles split C beyond 16 vectors. Blocks split every map's pixels so
// that the grid holds two to four blocks per SM at every shape (at b4 there
// are only 128 (sample, group) pairs at G = 32). The apply passes walk the
// grid backwards, so they start on the end of the map that the statistics
// pass read last, which may still be in L2 (a b4 map is 2-33 MB).
//
// Build (plain C interface, loaded with ctypes by unet_tpu_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgroup_norm.so group_norm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kLoadsPerThread = 16;  // vector loads a thread makes at most,
                                     // where the blocks' floor allows
constexpr int kMinBlocks = 264;      // two blocks on each of 132 SMs
constexpr int kMaxBlocks = 528;      // four
constexpr int kVecBytes = 16;      // one load along C
constexpr int kMaxVec = kVecBytes / 2;
constexpr int kMaxTx = 16;           // vector columns a block
constexpr int kFinThreads = 256;     // channels a finalize block at most
constexpr int kFinRows = 4;          // partial rows a finalize thread sums

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
struct Pair {
  Pack<T, V> dy, x;
};

// Where a thread works in its sample's map: vector column `cx` of rows
// r0 + ty, r0 + ty + ty_n, ... below r1, for row block bx of column tile by.
struct Place {
  int tx, ty, cx;
  long long r0, r1;
  bool active;
};

__device__ __forceinline__ Place place(long long hw, int nv, int tx_n,
                                       int ty_n, long long rows_per_block,
                                       int bx, int by) {
  Place p;
  p.tx = threadIdx.x % tx_n;
  p.ty = threadIdx.x / tx_n;
  p.cx = by * tx_n + p.tx;
  p.r0 = static_cast<long long>(bx) * rows_per_block;
  p.r1 = min(hw, p.r0 + rows_per_block);
  p.active = p.ty < ty_n && p.cx < nv;
  return p;
}

// Calls use(load(r), r) for the thread's rows, kUnroll rows at a time with
// all their loads issued before the first use.
template <typename Loaded, typename Load, typename Use>
__device__ __forceinline__ void over_rows(const Place& p, int ty_n, Load load,
                                          Use use) {
  for (long long r = p.r0 + p.ty; r < p.r1;
       r += static_cast<long long>(ty_n) * kUnroll) {
    Loaded got[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + static_cast<long long>(u) * ty_n;
      if (rr < p.r1) got[u] = load(rr);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + static_cast<long long>(u) * ty_n;
      if (rr < p.r1) use(got[u], rr);
    }
  }
}

// The block's column sums of a[] and b[] over its TY rows of threads, in row
// order, into out = [sums of a (C) | sums of b (C)] for column tile by.
template <int V>
__device__ __forceinline__ void block_partials(const Place& p, int c,
                                               int tx_n, int ty_n, int by,
                                               const float (&a)[V],
                                               const float (&b)[V],
                                               float* __restrict__ out) {
  __shared__ float red[2][kThreads * kMaxVec];
  const int width = tx_n * V;  // channels of this column tile
  if (p.ty < ty_n) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[0][p.ty * width + p.tx * V + j] = a[j];
      red[1][p.ty * width + p.tx * V + j] = b[j];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < width; col += kThreads) {
    const int ch = by * width + col;
    if (ch >= c) break;
    float sa = 0.f, sb = 0.f;
    for (int t = 0; t < ty_n; ++t) {
      sa += red[0][t * width + col];
      sb += red[1][t * width + col];
    }
    out[ch] = sa;
    out[c + ch] = sb;
  }
}

// The per-call constants, sc = [a (N, C) | b (N, C) | mean (N, G) |
// rstd (N, G)], and coef = [c1 (N, G) | c2 (N, G)].
struct Consts {
  const float* sc;
  int n_maps, c, cpg;
  __device__ __forceinline__ int groups() const { return c / cpg; }
  __device__ __forceinline__ float a(int n, int ch) const {
    return sc[static_cast<long long>(n) * c + ch];
  }
  __device__ __forceinline__ float b(int n, int ch) const {
    return sc[static_cast<long long>(n_maps + n) * c + ch];
  }
  __device__ __forceinline__ long long group(int n, int ch) const {
    return static_cast<long long>(n) * groups() + ch / cpg;
  }
  __device__ __forceinline__ const float* mean() const {
    return sc + 2LL * n_maps * c;
  }
  __device__ __forceinline__ const float* rstd() const {
    return mean() + static_cast<long long>(n_maps) * groups();
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats(const T* __restrict__ x, long long hw, int c, int tx_n,
                     int ty_n, long long rows_per_block,
                     float* __restrict__ partial) {
  const int nv = c / V;
  const Place p =
      place(hw, nv, tx_n, ty_n, rows_per_block, blockIdx.x, blockIdx.y);
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (p.active) {
    const Pack<T, V>* xs = reinterpret_cast<const Pack<T, V>*>(x) +
                           static_cast<long long>(blockIdx.z) * hw * nv +
                           p.cx;
    const Pack<T, V> first = xs[0];
    float k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) k[j] = Elem<T>::load(first.v[j]);
    over_rows<Pack<T, V>>(
        p, ty_n, [&](long long r) { return xs[r * nv]; },
        [&](const Pack<T, V>& v, long long) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float d = __fsub_rn(Elem<T>::load(v.v[j]), k[j]);
            s[j] = __fadd_rn(s[j], d);
            q[j] = __fmaf_rn(d, d, q[j]);
          }
        });
  }
  block_partials<V>(
      p, c, tx_n, ty_n, blockIdx.y, s, q,
      partial + (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) *
                    2 * c);
}

// A finalize block's channels [c0, c0 + width) of whole groups, and its
// threads as `splits` rows of `width` lanes over the partials' rows.
struct Chunk {
  int c0, width, lane, split, splits;
  __device__ __forceinline__ Chunk(int c, int cb) {
    c0 = blockIdx.x * cb;
    width = min(cb, c - c0);
    lane = threadIdx.x % width;
    split = threadIdx.x / width;
    splits = kFinThreads / width;
  }
};

// Sample n's totals of the two partial sums of the chunk's channel `lane`,
// summed over row_blocks in a fixed order (each split its rows, then the
// splits in order); valid in threads below ch.width.
__device__ __forceinline__ void chunk_totals(const Chunk& ch,
                                             const float* __restrict__ partial,
                                             int row_blocks, int c, int n,
                                             float (&red)[2][kFinThreads],
                                             float& s1, float& s2) {
  if (ch.split < ch.splits) {
    const float* part = partial +
                        static_cast<long long>(n) * row_blocks * 2 * c +
                        ch.c0 + ch.lane;
    float a = 0.f, b = 0.f;
#pragma unroll 4
    for (int r = ch.split; r < row_blocks; r += ch.splits) {
      a += part[static_cast<long long>(r) * 2 * c];
      b += part[static_cast<long long>(r) * 2 * c + c];
    }
    red[0][threadIdx.x] = a;
    red[1][threadIdx.x] = b;
  }
  __syncthreads();
  s1 = s2 = 0.f;
  if (threadIdx.x < ch.width) {
    for (int t = 0; t < ch.splits; ++t) {
      s1 += red[0][t * ch.width + ch.lane];
      s2 += red[1][t * ch.width + ch.lane];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinThreads)
    group_norm_finalize(const T* __restrict__ x,
                        const float* __restrict__ partial, int row_blocks,
                        int n_maps, long long hw, int c, int cpg, int cb,
                        float eps, const T* __restrict__ weight,
                        const T* __restrict__ bias, float* __restrict__ sc) {
  __shared__ float red[2][kFinThreads];
  __shared__ float mean_c[kFinThreads], m2_c[kFinThreads];
  __shared__ float g_mean[kFinThreads], g_rstd[kFinThreads];
  const Chunk ch(c, cb);
  const int n = blockIdx.y;
  const float count = static_cast<float>(hw);
  float s1, s2;
  chunk_totals(ch, partial, row_blocks, c, n, red, s1, s2);
  if (threadIdx.x < ch.width) {
    // mean and centred sum of squares of the channel, about its shift
    const float shift = Elem<T>::load(
        x[static_cast<long long>(n) * hw * c + ch.c0 + ch.lane]);
    const float d = __fdiv_rn(s1, count);
    mean_c[ch.lane] = __fadd_rn(shift, d);
    m2_c[ch.lane] = fmaxf(__fsub_rn(s2, __fmul_rn(s1, d)), 0.f);
  }
  __syncthreads();
  const int g_n = c / cpg;
  float* mean = sc + 2LL * n_maps * c;
  float* rstd = mean + static_cast<long long>(n_maps) * g_n;
  for (int gl = threadIdx.x; gl < ch.width / cpg; gl += kFinThreads) {
    float m = 0.f;
    for (int j = 0; j < cpg; ++j) m += mean_c[gl * cpg + j];
    m = __fdiv_rn(m, static_cast<float>(cpg));
    float m2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      const float dd = __fsub_rn(mean_c[gl * cpg + j], m);
      m2 = __fadd_rn(m2, __fmaf_rn(__fmul_rn(count, dd), dd,
                                   m2_c[gl * cpg + j]));
    }
    const float var = __fdiv_rn(m2, __fmul_rn(count, static_cast<float>(cpg)));
    const float r = __frsqrt_rn(__fadd_rn(var, eps));
    const long long g = static_cast<long long>(n) * g_n + ch.c0 / cpg + gl;
    mean[g] = m;
    rstd[g] = r;
    g_mean[gl] = m;
    g_rstd[gl] = r;
  }
  __syncthreads();
  if (threadIdx.x < ch.width) {
    const int c_abs = ch.c0 + ch.lane;
    const int gl = ch.lane / cpg;
    const float a = __fmul_rn(g_rstd[gl], Elem<T>::load(weight[c_abs]));
    sc[static_cast<long long>(n) * c + c_abs] = a;
    sc[static_cast<long long>(n_maps + n) * c + c_abs] =
        __fsub_rn(Elem<T>::load(bias[c_abs]), __fmul_rn(g_mean[gl], a));
  }
}

// The thread's a and b for its V channels of sample n.
template <int V>
struct Affine {
  float a[V], b[V];
  __device__ __forceinline__ Affine(const Consts& k, int n, int cx) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = k.a(n, cx * V + j);
      b[j] = k.b(n, cx * V + j);
    }
  }
};

// dy' (dy where the forward's output was positive) of one element.
__device__ __forceinline__ float masked(float g, float f, float a, float b,
                                        int relu) {
  return (relu && !(__fmaf_rn(f, a, b) > 0.f)) ? 0.f : g;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_apply(const T* __restrict__ x, long long hw, int c, int tx_n,
                     int ty_n, long long rows_per_block, Consts k, int relu,
                     T* __restrict__ y) {
  // the grid backwards: the statistics pass ended on this end of x
  const int bx = gridDim.x - 1 - blockIdx.x;
  const int by = gridDim.y - 1 - blockIdx.y;
  const int n = gridDim.z - 1 - blockIdx.z;
  const int nv = c / V;
  const Place p = place(hw, nv, tx_n, ty_n, rows_per_block, bx, by);
  if (!p.active) return;
  const Affine<V> f(k, n, p.cx);
  const long long base = static_cast<long long>(n) * hw * nv + p.cx;
  const Pack<T, V>* xs = reinterpret_cast<const Pack<T, V>*>(x) + base;
  Pack<T, V>* ys = reinterpret_cast<Pack<T, V>*>(y) + base;
  over_rows<Pack<T, V>>(
      p, ty_n, [&](long long r) { return xs[r * nv]; },
      [&](const Pack<T, V>& v, long long r) {
        Pack<T, V> out;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float o = __fmaf_rn(Elem<T>::load(v.v[j]), f.a[j], f.b[j]);
          if (relu && o < 0.f) o = 0.f;  // NaN passes, as torch.relu
          out.v[j] = Elem<T>::store(o);
        }
        ys[r * nv] = out;
      });
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_grad_stats(const T* __restrict__ dy, const T* __restrict__ x,
                          long long hw, int c, int tx_n, int ty_n,
                          long long rows_per_block, Consts k, int relu,
                          float* __restrict__ partial) {
  const int n = blockIdx.z;
  const int nv = c / V;
  const Place p =
      place(hw, nv, tx_n, ty_n, rows_per_block, blockIdx.x, blockIdx.y);
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (p.active) {
    const Affine<V> f(k, n, p.cx);
    float mean[V];
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = k.mean()[k.group(n, p.cx * V + j)];
    const long long base = static_cast<long long>(n) * hw * nv + p.cx;
    const Pack<T, V>* gs = reinterpret_cast<const Pack<T, V>*>(dy) + base;
    const Pack<T, V>* xs = reinterpret_cast<const Pack<T, V>*>(x) + base;
    over_rows<Pair<T, V>>(
        p, ty_n,
        [&](long long r) { return Pair<T, V>{gs[r * nv], xs[r * nv]}; },
        [&](const Pair<T, V>& v, long long) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xv = Elem<T>::load(v.x.v[j]);
            const float g =
                masked(Elem<T>::load(v.dy.v[j]), xv, f.a[j], f.b[j], relu);
            s[j] = __fadd_rn(s[j], g);
            q[j] = __fmaf_rn(g, __fsub_rn(xv, mean[j]), q[j]);
          }
        });
  }
  block_partials<V>(
      p, c, tx_n, ty_n, blockIdx.y, s, q,
      partial + (static_cast<long long>(n) * gridDim.x + blockIdx.x) * 2 * c);
}

template <typename T>
__global__ void __launch_bounds__(kFinThreads)
    group_norm_grad_finalize(const float* __restrict__ partial,
                             int row_blocks, long long hw, int cb, Consts k,
                             const T* __restrict__ weight,
                             float* __restrict__ sums,
                             float* __restrict__ coef) {
  __shared__ float red[2][kFinThreads];
  __shared__ float h1[kFinThreads], h2[kFinThreads];
  const int c = k.c, cpg = k.cpg;
  const Chunk ch(c, cb);
  const int n = blockIdx.y;
  const int c_abs = ch.c0 + ch.lane;
  float s1, s2;
  chunk_totals(ch, partial, row_blocks, c, n, red, s1, s2);
  if (threadIdx.x < ch.width) {
    // s2 is sum dy' * (x - mean): times rstd, sum dy' * xhat
    const float sx = __fmul_rn(s2, k.rstd()[k.group(n, c_abs)]);
    const float w = Elem<T>::load(weight[c_abs]);
    sums[static_cast<long long>(n) * c + c_abs] = s1;
    sums[static_cast<long long>(k.n_maps + n) * c + c_abs] = sx;
    h1[ch.lane] = __fmul_rn(w, s1);
    h2[ch.lane] = __fmul_rn(w, sx);
  }
  __syncthreads();
  const float m_count = __fmul_rn(static_cast<float>(hw),
                                  static_cast<float>(cpg));
  for (int gl = threadIdx.x; gl < ch.width / cpg; gl += kFinThreads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += h1[gl * cpg + j];
      b += h2[gl * cpg + j];
    }
    a = __fdiv_rn(a, m_count);
    b = __fdiv_rn(b, m_count);
    const long long g = k.group(n, ch.c0 + gl * cpg);
    const float rstd = k.rstd()[g], mean = k.mean()[g];
    coef[g] = -__fmul_rn(__fmul_rn(rstd, rstd), b);
    coef[static_cast<long long>(k.n_maps) * k.groups() + g] = __fmul_rn(
        rstd, __fsub_rn(__fmul_rn(__fmul_rn(rstd, b), mean), a));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_norm_grad_input(const T* __restrict__ dy, const T* __restrict__ x,
                          long long hw, int c, int tx_n, int ty_n,
                          long long rows_per_block, Consts k,
                          const float* __restrict__ coef,
                          const float* __restrict__ sums, int relu,
                          T* __restrict__ dx, T* __restrict__ dweight,
                          T* __restrict__ dbias) {
  if (blockIdx.x == 0 && blockIdx.z == 0) {
    // this column tile's dbias and dweight: the samples' sums, in order
    const int width = tx_n * V;
    for (int col = threadIdx.x; col < width; col += kThreads) {
      const int ch = blockIdx.y * width + col;
      if (ch >= c) break;
      float db = 0.f, dw = 0.f;
      for (int n = 0; n < k.n_maps; ++n) {
        db = __fadd_rn(db, sums[static_cast<long long>(n) * c + ch]);
        dw = __fadd_rn(dw, sums[static_cast<long long>(k.n_maps + n) * c +
                                ch]);
      }
      dbias[ch] = Elem<T>::store(db);
      dweight[ch] = Elem<T>::store(dw);
    }
  }
  // the grid backwards: the statistics pass ended on this end of dy and x
  const int bx = gridDim.x - 1 - blockIdx.x;
  const int by = gridDim.y - 1 - blockIdx.y;
  const int n = gridDim.z - 1 - blockIdx.z;
  const int nv = c / V;
  const Place p = place(hw, nv, tx_n, ty_n, rows_per_block, bx, by);
  if (!p.active) return;
  const Affine<V> f(k, n, p.cx);
  const long long stride = static_cast<long long>(k.n_maps) * k.groups();
  float c1[V], c2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long g = k.group(n, p.cx * V + j);
    c1[j] = coef[g];
    c2[j] = coef[stride + g];
  }
  const long long base = static_cast<long long>(n) * hw * nv + p.cx;
  const Pack<T, V>* gs = reinterpret_cast<const Pack<T, V>*>(dy) + base;
  const Pack<T, V>* xs = reinterpret_cast<const Pack<T, V>*>(x) + base;
  Pack<T, V>* ds = reinterpret_cast<Pack<T, V>*>(dx) + base;
  over_rows<Pair<T, V>>(
      p, ty_n,
      [&](long long r) { return Pair<T, V>{gs[r * nv], xs[r * nv]}; },
      [&](const Pair<T, V>& v, long long r) {
        Pack<T, V> out;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xv = Elem<T>::load(v.x.v[j]);
          const float g =
              masked(Elem<T>::load(v.dy.v[j]), xv, f.a[j], f.b[j], relu);
          out.v[j] = Elem<T>::store(
              __fmaf_rn(f.a[j], g, __fmaf_rn(c1[j], xv, c2[j])));
        }
        ds[r * nv] = out;
      });
}

struct Geometry {
  int tx, ty, col_tiles, row_blocks;
  long long rows_per_block;
};

// TX vector columns (16-B loads along C) by TY rows a block, and row blocks
// per (sample, column tile) enough for kLoadsPerThread loads a thread, with
// kMinBlocks to kMaxBlocks blocks in all where the maps have the rows; a block
// has at least TY rows. So n * row_blocks <= kMaxBlocks + n - 1.
Geometry geometry(int n, long long hw, int c, int elem) {
  Geometry g;
  const int nv = c / (kVecBytes / elem);
  g.tx = nv < kMaxTx ? nv : kMaxTx;
  g.ty = kThreads / g.tx;
  g.col_tiles = (nv + g.tx - 1) / g.tx;
  const long long per_block = static_cast<long long>(kThreads) *
                              kLoadsPerThread;
  long long want = (static_cast<long long>(n) * hw * nv + per_block - 1) /
                   per_block;
  if (want < kMinBlocks) want = kMinBlocks;
  if (want > kMaxBlocks) want = kMaxBlocks;
  const long long maps = static_cast<long long>(n) * g.col_tiles;
  long long per_map = (want + maps - 1) / maps;
  const long long most = (hw + g.ty - 1) / g.ty;
  if (per_map > most) per_map = most;
  if (per_map < 1) per_map = 1;
  g.rows_per_block = (hw + per_map - 1) / per_map;
  g.row_blocks = static_cast<int>((hw + g.rows_per_block - 1) /
                                  g.rows_per_block);
  return g;
}

dim3 grid_of(const Geometry& g, int n) {
  return dim3(g.row_blocks, g.col_tiles, n);
}

// Channels a finalize block: whole groups, at most kFinThreads channels,
// few enough that its threads sum at most kFinRows partial rows each where
// whole groups allow.
int chunk_of(int c, int cpg, int row_blocks) {
  int splits = (row_blocks + kFinRows - 1) / kFinRows;
  if (splits > kFinThreads) splits = kFinThreads;
  int cb = kFinThreads / splits;
  cb -= cb % cpg;
  if (cb < cpg) cb = cpg;
  return cb < c ? cb : c;
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <typename T>
struct Type {
  using type = T;
};
template <int V>
using Vec = std::integral_constant<int, V>;

// Calls launch(Type<T>, Vec<V>) for the element type, V of its values a
// 16-B load.
template <typename Launch>
void dispatch(int bf16, Launch launch) {
  if (bf16) {
    launch(Type<uint16_t>{}, Vec<kVecBytes / 2>{});
  } else {
    launch(Type<float>{}, Vec<kVecBytes / 4>{});
  }
}

// Arguments a call refuses: a finalize block holds whole groups of at most
// kFinThreads channels, and every map is read and written in 16-B loads along
// C, so C is a multiple of a load's values and each map 16-B aligned.
bool bad_args(int c, int cpg, int elem, const void* a, const void* b = nullptr,
              const void* d = nullptr) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(d);
  return cpg < 1 || cpg > kFinThreads || c % cpg != 0 ||
         c % (kVecBytes / elem) != 0 || addr % kVecBytes != 0;
}

}  // namespace

extern "C" {

// Blocks a statistics pass writes partials for at most, less the samples:
// the caller's partial buffer holds (gn_max_blocks() + N) * 2 * C floats.
int gn_max_blocks() { return kMaxBlocks; }

// Channels a group may hold at most, and the bytes of a load along C: C is a
// multiple of a load's values and every map starts on a load's boundary.
int gn_max_group_channels() { return kFinThreads; }
int gn_vector_bytes() { return kVecBytes; }

// Forward statistics of x (N maps of HW rows of C channels, bf16 if `bf16`
// else f32, channels innermost) in groups of cpg channels, and the per-call
// constants sc = [a (N, C) | b (N, C) | mean (N, G) | rstd (N, G)]. weight and
// bias are C values of x's type. Two launches. Each entry point returns the
// first failed launch's cudaError_t (0 on success) and never synchronises.
int gn_forward_stats(const void* x, int bf16, int n, long long hw, int c,
                     int cpg, float eps, const void* weight, const void* bias,
                     float* partial, float* sc, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (bad_args(c, cpg, elem, x)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n, hw, c, elem);
  const cudaStream_t s = as_stream(stream);
  dispatch(bf16, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    group_norm_stats<T, decltype(v)::value><<<grid_of(g, n), kThreads, 0, s>>>(
        static_cast<const T*>(x), hw, c, g.tx, g.ty, g.rows_per_block,
        partial);
  });
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int cb = chunk_of(c, cpg, g.row_blocks);
  const dim3 grid((c + cb - 1) / cb, n);
  if (bf16) {
    group_norm_finalize<uint16_t><<<grid, kFinThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), partial, g.row_blocks, n, hw, c, cpg,
        cb, eps, static_cast<const uint16_t*>(weight),
        static_cast<const uint16_t*>(bias), sc);
  } else {
    group_norm_finalize<float><<<grid, kFinThreads, 0, s>>>(
        static_cast<const float*>(x), partial, g.row_blocks, n, hw, c, cpg,
        cb, eps, static_cast<const float*>(weight),
        static_cast<const float*>(bias), sc);
  }
  return static_cast<int>(cudaGetLastError());
}

// y = relu?(a * x + b), y laid out as x. One launch.
int gn_forward_apply(const void* x, int bf16, int n, long long hw, int c,
                     int cpg, const float* sc, int relu, void* y,
                     void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (bad_args(c, cpg, elem, x, y))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n, hw, c, elem);
  const Consts k{sc, n, c, cpg};
  dispatch(bf16, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    group_norm_apply<T, decltype(v)::value>
        <<<grid_of(g, n), kThreads, 0, as_stream(stream)>>>(
            static_cast<const T*>(x), hw, c, g.tx, g.ty, g.rows_per_block, k,
            relu, static_cast<T*>(y));
  });
  return static_cast<int>(cudaGetLastError());
}

// Backward sums: sums = [sum dy' (N, C) | sum dy' * xhat (N, C)] and the
// coefficients coef = [c1 (N, G) | c2 (N, G)] of grad_input. Two launches.
int gn_backward_sums(const void* dy, const void* x, int bf16, int n,
                     long long hw, int c, int cpg, const float* sc,
                     const void* weight, int relu, float* partial,
                     float* sums, float* coef, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (bad_args(c, cpg, elem, x, dy))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n, hw, c, elem);
  const cudaStream_t s = as_stream(stream);
  const Consts k{sc, n, c, cpg};
  dispatch(bf16, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    group_norm_grad_stats<T, decltype(v)::value>
        <<<grid_of(g, n), kThreads, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), hw, c, g.tx,
            g.ty, g.rows_per_block, k, relu, partial);
  });
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int cb = chunk_of(c, cpg, g.row_blocks);
  const dim3 grid((c + cb - 1) / cb, n);
  if (bf16) {
    group_norm_grad_finalize<uint16_t><<<grid, kFinThreads, 0, s>>>(
        partial, g.row_blocks, hw, cb, k,
        static_cast<const uint16_t*>(weight), sums, coef);
  } else {
    group_norm_grad_finalize<float><<<grid, kFinThreads, 0, s>>>(
        partial, g.row_blocks, hw, cb, k, static_cast<const float*>(weight),
        sums, coef);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = a * dy' + c1 * x + c2, dx laid out as x; dbias and dweight (C values
// of x's type) from the sums over the samples. One launch.
int gn_backward_input(const void* dy, const void* x, int bf16, int n,
                      long long hw, int c, int cpg, const float* sc,
                      const float* coef, const float* sums, int relu,
                      void* dx, void* dweight, void* dbias, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (bad_args(c, cpg, elem, x, dy, dx))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n, hw, c, elem);
  const Consts k{sc, n, c, cpg};
  dispatch(bf16, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    group_norm_grad_input<T, decltype(v)::value>
        <<<grid_of(g, n), kThreads, 0, as_stream(stream)>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x), hw, c, g.tx,
            g.ty, g.rows_per_block, k, coef, sums, relu, static_cast<T*>(dx),
            static_cast<T*>(dweight), static_cast<T*>(dbias));
  });
  return static_cast<int>(cudaGetLastError());
}

const char* gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
