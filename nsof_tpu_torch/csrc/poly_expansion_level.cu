// K11: the level route's polynomial expansion, bit for bit its plain PyTorch
// version (ops/farneback_fast.py::_poly_expansion_level_plain).
//
// Replaces no TPU kernel: the JAX package runs the level route's expansion as
// XLA depthwise convolutions (nsof_tpu/ops/farneback_fast.py::
// poly_expansion_fast, _poly_expansion_channels), not as a Pallas kernel.  The
// port's plain version sums shifted slices one tap at a time, ≈ 450 launches
// an image at n = 10.  K2 (poly_expansion.cu) computes the same function on
// the fused route's canvas, but sums centre tap first and folds hi ± lo; the
// level route sums in tap order, and its flow magnifies one ulp, so this
// kernel keeps the plain version's order and rounding instead.
//
// What it computes.  For a [B, H, W] float32 image and a pad p ≥ 0, the
// [B, 5, H + 2p, W + 2p] planes b_y, b_x, a_yy, a_xx, a_xy: canvas pixel
// (Y, X) holds the expansion at (clamp(Y − p), clamp(X − p)), so p = 0 gives
// r0 and p = radius + 1 gives the edge-padded r1p of the level.
//
// Rounding: every step as PyTorch rounds it on the card.
// - The vertical sums s0 (g), s1 (x·g), s2 (x²·g) run over image rows
//   clamp(y − n + t), t = 0 … 2n, top first; the horizontal sums over the
//   vertical sums at columns clamp(x − n + t), left first.  A sum starts with
//   k[0]·x[0] (one rounding) and adds each tap as PyTorch's CUDA
//   a.add_(b, alpha=k) does: a + k·b rounded ONCE, an FMA (its AddFunctor,
//   built with nvcc's default contraction).  Found on an H100 with PyTorch
//   2.11: on 65,536 inputs whose a + k·b is exact in float64, add_ gave that
//   sum rounded once to float32, and rounding k·b first gave other bits
//   (tests/test_torch_poly_expansion_level_cuda.py::
//   test_torch_add_alpha_rounds_once).  The zero centre tap of x·g is added
//   too: fma(0, x, s) turns −0 into +0 as PyTorch does.
// - The planes: b2·ig11, b3·ig11, b1·ig03 + b5·ig33, b1·ig03 + b4·ig33,
//   b6·ig55, each product and the sum rounded once.
// Built with --fmad=false, so nothing but the explicit __fmaf_rn contracts.
//
// Bound: it reads the image once (4 bytes a pixel) and writes five float32
// planes (20 bytes): 24 bytes a pixel.  It does 189 multiply-adds a pixel at
// n = 10 (3 vertical and 6 horizontal sums of 21 taps) and 7 operations for
// the planes.  At autodriving's pyramid (801², 481², 288², 173²: 1.97 M
// pixels a pair) that is 47 MB, 14 µs at 3.35 TB/s, and 0.75 GFLOP, 11 µs at
// 67 TFLOP/s: bytes bound it, with the arithmetic close behind.  So the
// design spends few shared-memory loads and instructions beyond the FMAs.
//
// Design.  One launch covers a level's two images (grid z: the image and its
// sample; each image has its own pad).  A block of 256 threads owns a canvas
// tile of 16 rows × 128 columns; its distinct source rows and columns (fewer
// in the pad bands, where canvas pixels repeat the edge) are computed once:
//  1. the tile's clamped source slab, (rows + 2n) × (cols + 2n) floats, is
//     copied to shared memory with 4-byte cp.async copies, a warp a row; the
//     clamps are the edge extension;
//  2. the vertical sums s0, s1, s2 of the tile's source rows across the
//     haloed columns go to shared memory; a thread takes one column and 4
//     rows and keeps the 4 + 2n slab values it reads in registers;
//  3. a warp takes a source row, a lane 4 adjacent source columns: it loads
//     the 4 + 2n values of each of s0, s1, s2 it reads as float4s into
//     registers once, forms the six horizontal sums and the five planes,
//     and puts them in a stage of its own in shared memory (over the slab);
//     then the warp writes every canvas row that repeats this source row,
//     32 consecutive columns a store, each column reading the stage at its
//     clamped source column.  Canvas rows have any width (W + 2p), so the
//     stores are coalesced scalars, not float4s.
// n = 10 (the autodriving and uav presets) is a template instance: taps
// unrolled, coefficients as kernel parameters.  Every other n takes the same
// kernel with runtime tap loops (one column and one row a thread in step 2,
// one pixel's taps read from shared memory in step 3) and the coefficients
// from device memory.  n ≤ kMaxN: the slab and the sums of one tile must fit
// a block's shared memory (192 KB at n = 64).
//
// The kernel allocates nothing: the wrapper allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 16;    // canvas rows of a tile
constexpr int kTC = 128;   // canvas columns of a tile: 32 lanes × 4
constexpr int kR = 4;      // rows of vertical sums a thread takes (template instances)
constexpr int kMaxN = 64;

struct Level {
  const float* img[2];
  float* out[2];
  int pad[2];
  int b, h, w, n;
};

// g, x·g, x²·g of the template instances, as kernel parameters
template <int N>
struct Taps {
  float g[2 * N + 1], xg[2 * N + 1], xxg[2 * N + 1];
};
template <>
struct Taps<0> {
  float unused;
};

struct Scales {
  float ig11, ig03, ig33, ig55;
};

// floats of a slab or sum row: 128 + 2n rounded up to a float4
__host__ __device__ constexpr int row_stride(int n) { return (kTC + 2 * n + 3) & ~3; }

// the slab's region (the warps' stages reuse it once the vertical sums are
// done), then s0, s1 and s2, in floats
__host__ __device__ constexpr int slab_floats(int n) {
  return (kTR + 2 * n) * row_stride(n) > kWarps * 5 * kTC ? (kTR + 2 * n) * row_stride(n)
                                                          : kWarps * 5 * kTC;
}
__host__ __device__ constexpr int smem_floats(int n) {
  return slab_floats(n) + 3 * kTR * row_stride(n);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// one tap of a PyTorch tap sum, acc.add_(x, alpha=k): rounded once
__device__ __forceinline__ float tap(float acc, float k, float x) { return __fmaf_rn(k, x, acc); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The 4 + 2N values of a sum row that 4 adjacent pixels read, as float4s.
template <int N>
struct Window {
  static constexpr int kVec = (4 + 2 * N + 3) / 4;
  float v[4 * kVec];
  __device__ __forceinline__ void load(const float* s) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const float4 f = reinterpret_cast<const float4*>(s)[u];
      v[4 * u] = f.x;
      v[4 * u + 1] = f.y;
      v[4 * u + 2] = f.z;
      v[4 * u + 3] = f.w;
    }
  }
  // Σ_t k[t]·v[q + t] in tap order
  __device__ __forceinline__ float sum(const float (&k)[2 * N + 1], int q) const {
    float a = k[0] * v[q];
#pragma unroll
    for (int t = 1; t <= 2 * N; ++t) a = tap(a, k[t], v[q + t]);
    return a;
  }
};

__device__ __forceinline__ void put4(float* st, int pl, const float (&v)[4]) {
  *reinterpret_cast<float4*>(st + pl * kTC) = make_float4(v[0], v[1], v[2], v[3]);
}

// The five planes of 4 adjacent pixels of a source row, from their sum rows
// s0, s1, s2 (at the first pixel's column), into the stage st (at the same
// column), plane pl at st + pl·kTC.
template <int N>
__device__ __forceinline__ void planes(const float* s0, const float* s1, const float* s2,
                                       const Taps<N>& tp, const float* __restrict__ coef,
                                       int n, const Scales& sc, float* st) {
  if constexpr (N > 0) {
    Window<N> win;
    float o[4];
    float b1[4], b4[4];
    win.load(s0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b1[q] = win.sum(tp.g, q);
      o[q] = win.sum(tp.xg, q) * sc.ig11;
      b4[q] = win.sum(tp.xxg, q);
    }
    put4(st, 1, o);
    win.load(s1);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = win.sum(tp.g, q) * sc.ig11;
    put4(st, 0, o);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = win.sum(tp.xg, q) * sc.ig55;
    put4(st, 4, o);
    win.load(s2);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = b1[q] * sc.ig03 + win.sum(tp.g, q) * sc.ig33;
    put4(st, 2, o);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = b1[q] * sc.ig03 + b4[q] * sc.ig33;
    put4(st, 3, o);
  } else {
    const int taps = 2 * n + 1;
    const float* g = coef;
    const float* xg = coef + taps;
    const float* xxg = coef + 2 * taps;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* p0 = s0 + q;
      const float* p1 = s1 + q;
      const float* p2 = s2 + q;
      float b1 = g[0] * p0[0], b2 = g[0] * p1[0], b3 = xg[0] * p0[0];
      float b4 = xxg[0] * p0[0], b5 = g[0] * p2[0], b6 = xg[0] * p1[0];
      for (int t = 1; t < taps; ++t) {
        const float gt = g[t], xgt = xg[t];
        b1 = tap(b1, gt, p0[t]);
        b2 = tap(b2, gt, p1[t]);
        b3 = tap(b3, xgt, p0[t]);
        b4 = tap(b4, xxg[t], p0[t]);
        b5 = tap(b5, gt, p2[t]);
        b6 = tap(b6, xgt, p1[t]);
      }
      st[q] = b2 * sc.ig11;
      st[kTC + q] = b3 * sc.ig11;
      st[2 * kTC + q] = b1 * sc.ig03 + b5 * sc.ig33;
      st[3 * kTC + q] = b1 * sc.ig03 + b4 * sc.ig33;
      st[4 * kTC + q] = b6 * sc.ig55;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) poly_expansion_level_kernel(
    const Level lv, const Taps<N> tp, const float* __restrict__ coef, const Scales sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = N > 0 ? N : lv.n;
  const int sw = row_stride(n);
  // the image: 0 (r0) or 1 (r1p); selected, not indexed, so that the
  // parameters stay out of local memory
  const bool k = (int)blockIdx.z >= lv.b;
  const int bi = blockIdx.z - (k ? lv.b : 0);
  const int p = k ? lv.pad[1] : lv.pad[0];
  const int h = lv.h, w = lv.w;
  const int ho = h + 2 * p, wo = w + 2 * p;
  const int Y0 = blockIdx.y * kTR, X0 = blockIdx.x * kTC;
  if (Y0 >= ho || X0 >= wo) return;  // the other image's canvas is larger
  const int Y1 = min(Y0 + kTR, ho), X1 = min(X0 + kTC, wo);
  // the tile's source rows ya … ya + rows − 1 and columns xa … xa + cols − 1
  const int ya = clampi(Y0 - p, 0, h - 1), xa = clampi(X0 - p, 0, w - 1);
  const int rows = clampi(Y1 - 1 - p, 0, h - 1) - ya + 1;
  const int cols = clampi(X1 - 1 - p, 0, w - 1) - xa + 1;
  const int srows = kR * ((rows + kR - 1) / kR) + 2 * n;  // slab rows the sums read
  const int scols = 4 * ((cols + 3) / 4) + 2 * n;         // slab and sum columns
  float* slab = smem;  // slab row r, column c: image pixel (ya − n + r, xa − n + c), clamped
  float* s0 = smem + slab_floats(n);
  float* s1 = s0 + kTR * sw;
  float* s2 = s1 + kTR * sw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. the slab
  const float* src = (k ? lv.img[1] : lv.img[0]) + (long long)bi * h * w;
  for (int r = warp; r < srows; r += kWarps) {
    const float* row = src + (long long)clampi(ya - n + r, 0, h - 1) * w;
    for (int c = lane; c < scols; c += 32)
      cp_async4(slab + r * sw + c, row + clampi(xa - n + c, 0, w - 1));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. the vertical sums: s[r][c] = Σ_t k[t]·slab[r + t][c]
  if constexpr (N > 0) {
    const int groups = (rows + kR - 1) / kR;
    for (int i = threadIdx.x; i < groups * scols; i += kThreads) {
      const int r0 = kR * (i / scols), c = i % scols;
      float x[kR + 2 * N];
#pragma unroll
      for (int t = 0; t < kR + 2 * N; ++t) x[t] = slab[(r0 + t) * sw + c];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        float a0 = tp.g[0] * x[q], a1 = tp.xg[0] * x[q], a2 = tp.xxg[0] * x[q];
#pragma unroll
        for (int t = 1; t <= 2 * N; ++t) {
          a0 = tap(a0, tp.g[t], x[q + t]);
          a1 = tap(a1, tp.xg[t], x[q + t]);
          a2 = tap(a2, tp.xxg[t], x[q + t]);
        }
        const int o = (r0 + q) * sw + c;
        s0[o] = a0;
        s1[o] = a1;
        s2[o] = a2;
      }
    }
  } else {
    const int taps = 2 * n + 1;
    for (int i = threadIdx.x; i < rows * scols; i += kThreads) {
      const int r = i / scols, c = i % scols;
      const float* col = slab + r * sw + c;
      float a0 = coef[0] * col[0], a1 = coef[taps] * col[0], a2 = coef[2 * taps] * col[0];
      for (int t = 1; t < taps; ++t) {
        const float x = col[t * sw];
        a0 = tap(a0, coef[t], x);
        a1 = tap(a1, coef[taps + t], x);
        a2 = tap(a2, coef[2 * taps + t], x);
      }
      s0[r * sw + c] = a0;
      s1[r * sw + c] = a1;
      s2[r * sw + c] = a2;
    }
  }
  __syncthreads();

  // 3. the horizontal sums and the planes, a warp a source row
  float* stage = smem + warp * 5 * kTC;  // [5][kTC], over the slab
  const long long plane = (long long)ho * wo;
  float* dst = (k ? lv.out[1] : lv.out[0]) + (long long)bi * 5 * plane;
  const int j0 = 4 * lane;
  for (int r = warp; r < rows; r += kWarps) {
    if (j0 < cols)
      planes<N>(s0 + r * sw + j0, s1 + r * sw + j0, s2 + r * sw + j0, tp, coef, n, sc,
                stage + j0);
    __syncwarp();
    // the canvas rows whose clamped source row is ya + r
    const int ys = ya + r;
    const int ylo = max(ys == 0 ? 0 : ys + p, Y0);
    const int yhi = min(ys == h - 1 ? ho - 1 : ys + p, Y1 - 1);
    for (int Y = ylo; Y <= yhi; ++Y) {
      float* drow = dst + (long long)Y * wo;
      for (int X = X0 + lane; X < X1; X += 32) {
        const int j = clampi(X - p, 0, w - 1) - xa;
#pragma unroll
        for (int pl = 0; pl < 5; ++pl) drow[pl * plane + X] = stage[pl * kTC + j];
      }
    }
    __syncwarp();
  }
}

template <int N>
int launch(const Level& lv, const float* coef, const float* ch, dim3 grid, cudaStream_t st) {
  const int taps = 2 * lv.n + 1;
  Taps<N> tp = {};
  if constexpr (N > 0) {
    for (int t = 0; t < taps; ++t) {
      tp.g[t] = ch[t];
      tp.xg[t] = ch[taps + t];
      tp.xxg[t] = ch[2 * taps + t];
    }
  }
  const float* igs = ch + 3 * taps;
  const Scales sc = {igs[0], igs[1], igs[2], igs[3]};
  const int bytes = (int)sizeof(float) * smem_floats(lv.n);
  cudaError_t err = cudaFuncSetAttribute(poly_expansion_level_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  poly_expansion_level_kernel<N><<<grid, kThreads, bytes, st>>>(lv, tp, coef, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// img0 → out0 with pad0 and, when n_img is 2, img1 → out1 with pad1, in one
// launch: each [b, h, w] float32, each out [b, 5, h + 2·pad, w + 2·pad].
// coef / coef_host: the same coefficients on the device and on the host,
// g[2n+1], xg[2n+1], xxg[2n+1], ig11, ig03, ig33, ig55; the n = 10 instance
// takes its taps from the host copy as kernel parameters.
extern "C" int nsof_poly_expansion_level(
    const void* img0, const void* img1, const void* coef, const void* coef_host, void* out0,
    void* out1, int b, int h, int w, int n, int n_img, int pad0, int pad1, void* stream) {
  if (b == 0) return 0;
  if (h < 1 || w < 1 || n < 1 || n > kMaxN || n_img < 1 || n_img > 2 || pad0 < 0 ||
      (n_img == 2 && pad1 < 0) || (long long)n_img * b > 65535)
    return (int)cudaErrorInvalidValue;
  Level lv = {{(const float*)img0, (const float*)img1},
              {(float*)out0, (float*)out1},
              {pad0, n_img == 2 ? pad1 : pad0},
              b, h, w, n};
  const int pmax = max(lv.pad[0], lv.pad[1]);
  const dim3 grid((w + 2 * pmax + kTC - 1) / kTC, (h + 2 * pmax + kTR - 1) / kTR, n_img * b);
  const float* c = (const float*)coef;
  const float* ch = (const float*)coef_host;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 10) return launch<10>(lv, c, ch, grid, st);
  return launch<0>(lv, c, ch, grid, st);
}
