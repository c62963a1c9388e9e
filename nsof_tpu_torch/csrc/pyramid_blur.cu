// K12: the Farnebäck pyramid's reflect-101 pad and separable blur, for both
// images of a level in one launch, bit for bit its plain PyTorch version
// (ops/farneback_fast.py::_pyramid_blur_plain: ops/farneback.py::_blur_valid
// of ops/farneback.py::_reflect_pad of each image).
//
// Replaces no TPU kernel: the JAX package blurs its pyramid levels with XLA
// depthwise convolutions (nsof_tpu/ops/farneback_fast.py:1119), not with a
// Pallas kernel.  The port's plain version is F.pad(mode="reflect"), then a
// separate multiply and a separate add a tap and a pass: 4·t − 1 launches
// an image and a level, each reading and writing a whole plane.
//
// What it computes.  For a [B, H, W] float32 image x and t = 2n + 1 taps k,
// n < H and n < W (the condition F.pad(mode="reflect") imposes), the [B, H, W]
// plane
//   v[y][c]   = Σ_s k[s]·x[r(y − n + s)][r(c − n)],   c = 0 … W + 2n − 1
//   out[y][x] = Σ_s k[s]·v[y][x + s]
// with r the reflect-101 index (OpenCV's BORDER_DEFAULT): −i below 0,
// 2(N − 1) − i past N − 1.  The vertical pass runs first, over the padded
// columns, as the plain version does.
//
// Rounding: as PyTorch rounds each step on the card.  A sum starts with the
// lone product k[0]·x[0] (float(k) * slice, one rounding) and adds each later
// tap as v + term, the product rounded, then the sum (__fadd_rn of
// __fmul_rn), in tap order.  Built with --fmad=false besides, so nothing
// contracts.  The padded column c of the vertical pass is the vertical sum
// at source column r(c − n), the same operations on the same values, so the
// kernel sums each source column a tile reads once and indexes it.
//
// Bound: bytes.  It reads each source pixel once and writes each output
// pixel once, 8 bytes a pixel; its 4·t operations a pixel (36 at the
// presets' widest, t = 9) are far under the card's float32 rate.
// Autodriving's pyramid (both 801² originals blurred at four levels,
// B = 128) moves 5.26 GB a call, 1.57 ms at 3.35 TB/s; grasp's (1920×1080
// with 3 taps, 960×540 and 480×270 with 7) 5.57 GB, 1.66 ms.
//
// Design, to touch each byte once and keep every other access on chip.  A
// block of 256 threads owns a tile of 32 output rows and up to 128 output
// columns of one image of the pair (grid z: the image and its sample):
//  1. the vertical sums: thread (j, g) takes the tile's haloed column j
//     (source column r(X0 − n + j)) and 16 of its rows; it loads the
//     16 + 2n source values that they read straight into registers, a
//     coalesced 4-byte load a row across the warp, and writes its 16 sums
//     to the tile's [32][128] sums in shared memory;
//  2. the horizontal sums: thread (j, g) takes output column X0 + j and the
//     same 16 rows, reads the t sums it needs from shared memory (adjacent
//     threads adjacent words: no bank conflict) and keeps its 16 outputs in
//     registers;
//  3. each output row is written once, 32 consecutive floats a warp store.
// The taps of the presets (t = 3, 5, 7, 9) are template instances: taps
// unrolled and passed as kernel parameters, 128 − 2n output columns a tile so
// that the haloed columns are exactly 128, one a thread.  Any other odd t
// takes the generic instance: taps from device memory, 128 output columns a
// tile, and the 128 + 2n haloed columns in chunks of 128, steps 1–2 once a
// chunk; a thread adds the taps whose column falls in the chunk, so each sum
// still runs in tap order, and n may be as large as the image allows.
// Rows and columns past a ragged tile's edge read clamped indices and are
// not written.  Tiles beyond the grid's y and z limits are taken in strides.
//
// The kernel allocates nothing: the wrapper allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;                        // haloed columns of a tile
constexpr int kRows = 32;                         // output rows of a tile
constexpr int kHalf = kRows * kCols / kThreads;   // rows a thread sums: 16
constexpr int kMaxGridYZ = 65535;

struct Pair {
  const float* src[2];
  float* dst[2];
  int b, h, w, t;
};

// the taps of the template instances, as kernel parameters
template <int T>
struct Taps {
  float k[T];
};
template <>
struct Taps<0> {
  float unused;
};

// reflect-101 index of i into [0, n); clamped past that (the rows and
// columns beyond a ragged tile's edge, which no output reads)
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// one later tap of a plain tap sum: acc + k·x, the product rounded, then
// the sum
__device__ __forceinline__ float tap(float acc, float k, float x) {
  return __fadd_rn(acc, __fmul_rn(k, x));
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    pyramid_blur_kernel(const Pair p, const Taps<T> tp, const float* __restrict__ taps) {
  __shared__ float sums[kRows * kCols];
  const int t = T > 0 ? T : p.t;
  const int n = t / 2;
  const int tco = T > 0 ? kCols - 2 * (T / 2) : kCols;  // output columns of a tile
  const int chunks = T > 0 ? 1 : (kCols + 2 * n + kCols - 1) / kCols;
  const int h = p.h, w = p.w;
  const int tiles_y = (h + kRows - 1) / kRows;
  const int X0 = blockIdx.x * tco;
  const int j = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const bool writes = j < tco && X0 + j < w;
  const long long plane = (long long)h * w;
  for (int z = blockIdx.z; z < 2 * p.b; z += gridDim.z) {
    // the image (selected, not indexed, so that the parameters stay out of
    // local memory) and its sample
    const bool second = z >= p.b;
    const long long off = (long long)(z - (second ? p.b : 0)) * plane;
    const float* src = (second ? p.src[1] : p.src[0]) + off;
    float* dst = (second ? p.dst[1] : p.dst[0]) + off;
    for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
      const int y0 = ty * kRows + g * kHalf;  // this thread's first row
      float acc[kHalf] = {};
      for (int c = 0; c < chunks; ++c) {
        // 1. the vertical sums of haloed column c·128 + j, rows y0 … y0 + 15
        const float* col = src + reflect(X0 - n + c * kCols + j, w);
        float* mine = sums + g * kHalf * kCols + j;
        if constexpr (T > 0) {
          float x[kHalf + T - 1];
#pragma unroll
          for (int i = 0; i < kHalf + T - 1; ++i)
            x[i] = __ldg(col + (long long)reflect(y0 - n + i, h) * w);
#pragma unroll
          for (int q = 0; q < kHalf; ++q) {
            float a = __fmul_rn(tp.k[0], x[q]);
#pragma unroll
            for (int s = 1; s < T; ++s) a = tap(a, tp.k[s], x[q + s]);
            mine[q * kCols] = a;
          }
        } else {
          // source row i feeds tap s = i − q of row q
          float v[kHalf];
          for (int i = 0; i < kHalf + t - 1; ++i) {
            const float x = __ldg(col + (long long)reflect(y0 - n + i, h) * w);
#pragma unroll
            for (int q = 0; q < kHalf; ++q) {
              const int s = i - q;
              if (s == 0)
                v[q] = __fmul_rn(__ldg(taps), x);
              else if (s > 0 && s < t)
                v[q] = tap(v[q], __ldg(taps + s), x);
            }
          }
#pragma unroll
          for (int q = 0; q < kHalf; ++q) mine[q * kCols] = v[q];
        }
        __syncthreads();
        // 2. the horizontal sums of output column X0 + j: the taps s whose
        // haloed column j + s lies in this chunk
        if (writes) {
          if constexpr (T > 0) {
#pragma unroll
            for (int q = 0; q < kHalf; ++q) {
              const float* row = sums + (g * kHalf + q) * kCols + j;
              float a = __fmul_rn(tp.k[0], row[0]);
#pragma unroll
              for (int s = 1; s < T; ++s) a = tap(a, tp.k[s], row[s]);
              acc[q] = a;
            }
          } else {
            const int lo = max(0, c * kCols - j), hi = min(t - 1, (c + 1) * kCols - 1 - j);
#pragma unroll
            for (int q = 0; q < kHalf; ++q) {
              const float* row = sums + (g * kHalf + q) * kCols + j - c * kCols;
              float a = acc[q];
              for (int s = lo; s <= hi; ++s)
                a = s == 0 ? __fmul_rn(__ldg(taps), row[0]) : tap(a, __ldg(taps + s), row[s]);
              acc[q] = a;
            }
          }
        }
        __syncthreads();
      }
      // 3. the outputs, a row at a time
      if (writes) {
#pragma unroll
        for (int q = 0; q < kHalf; ++q)
          if (y0 + q < h) dst[(long long)(y0 + q) * w + X0 + j] = acc[q];
      }
    }
  }
}

template <int T>
int launch(const Pair& p, const float* taps, const float* taps_host, cudaStream_t st) {
  Taps<T> tp = {};
  if constexpr (T > 0) {
    for (int s = 0; s < T; ++s) tp.k[s] = taps_host[s];
  }
  const int tco = T > 0 ? kCols - 2 * (T / 2) : kCols;
  const dim3 grid((p.w + tco - 1) / tco, min((p.h + kRows - 1) / kRows, kMaxGridYZ),
                  min(2 * p.b, kMaxGridYZ));
  pyramid_blur_kernel<T><<<grid, kThreads, 0, st>>>(p, tp, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// img0 → out0 and img1 → out1, each [b, h, w] float32, in one launch.
// taps / taps_host: the same t float32 taps on the device and on the host;
// t odd, t / 2 < h and t / 2 < w.  The t = 3, 5, 7, 9 instances take their
// taps from the host copy as kernel parameters.
extern "C" int nsof_pyramid_blur(const void* img0, const void* img1, const void* taps,
                                 const void* taps_host, void* out0, void* out1, int b,
                                 int h, int w, int t, void* stream) {
  if (b < 0 || h < 1 || w < 1 || t < 1 || t % 2 == 0 || t / 2 >= h || t / 2 >= w ||
      b >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const Pair p = {{(const float*)img0, (const float*)img1}, {(float*)out0, (float*)out1},
                  b, h, w, t};
  const float* k = (const float*)taps;
  const float* kh = (const float*)taps_host;
  cudaStream_t st = (cudaStream_t)stream;
  switch (t) {
    case 3: return launch<3>(p, k, kh, st);
    case 5: return launch<5>(p, k, kh, st);
    case 7: return launch<7>(p, k, kh, st);
    case 9: return launch<9>(p, k, kh, st);
    default: return launch<0>(p, k, kh, st);
  }
}
