// K6: box-smooth the Farnebäck system and solve it for the flow.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_box_solve_kernel (driver
// box_solve_pallas, the solve of the pallas and pallas_sep routes): sum
// each channel of the float32 system M over the (2m+1)² window with edge
// replication, scale by 1/winsize², and solve the 2×2 system (+1e-3 on the
// determinant) for the float32 flow, dx and dy in two planes.  The window
// sum is the TPU kernel's: each column of the window summed vertically in
// log-tree order, then those column sums combined horizontally in the same
// order.  That order depends on the window alone, not on the tile, so it is
// reproduced exactly; unlike the TPU driver there is no m ≤ 8 limit.
//
// Bound: per pixel it must read M (20 bytes) and write the flow (8): ~28
// bytes, ~2.3 GB for B = 128 at 801×801.  The work is ~5·(2 log-tree
// passes + scale) + 11 ≈ 30 flops a pixel at winsize 3 with every
// intermediate computed once, far below the float32 ridge, so the bytes
// bound it.  Design: one thread per output pixel; it sums its own
// (2m+1)² window (the windows of neighbouring threads overlap and come from
// L1), reading M through clamped indices in place of the edge pad.  For
// m ≤ 8 (the TPU kernel's range, every bundled preset) the window width is
// a template parameter, the clamped offsets are computed once and the trees
// unroll into registers; wider windows take a generic loop that keeps its
// partial sums on a stack.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

// The pairwise sum ((v0 + v1) + (v2 + v3)) … of v(pos .. pos + LEN - 1).
template <int LEN>
struct Pairwise {
  template <typename V>
  __device__ __forceinline__ static float sum(V v, int pos) {
    return Pairwise<LEN / 2>::sum(v, pos) +
           Pairwise<LEN / 2>::sum(v, pos + LEN / 2);
  }
};
template <>
struct Pairwise<1> {
  template <typename V>
  __device__ __forceinline__ static float sum(V v, int pos) {
    return v(pos);
  }
};

// Σ v(0 .. WIN-1) in the log-tree order of the TPU kernel's win_sum: the
// chunks of 2^k values for the set bits k of WIN, highest first, each
// summed pairwise, added left to right.  KBIT walks the bits down.
template <int WIN, int KBIT = 4>
struct Tree {
  template <typename V>
  __device__ __forceinline__ static float sum(V v, int pos = 0,
                                              float out = 0.0f,
                                              bool first = true) {
    constexpr int len = 1 << KBIT;
    if constexpr ((WIN & len) != 0) {
      const float part = Pairwise<len>::sum(v, pos);
      out = first ? part : out + part;
      first = false;
      pos += len;
    }
    if constexpr (KBIT == 0) {
      return out;
    } else {
      return Tree<WIN, KBIT - 1>::sum(v, pos, out, first);
    }
  }
};

// The same order for any window width: each chunk's pairwise sum runs as a
// binary counter over a stack of partial sums.
template <typename V>
__device__ __forceinline__ float tree_sum_any(V v, int win) {
  float out = 0.0f;
  bool first = true;
  int pos = 0;
  for (int kbit = 30; kbit >= 0; --kbit) {
    const int len = 1 << kbit;
    if (!(win & len)) continue;
    float stk[32];
    int top = 0;
    for (int i = 0; i < len; ++i) {
      float s = v(pos + i);
      for (int j = i + 1; !(j & 1); j >>= 1) s = stk[--top] + s;
      stk[top++] = s;
    }
    out = first ? stk[0] : out + stk[0];
    first = false;
    pos += len;
  }
  return out;
}

// The flow from the box sums g of the five channels (already scaled).
__device__ __forceinline__ void solve_store(const float* g, float* out_dx,
                                            float* out_dy, long long pix) {
  const float g11 = g[0], g12 = g[1], g22 = g[2], h1 = g[3], h2 = g[4];
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  out_dx[pix] = (g11 * h2 - g12 * h1) * idet;
  out_dy[pix] = (g22 * h1 - g12 * h2) * idet;
}

// Window width WIN = 2m + 1 known at compile time: the clamped row and
// column offsets are computed once, and each channel's two trees unroll.
// The five channels unroll too where the window is narrow; wider windows
// keep one channel's code, which keeps the build short.
template <int WIN>
__global__ void box_solve_fixed_kernel(const float* __restrict__ m,
                                       float* __restrict__ out_dx,
                                       float* __restrict__ out_dy, int h,
                                       int w, int winsize) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  constexpr int mm = WIN / 2;
  const float scale = (float)(1.0 / ((double)winsize * winsize));
  const long long plane = (long long)h * w;
  int rows[WIN], cols[WIN];
#pragma unroll
  for (int i = 0; i < WIN; ++i) {
    rows[i] = min(max(y - mm + i, 0), h - 1) * w;
    cols[i] = min(max(x - mm + i, 0), w - 1);
  }
  constexpr int kUnrollChannels = WIN <= 5 ? 5 : 1;
  float g[5];
#pragma unroll kUnrollChannels
  for (int c = 0; c < 5; ++c) {
    const float* mc = m + ((long long)b * 5 + c) * plane;
    float colsum[WIN];
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      const float* col = mc + cols[j];
      colsum[j] = Tree<WIN>::sum([&](int i) { return __ldg(col + rows[i]); });
    }
    g[c] = Tree<WIN>::sum([&](int j) { return colsum[j]; }) * scale;
  }
  solve_store(g, out_dx, out_dy, b * plane + (long long)y * w + x);
}

// Any window width, the partial sums on a stack.
__global__ void box_solve_any_kernel(const float* __restrict__ m,
                                     float* __restrict__ out_dx,
                                     float* __restrict__ out_dy, int h, int w,
                                     int winsize) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const int mm = winsize / 2;
  const int win = 2 * mm + 1;
  const float scale = (float)(1.0 / ((double)winsize * winsize));
  const long long plane = (long long)h * w;
  float g[5];
  for (int c = 0; c < 5; ++c) {
    const float* mc = m + ((long long)b * 5 + c) * plane;
    auto column = [&](int j) {
      const float* col = mc + min(max(x - mm + j, 0), w - 1);
      return tree_sum_any(
          [&](int i) {
            return __ldg(col + (long long)min(max(y - mm + i, 0), h - 1) * w);
          },
          win);
    };
    g[c] = tree_sum_any(column, win) * scale;
  }
  solve_store(g, out_dx, out_dy, b * plane + (long long)y * w + x);
}

template <int WIN>
int launch(const void* m, void* out_dx, void* out_dy, int b, int h, int w,
           int winsize, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((w + 31) / 32, (h + 7) / 8, b);
  if constexpr (WIN > 0) {
    box_solve_fixed_kernel<WIN><<<grid, block, 0, stream>>>(
        (const float*)m, (float*)out_dx, (float*)out_dy, h, w, winsize);
  } else {
    box_solve_any_kernel<<<grid, block, 0, stream>>>(
        (const float*)m, (float*)out_dx, (float*)out_dy, h, w, winsize);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsof_box_solve(const void* m, void* out_dx, void* out_dy,
                              int b, int h, int w, int winsize,
                              void* stream) {
  if (b == 0) return 0;
  if (winsize < 1 || (long long)h * w > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (2 * (winsize / 2) + 1) {
    case 1: return launch<1>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 3: return launch<3>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 5: return launch<5>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 7: return launch<7>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 9: return launch<9>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 11: return launch<11>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 13: return launch<13>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 15: return launch<15>(m, out_dx, out_dy, b, h, w, winsize, st);
    case 17: return launch<17>(m, out_dx, out_dy, b, h, w, winsize, st);
    default: return launch<0>(m, out_dx, out_dy, b, h, w, winsize, st);
  }
}
