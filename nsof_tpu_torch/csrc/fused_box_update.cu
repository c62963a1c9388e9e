// K4: one Farnebäck iteration, fused: box sum → 2×2 solve → warp → M'.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_fused_box_update_kernel
// (called through _fused_box_update_cm): box-sum the system M (bfloat16,
// or float32 for kernel_mode='fused_f32') over (2m+1)² in float32, solve
// the 2×2 system (+1e-3 on the determinant) on the tile's rows and, for
// emit = matrices, on its ±(r+1) halo rows too; then warp r1 by that flow
// and write M' in M's type (emit = matrices) or write the float32 flow
// (emit = flow).  The intermediate flow never leaves shared memory.
//
// Bound: per canvas pixel it must read M (10 bytes in bf16), r0 (20), r1
// (20 and its margin) and write M' (10): ~64 bytes (~84 with f32 M).  With every intermediate
// computed once (warp pass 1 once per row) the work is ~330 flops a pixel,
// below the float32 ridge, so the bytes bound it.  This first version does
// ~1,000 flops a pixel: it recomputes pass 1 for each output row.
// Design: one block per (sample, 32×32 tile).  The tile's rows are the
// canvas's 32-row blocks, because the vertical window sum is the TPU
// kernel's running recurrence S(r) = (S(r-1) + M(r+2m)) - M(r-1), started
// afresh at each block's first row, and the rounding of those sums is part
// of the function.  Each thread walks one column of one channel down the
// block with that recurrence (M read through clamped indices: the edge
// padding of M needs no copy), the column sums go to shared memory, the
// row sums follow in the TPU kernel's log-tree order, and the solved flow
// of the 32 + 2(r+1) rows stays in shared memory for the warp.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

constexpr int kBlk = 32;  // canvas row block (the TPU kernel's row tile)
constexpr int kTX = 32;
constexpr int kThreads = 256;
constexpr int kMaxTreeBit = 5;  // window sums up to 63 wide

// Σ v[0 .. win-1] in the log-tree order of the TPU kernel's _win_sum_tree
__device__ float tree_sum(const float* v, int win) {
  float out = 0.0f;
  bool first = true;
  int pos = 0;
  for (int kbit = kMaxTreeBit; kbit >= 0; --kbit) {
    const int len = 1 << kbit;
    if (!(win & len)) continue;
    float a[1 << kMaxTreeBit];
    for (int i = 0; i < len; ++i) a[i] = v[pos + i];
    for (int s = 1; s < len; s *= 2)
      for (int i = 0; i < len; i += 2 * s) a[i] = a[i] + a[i + s];
    out = first ? a[0] : out + a[0];
    first = false;
    pos += len;
  }
  return out;
}

template <typename MT>
__global__ void fused_box_update_kernel(
    const MT* __restrict__ m, const float* __restrict__ r0,
    const float* __restrict__ r1, const float* __restrict__ bsc,
    void* __restrict__ out, int hk, int wk, int hp, int wp, int mr, int mc,
    int winsize, int radius, int emit_flow) {
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * kBlk;
  const int X0 = blockIdx.x * kTX;
  const int mm = winsize / 2;
  const int win = 2 * mm + 1;
  const int e = radius + 1;
  const int ext = emit_flow ? 0 : e;
  const int rows = kBlk + 2 * ext;  // flow rows of this block
  const int vc = kTX + 2 * mm;      // column-sum columns
  const float scale = (float)(1.0 / ((double)winsize * winsize));
  const float rad = (float)radius;
  const long long plane = (long long)hp * wp;

  float* vsum = smem;                    // 5 × rows × vc
  float* fdx = vsum + 5 * rows * vc;     // rows × kTX (clamped dx)
  float* fdy = fdx + rows * kTX;         // kBlk × kTX (clamped dy)

  // column sums: slab row 0 is canvas row Y0 - ext - mm, col 0 is X0 - mm
  const MT* mb = m + (long long)b * 5 * plane;
  for (int t = threadIdx.x; t < 5 * vc; t += kThreads) {
    const int c = t / vc, j = t % vc;
    const int x = min(max(X0 - mm + j, 0), wp - 1);
    const MT* col = mb + c * plane + x;
    auto at = [&](int r) {
      const int y = min(max(Y0 - ext - mm + r, 0), hp - 1);
      return nsof::load(col + (long long)y * wp);
    };
    float s = at(0);
    for (int u = 1; u < win; ++u) s = s + at(u);
    float* dst = vsum + c * rows * vc + j;
    dst[0] = s;
    for (int r = 1; r < rows; ++r) {
      s = s + at(r + win - 1) - at(r - 1);
      dst[r * vc] = s;
    }
  }
  __syncthreads();

  // row sums and the 2×2 solve on every flow row
  for (int i = threadIdx.x; i < rows * kTX; i += kThreads) {
    const int ri = i / kTX, xi = i % kTX;
    float gsum[5];
#pragma unroll
    for (int c = 0; c < 5; ++c)
      gsum[c] = tree_sum(vsum + (c * rows + ri) * vc + xi, win) * scale;
    const float g11 = gsum[0], g12 = gsum[1], g22 = gsum[2];
    const float h1 = gsum[3], h2 = gsum[4];
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const float dx = (g11 * h2 - g12 * h1) * idet;
    const float dy = (g22 * h1 - g12 * h2) * idet;
    if (emit_flow) {
      const int y = Y0 + ri, x = X0 + xi;
      if (y < hp && x < wp) {
        float* fo = (float*)out + (long long)b * 2 * plane;
        const long long pix = (long long)y * wp + x;
        fo[pix] = dx;
        fo[plane + pix] = dy;
      }
    } else {
      fdx[i] = nsof::clampf(dx, rad);
      if (ri >= e && ri < e + kBlk) fdy[(ri - e) * kTX + xi] = nsof::clampf(dy, rad);
    }
  }
  if (emit_flow) return;
  __syncthreads();

  // separable warp of r1 by the block's flow and the rebuild of M'
  const int h1p = hp + 2 * mr;
  const int w1p = wp + 2 * mc;
  for (int i = threadIdx.x; i < kBlk * kTX; i += kThreads) {
    const int j = i / kTX, xi = i % kTX;
    const int y = Y0 + j, x = X0 + xi;
    if (y >= hp || x >= wp) continue;
    auto dx_row = [&](int ky) { return fdx[(j + e + ky) * kTX + xi]; };
    const float sc = bsc[(long long)min(y, hk - 1) * wk + min(x, wk - 1)];
    nsof::warp_build_store(
        dx_row, fdx[(j + e) * kTX + xi], fdy[j * kTX + xi],
        r1 + (long long)b * 5 * h1p * w1p, h1p, w1p, mr, mc,
        r0 + (long long)b * 5 * plane, plane, (long long)y * wp + x, sc, y, x,
        radius, (MT*)out + (long long)b * 5 * plane);
  }
}

template <typename MT>
int launch(const void* m, const void* r0, const void* r1, const void* bsc,
           void* out, int b, int hk, int wk, int hp, int wp, int mr, int mc,
           int winsize, int radius, int emit_flow, void* stream) {
  if (b == 0) return 0;
  if (hp % kBlk != 0 || winsize / 2 > (1 << (kMaxTreeBit + 1)) / 2 - 1)
    return (int)cudaErrorInvalidValue;
  const int ext = emit_flow ? 0 : radius + 1;
  const int rows = kBlk + 2 * ext;
  const int vc = kTX + 2 * (winsize / 2);
  const size_t bytes =
      sizeof(float) * ((size_t)5 * rows * vc + (size_t)rows * kTX + kBlk * kTX);
  cudaError_t err = cudaFuncSetAttribute(
      fused_box_update_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wp + kTX - 1) / kTX, hp / kBlk, b);
  fused_box_update_kernel<MT><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const MT*)m, (const float*)r0, (const float*)r1, (const float*)bsc, out,
      hk, wk, hp, wp, mr, mc, winsize, radius, emit_flow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nsof_fused_box_update(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, void* stream) {
  return launch<__nv_bfloat16>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc,
                               winsize, radius, emit_flow, stream);
}

extern "C" int nsof_fused_box_update_f32(
    const void* m, const void* r0, const void* r1, const void* bsc, void* out,
    int b, int hk, int wk, int hp, int wp, int mr, int mc, int winsize,
    int radius, int emit_flow, void* stream) {
  return launch<float>(m, r0, r1, bsc, out, b, hk, wk, hp, wp, mr, mc, winsize,
                       radius, emit_flow, stream);
}
