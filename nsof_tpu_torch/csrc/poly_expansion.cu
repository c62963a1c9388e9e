// K2: Farnebäck polynomial expansion on the level's canvas.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_poly_expansion_kernel (called
// through _poly_expansion_cm_pallas): from the edge-extended image, optionally
// pre-smoothed by the level-0 Gaussian (fused, edge borders), the five
// planes b_y, b_x, a_yy, a_xx, a_xy by separable g / x·g / x²·g taps with
// even/odd folding, scaled by ig11, ig03, ig33, ig55.
//
// Bound: it reads the image once (4 bytes a pixel) and writes five float32
// planes (20 bytes a pixel); its 27n + 12 flops a pixel, plus 8nb + 2 for
// the fused blur (~160 at n = 5), sit below the float32 ridge, so it is
// bound by the 24 bytes a pixel it must move.
// Design: one block per (sample, 16×32 output tile) stages the tile's image
// slab plus its n+nb halo in shared memory, read through clamped indices,
// so the edge padding of the TPU version needs no copy; the blur, the
// vertical pass (3 sums) and the horizontal pass (6 sums) then run out of
// shared memory, and each output is written once, coalesced along the row.
// Every sum runs in the Pallas kernel's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTY = 16;
constexpr int kTX = 32;
constexpr int kThreads = 256;

// coef: g[2n+1], xg[2n+1], xxg[2n+1], blur[n_blur], ig11, ig03, ig33, ig55;
// n_blur is 0 (no pre-blur) or the blur's odd tap count
__global__ void poly_expansion_kernel(
    const float* __restrict__ img, const float* __restrict__ coef,
    float* __restrict__ out, int hk, int wk, int n, int n_blur, int ho,
    int wo, int mr, int mc) {
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int Y0 = blockIdx.y * kTY;
  const int X0 = blockIdx.x * kTX;
  const int nb = n_blur / 2;
  const int hh = n + nb;
  const int sr = kTY + 2 * hh, sc = kTX + 2 * hh;  // raw slab
  const int pr = kTY + 2 * n, pc = kTX + 2 * n;    // poly source
  const int taps = 2 * n + 1;
  const float* g = coef;
  const float* xg = coef + taps;
  const float* xxg = coef + 2 * taps;
  const float* blur = coef + 3 * taps;
  const float* igs = blur + n_blur;
  const float ig11 = igs[0], ig03 = igs[1], ig33 = igs[2], ig55 = igs[3];

  float* slab = smem;  // sr × sc
  float* vb = slab + sr * sc;  // pr × sc (blur only)
  float* hb = vb + (n_blur ? pr * sc : 0);  // pr × pc (blur only)
  float* s0 = hb + (n_blur ? pr * pc : 0);  // kTY × pc each
  float* s1 = s0 + kTY * pc;
  float* s2 = s1 + kTY * pc;

  // slab (0, 0) is image pixel (Y0 - mr - hh, X0 - mc - hh), clamped
  const float* src_img = img + (long long)b * hk * wk;
  for (int i = threadIdx.x; i < sr * sc; i += kThreads) {
    const int r = i / sc, c = i % sc;
    const int iy = min(max(Y0 - mr - hh + r, 0), hk - 1);
    const int ix = min(max(X0 - mc - hh + c, 0), wk - 1);
    slab[i] = src_img[(long long)iy * wk + ix];
  }
  __syncthreads();

  const float* src = slab;  // pr × pc, stride pc (nb == 0 ⇒ sc == pc)
  if (n_blur) {
    for (int i = threadIdx.x; i < pr * sc; i += kThreads) {
      const int r = i / sc, c = i % sc;
      float v = blur[0] * slab[r * sc + c];
      for (int s = 1; s <= 2 * nb; ++s) v = v + blur[s] * slab[(r + s) * sc + c];
      vb[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pr * pc; i += kThreads) {
      const int r = i / pc, c = i % pc;
      float v = blur[0] * vb[r * sc + c];
      for (int s = 1; s <= 2 * nb; ++s) v = v + blur[s] * vb[r * sc + c + s];
      hb[i] = v;
    }
    __syncthreads();
    src = hb;
  }

  // vertical pass: s0 (g, even), s1 (xg, odd), s2 (xxg, even)
  for (int i = threadIdx.x; i < kTY * pc; i += kThreads) {
    const int r = i / pc, c = i % pc;
    const float* col = src + (r + n) * pc + c;
    float a0 = g[n] * col[0];
    float a2 = xxg[n] * col[0];
    float a1 = 0.0f;
    for (int t = 1; t <= n; ++t) {
      const float hi = col[t * pc], lo = col[-t * pc];
      a0 = a0 + g[n + t] * (hi + lo);
      const float odd = xg[n + t] * (hi - lo);
      a1 = (t == 1) ? odd : a1 + odd;
      a2 = a2 + xxg[n + t] * (hi + lo);
    }
    s0[i] = a0;
    s1[i] = a1;
    s2[i] = a2;
  }
  __syncthreads();

  // horizontal pass and the five planes
  const long long plane = (long long)ho * wo;
  float* dst = out + (long long)b * 5 * plane;
  for (int i = threadIdx.x; i < kTY * kTX; i += kThreads) {
    const int r = i / kTX, c = i % kTX;
    const int Y = Y0 + r, X = X0 + c;
    if (Y >= ho || X >= wo) continue;
    const float* p0 = s0 + r * pc + c + n;
    const float* p1 = s1 + r * pc + c + n;
    const float* p2 = s2 + r * pc + c + n;
    float b1 = g[n] * p0[0];
    float b2 = g[n] * p1[0];
    float b4 = xxg[n] * p0[0];
    float b5 = g[n] * p2[0];
    float b3 = 0.0f, b6 = 0.0f;
    for (int t = 1; t <= n; ++t) {
      b1 = b1 + g[n + t] * (p0[t] + p0[-t]);
      b2 = b2 + g[n + t] * (p1[t] + p1[-t]);
      const float o3 = xg[n + t] * (p0[t] - p0[-t]);
      b3 = (t == 1) ? o3 : b3 + o3;
      b4 = b4 + xxg[n + t] * (p0[t] + p0[-t]);
      b5 = b5 + g[n + t] * (p2[t] + p2[-t]);
      const float o6 = xg[n + t] * (p1[t] - p1[-t]);
      b6 = (t == 1) ? o6 : b6 + o6;
    }
    const long long pix = (long long)Y * wo + X;
    dst[0 * plane + pix] = b2 * ig11;
    dst[1 * plane + pix] = b3 * ig11;
    dst[2 * plane + pix] = b1 * ig03 + b5 * ig33;
    dst[3 * plane + pix] = b1 * ig03 + b4 * ig33;
    dst[4 * plane + pix] = b6 * ig55;
  }
}

}  // namespace

extern "C" int nsof_poly_expansion(
    const void* img, const void* coef, void* out, int b, int hk, int wk,
    int n, int n_blur, int ho, int wo, int mr, int mc, void* stream) {
  if (b == 0) return 0;
  const int nb = n_blur / 2;
  const int hh = n + nb;
  const int sr = kTY + 2 * hh, sc = kTX + 2 * hh;
  const int pr = kTY + 2 * n, pc = kTX + 2 * n;
  size_t floats = (size_t)sr * sc + 3 * kTY * pc;
  if (n_blur) floats += (size_t)pr * sc + (size_t)pr * pc;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      poly_expansion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wo + kTX - 1) / kTX, (ho + kTY - 1) / kTY, b);
  poly_expansion_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)coef, (float*)out, hk, wk, n, n_blur, ho,
      wo, mr, mc);
  return (int)cudaGetLastError();
}
