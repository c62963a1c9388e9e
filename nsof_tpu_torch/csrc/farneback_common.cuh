// Device code shared by K3 (update_matrices_sep.cu) and K4
// (fused_box_update.cu): the two-pass separable warp of r1 and the build of
// the five-channel system, in the operation order of the plain PyTorch
// version (nsof_tpu_torch/ops/farneback_fast.py::_warp_build).  Compiled
// with --fmad=false, every product and sum rounds once, as there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nsof {

__device__ __forceinline__ float clampf(float v, float r) {
  return fminf(fmaxf(v, -r), r);
}

__device__ __forceinline__ float hat(float d, int k) {
  return fmaxf(0.0f, 1.0f - fabsf(d - (float)k));
}

// Warp r1 at canvas pixel (y, x) and write M'(y, x) in bfloat16.
//   dx_row(ky): clamped dx of row y + ky (pass 1 interpolates each row at
//               its own dx); dx, dy: clamped flow at (y, x);
//   r1: this sample's [5, h1, w1] planes, canvas (0, 0) at (mr, mc);
//   r0: this sample's [5, hp, wp] planes; sc: border scale at (y, x).
template <typename DxRow>
__device__ __forceinline__ void warp_build_store(
    DxRow dx_row, float dx, float dy, const float* __restrict__ r1, int h1,
    int w1, int mr, int mc, const float* __restrict__ r0, long long plane,
    long long pix, float sc, int y, int x, int radius,
    __nv_bfloat16* __restrict__ out) {
  const long long plane1 = (long long)h1 * w1;
  float acc[5];
  for (int ky = -radius; ky <= radius + 1; ++ky) {
    const float dxr = dx_row(ky);
    const float* row = r1 + (long long)(y + ky + mr) * w1 + (x + mc);
    float t[5];
    for (int kx = -radius; kx <= radius + 1; ++kx) {
      const float wx = hat(dxr, kx);
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float v = __ldg(row + c * plane1 + kx) * wx;
        t[c] = (kx == -radius) ? v : t[c] + v;
      }
    }
    const float wy = hat(dy, ky);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float v = t[c] * wy;
      acc[c] = (ky == -radius) ? v : acc[c] + v;
    }
  }
  float r0c[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) r0c[c] = __ldg(r0 + c * plane + pix);
  float r4 = (r0c[2] + acc[2]) * 0.5f;
  float r5 = (r0c[3] + acc[3]) * 0.5f;
  float r6 = (r0c[4] + acc[4]) * 0.25f;
  const float b_y = (r0c[0] - acc[0]) * 0.5f;
  const float b_x = (r0c[1] - acc[1]) * 0.5f;
  float r2 = b_y + r4 * dy + r6 * dx;
  float r3 = b_x + r6 * dy + r5 * dx;
  r2 *= sc;
  r3 *= sc;
  r4 *= sc;
  r5 *= sc;
  r6 *= sc;
  out[0 * plane + pix] = __float2bfloat16(r4 * r4 + r6 * r6);
  out[1 * plane + pix] = __float2bfloat16((r4 + r5) * r6);
  out[2 * plane + pix] = __float2bfloat16(r5 * r5 + r6 * r6);
  out[3 * plane + pix] = __float2bfloat16(r4 * r2 + r6 * r3);
  out[4 * plane + pix] = __float2bfloat16(r6 * r2 + r5 * r3);
}

}  // namespace nsof
