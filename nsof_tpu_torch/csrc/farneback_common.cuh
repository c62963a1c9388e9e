// Device code shared by the Farnebäck kernels: the system build at one
// pixel (build_store; build_store_r0 where r0 was read ahead), which K3/K5
// (update_matrices_sep.cu), K4 (fused_box_update.cu) and K7
// (update_matrices.cu) all end with, and its small helpers.  It follows the
// operation order of the plain PyTorch version
// (nsof_tpu_torch/ops/farneback_fast.py::_build_system).  Compiled with
// --fmad=false, every product and sum rounds once, as there.  M is stored in
// bfloat16 or float32: load() and store() convert.

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

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// The system at one pixel from the warped r1 (acc), r0's five values at the
// pixel (r0c), the clamped flow and the border scale sc: write the five
// products to out (plane stride `plane`, pixel `pix`).
template <typename OutT>
__device__ __forceinline__ void build_store_r0(
    const float* acc, const float* r0c, long long plane, long long pix, float dx,
    float dy, float sc, OutT* __restrict__ out) {
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
  store(out + 0 * plane + pix, r4 * r4 + r6 * r6);
  store(out + 1 * plane + pix, (r4 + r5) * r6);
  store(out + 2 * plane + pix, r5 * r5 + r6 * r6);
  store(out + 3 * plane + pix, r4 * r2 + r6 * r3);
  store(out + 4 * plane + pix, r6 * r2 + r5 * r3);
}

// The same with r0 read at the pixel.
template <typename OutT>
__device__ __forceinline__ void build_store(
    const float* acc, const float* __restrict__ r0, long long plane,
    long long pix, float dx, float dy, float sc, OutT* __restrict__ out) {
  float r0c[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) r0c[c] = __ldg(r0 + c * plane + pix);
  build_store_r0(acc, r0c, plane, pix, dx, dy, sc, out);
}

}  // namespace nsof
