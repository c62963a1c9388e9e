// K7: a Farnebäck system from the non-separable warp.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_update_matrices_kernel (driver
// update_matrices_pallas(separable=False), the update of
// kernel_mode='pallas'): clamp the flow to ±r, sample r1 bilinearly at
// (x + dx, y + dy) as the sum of its (2r+2)² taps, each weighted by
// hat(dy - ky)·hat(dx - kx), build r2…r6, scale by the border table and
// store the five products in float32.  The sum runs ky outer, kx inner,
// acc[c] + tap·(wy·wx), the order of update_matrices_fast, which the TPU
// kernel matches.
//
// Bound: per pixel it must read r0 and r1 (20 bytes each), dx, dy and write
// M (20): ~68 bytes, ~5.6 GB for B = 128 at 801×801.  The work is (2r+2)²
// taps × (1 weight product + 5 products + 5 sums) plus the hat weights and
// the build, ≈ 800 flops a pixel at r = 3, below the float32 ridge, so the
// bytes bound it; this version evaluates hat(dx - kx) for every tap
// (≈ 1,000 flops a pixel).  Design: one thread per
// output pixel, no shared memory.  r1 comes edge-padded by r + 1 on every
// side (one pad per pyramid level, shared by every update of the level), so
// the taps need no clamping; the taps of neighbouring threads overlap and
// come from L1.

#include <stdint.h>

#include "farneback_common.cuh"

namespace {

__global__ void update_matrices_kernel(
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ r0, const float* __restrict__ r1p,
    const float* __restrict__ bsc, float* __restrict__ out, int h, int w,
    int pad, int radius) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const float rad = (float)radius;
  const long long plane = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float dxc = nsof::clampf(dx[b * plane + pix], rad);
  const float dyc = nsof::clampf(dy[b * plane + pix], rad);
  const int w1 = w + 2 * pad;
  const long long plane1 = (long long)(h + 2 * pad) * w1;
  const float* r1b = r1p + (long long)b * 5 * plane1;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int ky = -radius; ky <= radius + 1; ++ky) {
    const float wy = nsof::hat(dyc, ky);
    const float* row = r1b + (long long)(y + ky + pad) * w1 + (x + pad);
    for (int kx = -radius; kx <= radius + 1; ++kx) {
      const float wgt = wy * nsof::hat(dxc, kx);
#pragma unroll
      for (int c = 0; c < 5; ++c)
        acc[c] = acc[c] + __ldg(row + c * plane1 + kx) * wgt;
    }
  }
  nsof::build_store(acc, r0 + (long long)b * 5 * plane, plane, pix, dxc, dyc,
                    bsc[pix], out + (long long)b * 5 * plane);
}

}  // namespace

extern "C" int nsof_update_matrices(const void* dx, const void* dy,
                                    const void* r0, const void* r1p,
                                    const void* bsc, void* out, int b, int h,
                                    int w, int pad, int radius, void* stream) {
  if (b == 0) return 0;
  if (pad < radius + 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((w + 31) / 32, (h + 7) / 8, b);
  update_matrices_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)dx, (const float*)dy, (const float*)r0, (const float*)r1p,
      (const float*)bsc, (float*)out, h, w, pad, radius);
  return (int)cudaGetLastError();
}
