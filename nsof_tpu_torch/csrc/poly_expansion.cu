// K2: Farnebäck polynomial expansion on the level's canvas.
//
// Replaces nsof_tpu/ops/farneback_fast.py::_poly_expansion_kernel (called
// through _poly_expansion_cm_pallas): from the edge-extended image, optionally
// pre-smoothed by the level-0 Gaussian (fused, edge borders), the five
// planes b_y, b_x, a_yy, a_xx, a_xy by separable g / x·g / x²·g taps with
// even/odd folding, scaled by ig11, ig03, ig33, ig55.
//
// Bound: it reads the image once (4 bytes a pixel) and writes five float32
// planes (20 bytes a pixel); its 27n + 12 flops a pixel, plus 2·(2nb+1) for
// the fused blur (~160 at n = 5), sit below the float32 ridge, so it is
// bound by the 24 bytes a pixel it must move.  Built with --fmad=false, a
// multiply and an add are two instructions, so the arithmetic is near the
// bound too: the design spends as few other instructions as it can.
//
// Design (the presets' n = 1 and 5, no blur or the 3-tap blur: four
// instances of a template on n and nb).  A block of 256 threads owns a strip
// of 128 output columns and streams down a run of 64 rows in chunks of 16,
// so the vertical halo is read once a run:
//  1. the image rows of the next chunk are copied into a ring of raw rows
//     with cp.async while this chunk computes (one commit group a chunk);
//     each row is read through clamped indices, which realises the edge
//     extension.  The copies are 4 bytes each: the strip's first column,
//     X0 − mc − n − nb, is not 16-byte aligned at the presets' n and
//     margins, and a warp's 32 copies still make one coalesced request;
//  2. the blur (nb = 1): down (Σ_s blur[s]·row[r+s]), then across, into a
//     ring of blurred rows; a thread takes 4 adjacent columns;
//  3. the vertical sums s0 (g), s1 (x·g), s2 (x²·g): a thread takes 4
//     adjacent columns of an output row and reads the 2n+1 rows above and
//     below as float4s;
//  4. the six horizontal sums and the five planes: a thread takes 4 adjacent
//     output pixels, loads the 4 + 2n values of each of s0, s1, s2 they read
//     as float4s into registers once, and stores each plane as one float4.
// Every sum runs in the plain version's order (centre tap first, then
// t = 1…n on hi ± lo).  The coefficients are kernel parameters (constant
// memory), every tap loop is unrolled, and every index but the ring's is a
// constant.  Other n or blur widths take the generic kernel below: one
// block per 16×32 output tile, its slab staged whole, runtime tap loops.
//
// Build facts (ptxas -v, sm_90a, --fmad=false): see PERF.md §6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 128;  // output columns of a block: 32 groups of 4
constexpr int kRun = 64;     // output rows of a block
constexpr int kChunk = 16;   // output rows a chunk

// The coefficients the template instances read: g, x·g, x²·g at taps
// n … 2n (the centre and one side: every sum folds hi ± lo), the blur, the
// four scales.
template <int N>
struct Coef {
  float g[N + 1], xg[N + 1], xxg[N + 1], blur[3];
  float ig11, ig03, ig33, ig55;
};

// Shared-memory geometry of an instance, in floats.
template <int N, int NB>
struct Geo {
  static constexpr int kGV = kStrip / 4 + (2 * N + 3) / 4;  // 4-column groups of a row
  static constexpr int kSW = 4 * kGV;                       // blurred and s rows
  static constexpr int kRW = kSW + 4 * NB;                  // raw rows
  static constexpr int kHW = (4 + 2 * N + 3) / 4;  // float4s a horizontal window reads
  static constexpr int kRawCap = 2 * kChunk + 2 * N + 2 * NB;  // raw ring rows
  static constexpr int kHbCap = NB ? kChunk + 2 * N : 0;      // blurred ring rows
  static constexpr int kRaw = 0;
  static constexpr int kHb = kRaw + kRawCap * kRW;
  static constexpr int kS = kHb + kHbCap * kSW;  // s0, s1, s2: [kChunk][kSW] each
  static constexpr int kFloats = kS + 3 * kChunk * kSW;
  static constexpr int kCopies = (kRW + 31) / 32;  // raw columns a lane copies
  static_assert(kHW * 4 <= kSW - 4 * (kStrip / 4 - 1), "horizontal window inside s");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int N, int NB>
__global__ void __launch_bounds__(kThreads, 3) poly_expansion_kernel(
    const float* __restrict__ img, float* __restrict__ out, const Coef<N> cf, int hk, int wk,
    int ho, int wo, int mr, int mc) {
  using G = Geo<N, NB>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* raw = smem + G::kRaw;
  float* hb = NB ? smem + G::kHb : raw;  // the rows the vertical sums read
  constexpr int kHbCap = NB ? G::kHbCap : G::kRawCap;
  constexpr int kHbStride = NB ? G::kSW : G::kRW;
  float* s0 = smem + G::kS;
  float* s1 = s0 + kChunk * G::kSW;
  float* s2 = s1 + kChunk * G::kSW;
  constexpr int hh = N + NB;

  const int b = blockIdx.z;
  const int X0 = blockIdx.x * kStrip;
  const int Y0 = blockIdx.y * kRun;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_out = min(kStrip, wo - X0);     // output columns of the strip
  const int n_grp = (n_out + 3) / 4;          // their 4-pixel groups
  const int n_vgrp = n_grp + (2 * N + 3) / 4;  // groups of s (and blurred) columns
  const int run = min(kRun, ho - Y0);
  const int n_chunks = (run + kChunk - 1) / kChunk;

  // raw row q is source row Y0 + q, raw column j source column X0 + j:
  // image pixel (Y0 + q - mr - hh, X0 + j - mc - hh), clamped
  const float* src = img + (long long)b * hk * wk;
  int coff[G::kCopies];
#pragma unroll
  for (int k = 0; k < G::kCopies; ++k)
    coff[k] = min(max(X0 + lane + 32 * k - mc - hh, 0), wk - 1);
  auto load_rows = [&](int q0, int q1) {
    for (int q = q0 + warp; q < q1; q += kThreads / 32) {
      const float* row = src + (long long)min(max(Y0 + q - mr - hh, 0), hk - 1) * wk;
      float* d = raw + (q % G::kRawCap) * G::kRW + lane;
#pragma unroll
      for (int k = 0; k < G::kCopies; ++k)
        if (lane + 32 * k < G::kRW) cp_async4(d + 32 * k, row + coff[k]);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // chunk k's vertical sums read blurred rows [16k, 16k + 16 + 2N); it
  // computes those past 16k + 2N (all of them in chunk 0) from raw rows
  // up to 16k + 16 + 2N + 2NB, which the chunk before it loaded
  auto raw_end = [&](int k) { return kChunk * (k + 1) + 2 * N + 2 * NB; };
  load_rows(0, raw_end(0));

  const long long plane = (long long)ho * wo;
  float* dst = out + (long long)b * 5 * plane;
  const bool vec = (wo & 3) == 0;

  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks)
      load_rows(raw_end(k), raw_end(k + 1));
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int rows = min(kChunk, run - kChunk * k);  // output rows of this chunk
    const int p_end = kChunk * k + rows + 2 * N;     // blurred rows it reads end here

    // 2. the blur of blurred rows [p0, p_end): down, then across
    if constexpr (NB == 1) {
      const int p0 = k == 0 ? 0 : kChunk * k + 2 * N;
      for (int i = threadIdx.x; i < (p_end - p0) * n_vgrp; i += kThreads) {
        const int p = p0 + i / n_vgrp;
        const int c0 = 4 * (i % n_vgrp);
        float v[6];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const float* r = raw + ((p + s) % G::kRawCap) * G::kRW + c0;
          const float4 a = *reinterpret_cast<const float4*>(r);
          const float2 e = *reinterpret_cast<const float2*>(r + 4);
          const float x[6] = {a.x, a.y, a.z, a.w, e.x, e.y};
#pragma unroll
          for (int c = 0; c < 6; ++c) v[c] = s == 0 ? cf.blur[0] * x[c] : v[c] + cf.blur[s] * x[c];
        }
        float h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[q] = cf.blur[0] * v[q];
          h[q] = h[q] + cf.blur[1] * v[q + 1];
          h[q] = h[q] + cf.blur[2] * v[q + 2];
        }
        *reinterpret_cast<float4*>(hb + (p % kHbCap) * kHbStride + c0) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
      __syncthreads();
    }

    // 3. the vertical sums of output row 16k + r: blurred rows 16k + r + t,
    //    t = 0 … 2N, centre t = N
    for (int i = threadIdx.x; i < rows * n_vgrp; i += kThreads) {
      const int r = i / n_vgrp;
      const int c0 = 4 * (i % n_vgrp);
      const int p = kChunk * k + r;
      auto row = [&](int t) {
        return *reinterpret_cast<const float4*>(hb + ((p + t) % kHbCap) * kHbStride + c0);
      };
      const float4 cv = row(N);
      const float c[4] = {cv.x, cv.y, cv.z, cv.w};
      float a0[4], a1[4], a2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a0[q] = cf.g[0] * c[q];
        a2[q] = cf.xxg[0] * c[q];
      }
#pragma unroll
      for (int t = 1; t <= N; ++t) {
        const float4 hv = row(N + t), lv = row(N - t);
        const float hi[4] = {hv.x, hv.y, hv.z, hv.w};
        const float lo[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sum = hi[q] + lo[q];
          a0[q] = a0[q] + cf.g[t] * sum;
          const float odd = cf.xg[t] * (hi[q] - lo[q]);
          a1[q] = t == 1 ? odd : a1[q] + odd;
          a2[q] = a2[q] + cf.xxg[t] * sum;
        }
      }
      const int o = r * G::kSW + c0;
      *reinterpret_cast<float4*>(s0 + o) = make_float4(a0[0], a0[1], a0[2], a0[3]);
      *reinterpret_cast<float4*>(s1 + o) = make_float4(a1[0], a1[1], a1[2], a1[3]);
      *reinterpret_cast<float4*>(s2 + o) = make_float4(a2[0], a2[1], a2[2], a2[3]);
    }
    __syncthreads();

    // 4. the horizontal sums and the five planes of 4 adjacent pixels; the
    //    window w[j] is s at column x0 + j, pixel q's centre at j = q + N
    for (int i = threadIdx.x; i < rows * n_grp; i += kThreads) {
      const int r = i / n_grp;
      const int x0 = 4 * (i % n_grp);
      const int Y = Y0 + kChunk * k + r;
      const int X = X0 + x0;
      float w[4 * G::kHW];
      auto window = [&](const float* s) {
#pragma unroll
        for (int u = 0; u < G::kHW; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(s + r * G::kSW + x0 + 4 * u);
          w[4 * u] = v.x;
          w[4 * u + 1] = v.y;
          w[4 * u + 2] = v.z;
          w[4 * u + 3] = v.w;
        }
      };
      auto put = [&](int ch, const float (&v)[4]) {
        float* o = dst + ch * plane + (long long)Y * wo + X;
        if (vec && X + 3 < wo) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (X + q < wo) o[q] = v[q];
        }
      };
      // s0: b1 (g), b3 (x·g, odd), b4 (x²·g)
      float b1[4], b3[4], b4[4], o[4];
      window(s0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b1[q] = cf.g[0] * w[q + N];
        b4[q] = cf.xxg[0] * w[q + N];
#pragma unroll
        for (int t = 1; t <= N; ++t) {
          const float hi = w[q + N + t], lo = w[q + N - t];
          const float sum = hi + lo;
          b1[q] = b1[q] + cf.g[t] * sum;
          const float odd = cf.xg[t] * (hi - lo);
          b3[q] = t == 1 ? odd : b3[q] + odd;
          b4[q] = b4[q] + cf.xxg[t] * sum;
        }
        o[q] = b3[q] * cf.ig11;
      }
      if (Y < ho) put(1, o);
      // s1: b2 (g), b6 (x·g, odd)
      float b2[4], b6[4];
      window(s1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b2[q] = cf.g[0] * w[q + N];
#pragma unroll
        for (int t = 1; t <= N; ++t) {
          const float hi = w[q + N + t], lo = w[q + N - t];
          b2[q] = b2[q] + cf.g[t] * (hi + lo);
          const float odd = cf.xg[t] * (hi - lo);
          b6[q] = t == 1 ? odd : b6[q] + odd;
        }
      }
      if (Y < ho) {
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = b2[q] * cf.ig11;
        put(0, o);
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = b6[q] * cf.ig55;
        put(4, o);
      }
      // s2: b5 (g)
      float b5[4];
      window(s2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b5[q] = cf.g[0] * w[q + N];
#pragma unroll
        for (int t = 1; t <= N; ++t) b5[q] = b5[q] + cf.g[t] * (w[q + N + t] + w[q + N - t]);
      }
      if (Y < ho) {
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = b1[q] * cf.ig03 + b5[q] * cf.ig33;
        put(2, o);
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = b1[q] * cf.ig03 + b4[q] * cf.ig33;
        put(3, o);
      }
    }
  }
}

template <int N, int NB>
int launch(const float* img, const float* coef, float* out, int b, int hk, int wk, int ho,
           int wo, int mr, int mc, cudaStream_t stream) {
  using G = Geo<N, NB>;
  constexpr int taps = 2 * N + 1;
  Coef<N> cf;
  for (int t = 0; t <= N; ++t) {
    cf.g[t] = coef[N + t];
    cf.xg[t] = coef[taps + N + t];
    cf.xxg[t] = coef[2 * taps + N + t];
  }
  for (int s = 0; s < 3; ++s) cf.blur[s] = NB ? coef[3 * taps + s] : 0.0f;
  const float* igs = coef + 3 * taps + (NB ? 3 : 0);
  cf.ig11 = igs[0];
  cf.ig03 = igs[1];
  cf.ig33 = igs[2];
  cf.ig55 = igs[3];
  const int bytes = (int)sizeof(float) * G::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      poly_expansion_kernel<N, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wo + kStrip - 1) / kStrip, (ho + kRun - 1) / kRun, b);
  poly_expansion_kernel<N, NB><<<grid, kThreads, bytes, stream>>>(img, out, cf, hk, wk, ho, wo,
                                                                  mr, mc);
  return (int)cudaGetLastError();
}

// ── the generic kernel: any n, any odd blur ───────────────────────────────

constexpr int kTY = 16;
constexpr int kTX = 32;

// coef: g[2n+1], xg[2n+1], xxg[2n+1], blur[n_blur], ig11, ig03, ig33, ig55;
// n_blur is 0 (no pre-blur) or the blur's odd tap count
__global__ void poly_expansion_kernel_generic(
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

int launch_generic(const float* img, const float* coef, float* out, int b, int hk, int wk,
                   int n, int n_blur, int ho, int wo, int mr, int mc, cudaStream_t stream) {
  const int nb = n_blur / 2;
  const int hh = n + nb;
  const int sr = kTY + 2 * hh, sc = kTX + 2 * hh;
  const int pr = kTY + 2 * n, pc = kTX + 2 * n;
  size_t floats = (size_t)sr * sc + 3 * kTY * pc;
  if (n_blur) floats += (size_t)pr * sc + (size_t)pr * pc;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      poly_expansion_kernel_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((wo + kTX - 1) / kTX, (ho + kTY - 1) / kTY, b);
  poly_expansion_kernel_generic<<<grid, kThreads, bytes, stream>>>(
      img, coef, out, hk, wk, n, n_blur, ho, wo, mr, mc);
  return (int)cudaGetLastError();
}

}  // namespace

// coef / coef_host: the same coefficients on the device and on the host
// (g[2n+1], xg[2n+1], xxg[2n+1], blur[n_blur], ig11, ig03, ig33, ig55); the
// template instances take theirs from the host copy as kernel parameters.
extern "C" int nsof_poly_expansion(
    const void* img, const void* coef, const void* coef_host, void* out, int b, int hk,
    int wk, int n, int n_blur, int ho, int wo, int mr, int mc, void* stream) {
  if (b == 0) return 0;
  const float* im = (const float*)img;
  const float* ch = (const float*)coef_host;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 5 && n_blur == 3) return launch<5, 1>(im, ch, o, b, hk, wk, ho, wo, mr, mc, st);
  if (n == 5 && n_blur == 0) return launch<5, 0>(im, ch, o, b, hk, wk, ho, wo, mr, mc, st);
  if (n == 1 && n_blur == 3) return launch<1, 1>(im, ch, o, b, hk, wk, ho, wo, mr, mc, st);
  if (n == 1 && n_blur == 0) return launch<1, 0>(im, ch, o, b, hk, wk, ho, wo, mr, mc, st);
  return launch_generic(im, (const float*)coef, o, b, hk, wk, n, n_blur, ho, wo, mr, mc, st);
}
