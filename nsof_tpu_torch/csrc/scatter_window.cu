// K13: the seg step's scatter.  Writes the [B, H, W] uint8 mask frame and, when
// asked, the [B, H, W, 2] float32 flow frame of seg_batch_fast in one launch,
// every output byte once, bit for bit its plain version
// (ops/roi.py::scatter_seg_windows_plain: scatter_window of the mask window
// into a zero frame, then of the negated flow, zeroed outside the box and
// for inactive samples, into another).
//
// Replaces no TPU kernel: the JAX package scatters its windows with
// dynamic_update_slice in plain XLA (nsof_tpu/ops/roi.py:318).  The port's
// plain version makes a zero frame, clones it, gathers the window by advanced
// indexing, selects and indexes back, for the mask and again for the flow
// after a stack and a select: 77 launches a call at the cells' shapes, each
// a pass over a frame-sized tensor.
//
// What it computes.  For sample b, with origin (oy, ox) as given and
// (cy, cx) the clamped one (dynamic_slice semantics: a negative origin
// counts from the end, then the window is moved to fit), the window pixel
// (r, c) lands at frame (cy + r, cx + c) and is written there where
// (oy + r, ox + c) lies in the box [x0, y0, x1, y1) (window_box_mask at the
// origin as given).  Those pixels form one rectangle of the frame, the write
// region.  Then, for every frame pixel:
//   mask = in region ? mask_win[b, y − cy, x − cx] : 0
//   flow = in region and active[b] ? (−dx, −dy)[b, y − cy, x − cx] : (+0, +0)
// The kernel only copies, negates and selects, so it is bit-equal by
// construction; a −0.0 stays where the plain version has one.
//
// Bound: bytes.  Each output pixel is written once, 9 bytes with the flow
// (1 without), and each window pixel in the region is read once (9 bytes).
// At the cells' shapes (B = 128) grasp's 1920×1080 writes 2.39 GB, 0.71 ms
// a call at 3.35 TB/s (0.0056 ms a pair), and reads at most as much again
// when the box is the whole frame (0.0111 ms a pair); autodriving's 801²
// writes 0.74 GB, 0.22 ms (0.0017 – 0.0034 ms a pair).  The cells' boxes
// cover at most 9 % of the frame, so the reads are a small part.
//
// Design: a pure streaming write, so only the bytes matter.
//  - The outputs come from torch.empty: no zero fill, no clone.
//  - The flat [B·H·W] output is cut into tiles of 4096 pixels, one a block
//    of 256 threads: each thread stores 16 mask pixels as one uint4 and 8 ×
//    2 flow pixels as float4s, neighbouring threads on neighbouring 16-byte
//    words.  A tile starts on a 16-byte boundary of both outputs whatever the
//    width, so ragged widths such as 801 cost nothing special; a 16-pixel
//    mask word that crosses a row's end is filled pixel by pixel.
//  - A block computes the write regions of the (at most two) samples its
//    tile touches once, into shared memory, from the box, the origins and
//    `active`.  A tile wholly outside its sample's region rows only stores
//    zeros; elsewhere a pixel's row and column come from two divisions by
//    invariant integers (a multiply-high and a shift: CUTLASS's FastDivmod),
//    and dx, dy and mask_win are read only for pixels in the region.
//  - With no flow frame asked for (flow == nullptr) the kernel writes the
//    mask alone.
//
// The kernel allocates nothing: the wrapper allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16 * kThreads;            // output pixels a block
constexpr int kFlowWords = kTile / 2 / kThreads;  // float4s (2 pixels) a thread

// x / d for 0 ≤ x < 2^31 by a multiply-high and a shift (mul, shr from
// make_div); d = 1 is passed through.
struct Div {
  unsigned d, mul, shr;
};

__device__ __forceinline__ unsigned divide(unsigned x, const Div& v) {
  return v.d == 1 ? x : __umulhi(x, v.mul) >> v.shr;
}

// A sample's write region: frame rows [y0, y1) and columns [x0, x1), empty
// when y0 == y1; frame pixel (y, x) is window pixel (y − cy, x − cx).
struct Region {
  int y0, y1, x0, x1, cy, cx, active;
};

struct Frame {
  const uint8_t* mask_win;  // [B, wh, ww], contiguous
  const float* dx;          // [B, wh, ww] at strides (sb, sr, 1); null without flow
  const float* dy;
  const int32_t* box;       // [B, 4]: x0, y0, x1, y1
  const int32_t* oys;       // [B], as given
  const int32_t* oxs;
  const uint8_t* active;    // [B] bool
  long long n;              // B·H·W
  long long hw;             // H·W
  int b, h, w, wh, ww;
  long long sb, sr;
  Div hw_div, w_div;
};

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ Region region_of(const Frame& f, long long b) {
  const long long oy = f.oys[b], ox = f.oxs[b];
  const long long cy = lmin(lmax(oy < 0 ? oy + f.h : oy, 0), f.h - f.wh);
  const long long cx = lmin(lmax(ox < 0 ? ox + f.w : ox, 0), f.w - f.ww);
  const int32_t* bx = f.box + 4 * b;
  // window row r is written where oy + r lies in [y0, y1): r in [r0, r1)
  const long long r0 = lmax(0, bx[1] - oy), r1 = lmin(f.wh, bx[3] - oy);
  const long long c0 = lmax(0, bx[0] - ox), c1 = lmin(f.ww, bx[2] - ox);
  Region g;
  g.cy = (int)cy;
  g.cx = (int)cx;
  g.active = f.active[b] != 0;
  if (r0 < r1 && c0 < c1) {
    g.y0 = (int)(cy + r0);
    g.y1 = (int)(cy + r1);
    g.x0 = (int)(cx + c0);
    g.x1 = (int)(cx + c1);
  } else {
    g.y0 = g.y1 = g.x0 = g.x1 = 0;
  }
  return g;
}

struct Tile {
  long long b0;     // the sample of the tile's first pixel
  unsigned r0;      // that pixel's offset in its sample's H·W plane
  Region g[2];      // the regions of samples b0 and b0 + 1
  int zero_mask;    // the tile lies in one sample, off its region's rows
  int zero_flow;    // ... or that sample is inactive
};

__device__ __forceinline__ bool inside(const Region& g, int y, int x) {
  return y >= g.y0 && y < g.y1 && x >= g.x0 && x < g.x1;
}

// The sample, row, column and region of the tile's pixel q.
__device__ __forceinline__ void locate(const Frame& f, const Tile& t, const Region& g0,
                                       const Region& g1, int q, long long& b, int& y,
                                       int& x, Region& g) {
  const unsigned r = t.r0 + (unsigned)q;
  const unsigned db = divide(r, f.hw_div);
  const unsigned rr = r - db * (unsigned)f.hw;
  const unsigned yy = divide(rr, f.w_div);
  y = (int)yy;
  x = (int)(rr - yy * (unsigned)f.w);
  b = t.b0 + db;
  g = db == 0 ? g0 : db == 1 ? g1 : region_of(f, b);  // more only below 4096 pixels a frame
}

__device__ __forceinline__ uint8_t mask_at(const Frame& f, long long b, int y, int x,
                                           const Region& g) {
  if (!inside(g, y, x)) return 0;
  return f.mask_win[(b * f.wh + (y - g.cy)) * f.ww + (x - g.cx)];
}

__device__ __forceinline__ float2 flow_at(const Frame& f, long long b, int y, int x,
                                          const Region& g) {
  if (!g.active || !inside(g, y, x)) return make_float2(0.0f, 0.0f);
  const long long i = b * f.sb + (long long)(y - g.cy) * f.sr + (x - g.cx);
  return make_float2(-__ldg(f.dx + i), -__ldg(f.dy + i));
}

// The 16 bytes at s, any alignment (as K1's load16): the aligned word that
// holds s[0] and, unless s is aligned, the next one, shifted into place.
// Called only where all 16 bytes lie in one window row, so both words hold
// bytes of the buffer.
__device__ __forceinline__ uint4 load16(const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  const int sh = (int)(a & 15);
  const uint4* p = reinterpret_cast<const uint4*>(a - sh);
  const uint4 lo = __ldg(p);
  if (sh == 0) return lo;
  const uint4 hi = __ldg(p + 1);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = sh >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  const unsigned bits = 8u * (unsigned)(sh & 3);
  return make_uint4(__funnelshift_r(v[0], v[1], bits), __funnelshift_r(v[1], v[2], bits),
                    __funnelshift_r(v[2], v[3], bits), __funnelshift_r(v[3], v[4], bits));
}

__global__ void __launch_bounds__(kThreads) scatter_window_kernel(
    const Frame f, uint8_t* __restrict__ mask, float* __restrict__ flow) {
  __shared__ Tile t;
  const long long p0 = (long long)blockIdx.x * kTile;
  if (threadIdx.x < 2) {
    const long long b0 = p0 / f.hw;
    const long long b = b0 + threadIdx.x;
    if (b < f.b) t.g[threadIdx.x] = region_of(f, b);
    if (threadIdx.x == 0) {
      const Region g = t.g[0];
      t.b0 = b0;
      t.r0 = (unsigned)(p0 - b0 * f.hw);
      // the offset of the tile's last pixel in sample b0's plane
      const long long rl = t.r0 + (lmin(p0 + kTile, f.n) - 1 - p0);
      int zm = 0, zf = 0;
      if (rl < f.hw) {
        const long long ya = t.r0 / f.w, yb = rl / f.w;
        zm = g.y0 == g.y1 || yb < g.y0 || ya >= g.y1;
        zf = zm || !g.active;
      }
      t.zero_mask = zm;
      t.zero_flow = zf;
    }
  }
  __syncthreads();
  const Region g0 = t.g[0], g1 = t.g[1];  // g1 is read only for pixels of sample b0 + 1

  // the mask: 16 pixels a thread, one uint4
  {
    const int q = 16 * threadIdx.x;
    const long long pm = p0 + q;
    if (pm < f.n) {
      const bool whole = pm + 16 <= f.n;
      long long b = 0;
      int y = 0, x = 0;
      Region g = g0;
      if (!t.zero_mask) locate(f, t, g0, g1, q, b, y, x, g);
      if (whole && (t.zero_mask || x + 16 <= f.w)) {
        // one row of one sample (or a tile with nothing to copy)
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (!t.zero_mask && y >= g.y0 && y < g.y1 && x < g.x1 && x + 16 > g.x0) {
          const uint8_t* src = f.mask_win + ((b * f.wh + (y - g.cy)) * f.ww + (x - g.cx));
          if (x >= g.x0 && x + 16 <= g.x1) {
            v = load16(src);
          } else {
            uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if (x + i >= g.x0 && x + i < g.x1) wd[i >> 2] |= (uint32_t)src[i] << (8 * (i & 3));
            v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
          }
        }
        *reinterpret_cast<uint4*>(mask + pm) = v;
      } else {
        // across a row's end, a sample's or the output's: pixel by pixel
        for (int i = 0; i < 16 && pm + i < f.n; ++i) {
          uint8_t v = 0;
          if (!t.zero_mask) {
            locate(f, t, g0, g1, q + i, b, y, x, g);
            v = mask_at(f, b, y, x, g);
          }
          mask[pm + i] = v;
        }
      }
    }
  }

  // the flow: 2 pixels a float4, neighbouring threads on neighbouring words
  if (flow == nullptr) return;
#pragma unroll
  for (int k = 0; k < kFlowWords; ++k) {
    const int q = 2 * (k * kThreads + threadIdx.x);
    const long long pf = p0 + q;
    if (pf >= f.n) continue;
    const bool two = pf + 1 < f.n;
    float2 a = make_float2(0.0f, 0.0f), c = make_float2(0.0f, 0.0f);
    if (!t.zero_flow) {
      long long b;
      int y, x;
      Region g;
      locate(f, t, g0, g1, q, b, y, x, g);
      a = flow_at(f, b, y, x, g);
      if (two) {
        if (x + 1 < f.w) {
          c = flow_at(f, b, y, x + 1, g);
        } else {
          locate(f, t, g0, g1, q + 1, b, y, x, g);
          c = flow_at(f, b, y, x, g);
        }
      }
    }
    if (two)
      *reinterpret_cast<float4*>(flow + 2 * pf) = make_float4(a.x, a.y, c.x, c.y);
    else
      *reinterpret_cast<float2*>(flow + 2 * pf) = a;
  }
}

Div make_div(unsigned d) {
  Div v{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    v.mul = (unsigned)(((1ull << p) + d - 1) / d);
    v.shr = p - 32;
  }
  return v;
}

}  // namespace

extern "C" int nsof_scatter_window(
    const void* mask_win, const void* dx, const void* dy, const void* box, const void* oys,
    const void* oxs, const void* active, void* mask, void* flow,
    int b, int h, int w, int wh, int ww, int sb, int sr, void* stream) {
  const long long n = (long long)b * h * w;
  if (n == 0) return 0;
  Frame f;
  f.mask_win = (const uint8_t*)mask_win;
  f.dx = (const float*)dx;
  f.dy = (const float*)dy;
  f.box = (const int32_t*)box;
  f.oys = (const int32_t*)oys;
  f.oxs = (const int32_t*)oxs;
  f.active = (const uint8_t*)active;
  f.n = n;
  f.hw = (long long)h * w;
  f.b = b;
  f.h = h;
  f.w = w;
  f.wh = wh;
  f.ww = ww;
  f.sb = sb;
  f.sr = sr;
  f.hw_div = make_div((unsigned)f.hw);
  f.w_div = make_div((unsigned)w);
  const long long tiles = (n + kTile - 1) / kTile;
  scatter_window_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      f, (uint8_t*)mask, (float*)flow);
  return (int)cudaGetLastError();
}
