// K10: the seg head of the main path on bit-packed rows: threshold |flow|²
// inside the box, then N × (dilate ∘ erode) under the structuring element
// (SE), re-masked to the box, and the {0, 255} uint8 mask.
//
// Replaces no TPU kernel: the JAX package's head is plain XLA
// (nsof_tpu/ops/morphology_fast.py::dilate_erode_n_masked_hwb, called from
// nsof_tpu/pipelines/segmentation.py::_seg_head_mag2_hwb), 32 columns to a
// uint32 word.  The port's plain version, ops/morphology_fast.py::
// seg_head_plain, runs one boolean tensor operation at a time; this kernel
// computes the same bits:
//
//   x = (dx·dx + dy·dy > th2) ∧ ib
//   repeat N:  x = OR_SE(x ∧ ib);  x = ¬OR_SE(¬x ∧ ib)
//   out = (x ∧ ib) ? 255 : 0
//
// where OR_SE(v)(y, c) = OR over the SE's taps (dy, dc) of v(y + dy, c + dc),
// the taps relative to the anchor (ksize // 2) and not reflected, False
// outside the frame.  |flow|² is rounded as the plain version rounds it: two
// products and a sum, each rounded once (__fmul_rn, __fadd_rn; nothing
// contracts to an FMA), compared with th2 in float32 as PyTorch compares a
// float32 tensor with a Python number.
//
// Bound: bytes.  The head must read dx and dy (float32) and the box mask
// (one byte) and write the mask (one byte), 10 bytes a pixel: 20.7 MB a
// 1920×1080 pair, 6.2 µs at 3.35 TB/s.  The arithmetic is a few bit
// operations a word.  Design: move few bytes beyond those.
// - Pack pass (one launch): a warp a row reads dx, dy and the box mask once,
//   coalesced, and packs x ∧ ib and ib 32 columns to a word with
//   __ballot_sync (bit j of word i is column 32 i + j); dx and dy are read
//   only where the box mask is set.  A packed plane is B·H·⌈W/32⌉ words
//   (33 MB for 128 pairs at 1920×1080), much of it held by the 50 MB L2.
// - One launch a (dilate, erode) pair.  A block stages a tile of packed rows
//   with a halo of twice the SE's reach in shared memory, dilates the tile
//   plus one reach, then erodes the tile.  A row run (left, right) of the SE
//   is a 64-bit window of three neighbouring words (funnel shifts) OR-ed
//   over its rows' dys first and widened by shift doubling once; the runs'
//   results are OR-ed.  The last launch ANDs with ib and writes the uint8
//   mask, a warp a row, coalesced.
// - Launches a call: 1 + N (1 + 1 for N = 0).  Scratch: three packed planes
//   (x twice, ping-pong, and ib), from the wrapper.
// Outside the frame every OR term is False (rows: zero words staged;
// columns: zero words beside a row; the tail bits of a row's last word are
// 0 in ib, so in x ∧ ib and ¬x ∧ ib too); so erosion counts outside as set,
// as the plain version's False-filled shifts do.
//
// Limits (the wrapper checks them first): an SE of at most kMaxKsize rows
// and columns, each non-empty row one solid run, so every tap lies within
// ±15 of the anchor and a run's window fits in 64 bits; rows of at most
// kMaxWords words (8,192 columns), so a tile of 8 rows fits in a block's
// shared memory at the widest SE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKsize = 31;      // SE rows and columns
constexpr int kMaxReach = kMaxKsize / 2;
constexpr int kMaxWords = 256;     // packed words a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;      // rows a morphology block writes, at most
constexpr int kSmallSmem = 48 * 1024;
constexpr int kPackWords = 8;    // words a pack-pass lane loads at once

// The SE as distinct row runs: run g covers columns left[g] .. right[g] of
// the rows dys[first[g] .. first[g] + count[g]).
struct SeTable {
  int n_runs;
  int left[kMaxKsize];
  int right[kMaxKsize];
  int first[kMaxKsize];
  int count[kMaxKsize];
  int dys[kMaxKsize];
};

__global__ void __launch_bounds__(kThreads) seg_head_pack_kernel(
    const float* __restrict__ dx, const float* __restrict__ dy,
    const uint8_t* __restrict__ inbox, uint32_t* __restrict__ xw,
    uint32_t* __restrict__ ibw, int n_rows, int h, int w, int nw,
    int sb, int sh, int sw, float th2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const int b = row / h;
  const int y = row - b * h;
  const long long fbase = (long long)b * sb + (long long)y * sh;
  const uint8_t* ibrow = inbox + (long long)row * w;
  for (int base = 0; base < nw; base += 32) {
    const int n = min(32, nw - base);
    uint32_t mx = 0u, mi = 0u;
    // kPackWords words at a time: their box bytes, then the flow where the
    // box is set, then the ballots, so each lane has several loads in flight
    for (int j0 = 0; j0 < n; j0 += kPackWords) {
      bool in[kPackWords];
      float fx[kPackWords], fy[kPackWords];
#pragma unroll
      for (int u = 0; u < kPackWords; ++u) {
        const int c = (base + j0 + u) * 32 + lane;
        in[u] = j0 + u < n && c < w && ibrow[c] != 0;
      }
#pragma unroll
      for (int u = 0; u < kPackWords; ++u) {
        fx[u] = 0.0f;
        fy[u] = 0.0f;
        if (in[u]) {
          const long long o = fbase + (long long)((base + j0 + u) * 32 + lane) * sw;
          fx[u] = dx[o];
          fy[u] = dy[o];
        }
      }
#pragma unroll
      for (int u = 0; u < kPackWords; ++u) {
        const bool hit =
            in[u] && __fadd_rn(__fmul_rn(fx[u], fx[u]), __fmul_rn(fy[u], fy[u])) > th2;
        const uint32_t bx = __ballot_sync(0xffffffffu, hit);
        const uint32_t bi = __ballot_sync(0xffffffffu, in[u]);
        if (lane == j0 + u) {
          mx = bx;
          mi = bi;
        }
      }
    }
    if (lane < n) {
      xw[(long long)row * nw + base + lane] = mx;
      ibw[(long long)row * nw + base + lane] = mi;
    }
  }
}

// Bits 32 i + left .. 32 i + left + 63 of a packed row (words i - 1, i and
// i + 1; zero beyond the row), left in [-32, 31].
__device__ __forceinline__ unsigned long long window64(const uint32_t* row, int i,
                                                       int nw, int left) {
  const uint32_t a = i > 0 ? row[i - 1] : 0u;
  const uint32_t b = row[i];
  const uint32_t c = i + 1 < nw ? row[i + 1] : 0u;
  const int s = 32 + left;
  uint32_t lo, hi;
  if (s < 32) {
    lo = __funnelshift_r(a, b, s);
    hi = __funnelshift_r(b, c, s);
  } else {
    lo = __funnelshift_r(b, c, s - 32);
    hi = c >> (s - 32);
  }
  return ((unsigned long long)hi << 32) | lo;
}

// OR_SE of the staged plane p at its row r, word i: per run, the OR of its
// rows' windows, widened once to the run's length by shift doubling.
__device__ __forceinline__ uint32_t or_over_se(const uint32_t* p, int r, int i, int nw,
                                               const SeTable& se) {
  uint32_t acc = 0u;
  for (int g = 0; g < se.n_runs; ++g) {
    const int left = se.left[g];
    const int k = se.right[g] - left + 1;
    unsigned long long u = 0ull;
    for (int t = se.first[g]; t < se.first[g] + se.count[g]; ++t)
      u |= window64(p + (r + se.dys[t]) * nw, i, nw, left);
    int span = 1;
    while (2 * span <= k) {
      u |= u >> span;
      span *= 2;
    }
    if (span < k) u |= u >> (k - span);
    acc |= (uint32_t)u;
  }
  return acc;
}

// One (dilate, erode) pair on a tile of rows, or with morph == 0 only the
// final masking.  Shared memory: xs and ibs, rows y0 - 2 reach ..
// y0 + tile + 2 reach; ds (¬dilate ∧ ib), rows y0 - reach .. y0 + tile + reach.
__global__ void __launch_bounds__(kThreads) seg_head_morph_kernel(
    const uint32_t* __restrict__ xin, const uint32_t* __restrict__ ibw,
    uint32_t* __restrict__ xout, uint8_t* __restrict__ out, SeTable se_arg,
    int h, int w, int nw, int tile, int tiles, int reach, int morph, int last) {
  extern __shared__ uint32_t smem[];
  __shared__ SeTable se;
  if (threadIdx.x == 0) se = se_arg;
  const int b = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - b * tiles) * tile;
  const int rows = min(tile, h - y0);
  const int halo = 2 * reach;
  const int nx = tile + 2 * halo;
  uint32_t* xs = smem;
  uint32_t* ibs = xs + nx * nw;
  uint32_t* ds = ibs + nx * nw;
  const long long plane = (long long)b * h * nw;

  for (int k = threadIdx.x; k < (rows + 2 * halo) * nw; k += kThreads) {
    const int r = k / nw;
    const int y = y0 - halo + r;
    uint32_t xv = 0u, iv = 0u;
    if (y >= 0 && y < h) {
      const long long o = plane + (long long)y * nw + (k - r * nw);
      iv = ibw[o];
      xv = xin[o] & iv;
    }
    xs[k] = xv;
    ibs[k] = iv;
  }
  __syncthreads();

  // the tile's result, x ∧ ib where it ends the head, into es (over xs)
  uint32_t* es = xs;
  if (morph) {
    for (int k = threadIdx.x; k < (rows + 2 * reach) * nw; k += kThreads) {
      const int r = k / nw;
      const int i = k - r * nw;
      ds[k] = ~or_over_se(xs, r + reach, i, nw, se) & ibs[(r + reach) * nw + i];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < rows * nw; k += kThreads) {
      const int r = k / nw;
      const int i = k - r * nw;
      const uint32_t e = ~or_over_se(ds, r + reach, i, nw, se);
      if (last)
        es[k] = e & ibs[(r + halo) * nw + i];
      else
        xout[plane + (long long)(y0 + r) * nw + i] = e;
    }
    if (!last) return;
    __syncthreads();
  } else {
    es = xs + halo * nw;  // x ∧ ib as staged (reach is 0)
  }

  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const uint32_t* er = es + r * nw;
    uint8_t* orow = out + ((long long)b * h + y0 + r) * w;
    for (int c = threadIdx.x & 31; c < w; c += 32)
      orow[c] = ((er[c >> 5] >> (c & 31)) & 1u) ? 255 : 0;
  }
}

}  // namespace

// dx, dy: float32 [B, H, W] at element strides (sb, sh, sw), the same for
// both; inbox: bool [B, H, W] contiguous; table: host int32 [n_runs,
// n_rows, (left, right, count) a run, then the runs' dys in run order];
// scratch: 3 · B · H · ⌈W/32⌉ uint32 words; out: uint8 [B, H, W].
// Returns a cudaError_t (cudaErrorInvalidValue for a table or a width
// beyond the limits).
extern "C" int nsof_seg_head(
    const void* dx, const void* dy, const void* inbox, const void* table,
    void* scratch, void* out, int b, int h, int w, int sb, int sh, int sw,
    int iters, float th2, void* stream) {
  if (b == 0 || h == 0 || w == 0) return 0;
  const int nw = (w + 31) / 32;
  if (nw > kMaxWords || iters < 0) return (int)cudaErrorInvalidValue;
  const int* t = (const int*)table;
  SeTable se = {};
  se.n_runs = t[0];
  const int n_se_rows = t[1];
  if (se.n_runs < 1 || se.n_runs > kMaxKsize || n_se_rows < se.n_runs ||
      n_se_rows > kMaxKsize)
    return (int)cudaErrorInvalidValue;
  int reach = 0;
  int first = 0;
  for (int g = 0; g < se.n_runs; ++g) {
    se.left[g] = t[2 + 3 * g];
    se.right[g] = t[3 + 3 * g];
    se.count[g] = t[4 + 3 * g];
    se.first[g] = first;
    first += se.count[g];
    if (se.left[g] < -kMaxReach || se.right[g] > kMaxReach || se.left[g] > se.right[g] ||
        se.count[g] < 1)
      return (int)cudaErrorInvalidValue;
  }
  if (first != n_se_rows) return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_se_rows; ++q) {
    const int d = t[2 + 3 * se.n_runs + q];
    if (d < -kMaxReach || d > kMaxReach) return (int)cudaErrorInvalidValue;
    se.dys[q] = d;
    reach = max(reach, d < 0 ? -d : d);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const long long words = (long long)b * h * nw;
  uint32_t* xa = (uint32_t*)scratch;
  uint32_t* xb = xa + words;
  uint32_t* ibw = xb + words;

  const int n_rows = b * h;
  seg_head_pack_kernel<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const float*)dx, (const float*)dy, (const uint8_t*)inbox, xa, ibw, n_rows, h, w,
      nw, sb, sh, sw, th2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int morph = iters > 0;
  if (!morph) reach = 0;
  // the largest tile of at most kTileRows rows whose planes (and the
  // static SE table) fit in 48 KB, else 8 rows in opted-in shared memory
  int tile = kTileRows;
  auto smem_bytes = [&](int rows) {
    return (size_t)nw * 4 * (2 * (rows + 4 * reach) + (rows + 2 * reach));
  };
  while (tile > 8 && smem_bytes(tile) + sizeof(SeTable) > kSmallSmem) tile /= 2;
  const size_t smem = smem_bytes(tile);
  if (smem + sizeof(SeTable) > kSmallSmem) {
    err = cudaFuncSetAttribute(seg_head_morph_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (h + tile - 1) / tile;
  const int passes = morph ? iters : 1;
  uint32_t* src = xa;
  uint32_t* dst = xb;
  for (int p = 0; p < passes; ++p) {
    seg_head_morph_kernel<<<b * tiles, kThreads, smem, st>>>(
        src, ibw, dst, (uint8_t*)out, se, h, w, nw, tile, tiles, reach, morph,
        p == passes - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  return 0;
}
