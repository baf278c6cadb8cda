// Kernels B3 (segment motion compensation), B2 (per-cell PU index paint)
// and B5 (residual band stripes).
//
// Replace the TPU kernels of libde265_tpu/ops/mc_pallas.py: mc_stripes
// (_mc_kernel), paint_pu_idx (_paint_kernel) and residual_stripes
// (_res_kernel).  A segment is one inter PU cut to one band of four luma
// rows (OR rows of its plane): one motion vector, one reference slot, one
// filter phase.  The feed ships each segment's PU index, two 16-bit
// indices per int32 word; the window origin, phases and placement are
// re-derived here from the 5-word wire PU record [Pcap, 5] (mv0, mv1,
// meta, slice, geo), as mc_pallas.seg_params does, origin clamps included.
// The TPU kernels fold the PU table for Mosaic's scalar-memory tiling and
// move windows with aligned DMAs and roll ladders; here a thread reads the
// words and samples it needs at their addresses.
//
// Disjoint writes: the segments of one band, of one list, come from
// distinct PUs, and PUs partition the picture, so no two segments of a
// band write the same lane; the residual segments of one band come from
// distinct TUs, which partition the picture too.  Many CTAs therefore
// write one band's stripe without atomics.  Index words beyond
// nseg[band] are padding (PU 0) and are never read.
//
// What bounds them on the card: B3 reads each segment's window (at most
// 11 x 71 luma samples for 4 x 64 outputs) and does 2 x T multiply-adds a
// sample, ~4 integer operations a byte, so it is bound by the bytes of
// the windows (and below 1 ms at 1080p by launch and tail latency); B2 and
// B5 move a few bytes per output and are bound by memory.  B3's first
// design gave each segment slot of a (watermark x bands) grid one
// 128-thread CTA, and every output re-read its T samples through L1; here
// a warp does a segment, from a window staged in shared memory.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kQpel[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                {-1, 4, -10, 58, 17, -5, 1, 0},
                                {-1, 4, -11, 40, 40, -11, 4, -1},
                                {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kEpel[8][4] = {{0, 64, 0, 0},    {-2, 58, 10, -2},
                                {-4, 54, 16, -2}, {-6, 46, 28, -4},
                                {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                {-2, 16, 54, -4}, {-2, 10, 58, -2}};

constexpr int kPadL = 128;  // ops/mc_seg.py PADL
constexpr int kPadT = 16;   // ops/mc_seg.py PADT
constexpr int kWMax = 64;   // widest segment (a 64-wide luma PU)
constexpr int kORMax = 4;   // output rows of a band (luma 4, chroma 4/sub_y)
constexpr int kWinCols = kWMax + 7;  // w + T - 1 columns of a window row
constexpr int kMcWarps = 8;        // B3: warps of a CTA
constexpr int kMcSegsPerWarp = 2;  // B3: segments a warp takes in turn

__device__ __forceinline__ int wrap16(int v) {
  return ((v + 32768) & 0xFFFF) - 32768;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int pu_index(const int32_t* words, int k) {
  return (words[k >> 1] >> ((k & 1) * 16)) & 0xFFFF;
}

// One segment of B3 on one warp: its (OR+T-1) x (ws+T-1) reference window
// from the ring into `win` by asynchronous copies (lanes on consecutive
// columns, coalesced; ring rows and columns clamped), the horizontal pass
// from the window to int16 rows in `th` (>> bd-8, int16 wrap), the
// vertical pass from those to the band's stripe (>> 6, int16 wrap): the
// filter-always formulation of mc_pallas (phase 0 is the copy row).
// Segments wider than the plain version's window (64 luma columns, 64 /
// sub_x chroma ones; no PU is) are cut to it, as there.
template <int T>
__device__ __forceinline__ void mc_segment(
    const int32_t* __restrict__ refs, long long ref_rows, int ref_cols,
    int mvw, int meta, int geo, int band, int32_t* __restrict__ out,
    int wout, int list_idx, int OR, int hpad, int bd, int chroma, int hdim,
    int wdim, int sub_x, int sub_y, int32_t* win, int16_t* th, int lane) {
  const int mvx = (int)(int16_t)(mvw & 0xFFFF);
  const int mvy = mvw >> 16;
  const int slot = (meta >> (2 + 6 * list_idx)) & 63;
  const int x = (geo & 0x7FF) * 4;
  const int w = (((geo >> 22) & 0x1F) + 1) * 4;
  int oy, ox, fy, fx, xs, ws;
  if (!chroma) {
    oy = clampi(4 * band + (mvy >> 2) - 3, -(4 + T - 2), hdim - 1) + kPadT;
    ox = clampi(x + (mvx >> 2) - 3, -(w + T - 2), wdim - 1) + kPadL;
    fy = mvy & 3;
    fx = mvx & 3;
    xs = x;
    ws = w;
  } else {
    const int shx = sub_x == 2 ? 3 : 2, shy = sub_y == 2 ? 3 : 2;
    fx = sub_x == 2 ? (mvx & 7) : ((mvx & 3) << 1);
    fy = sub_y == 2 ? (mvy & 7) : ((mvy & 3) << 1);
    const int cw = w / sub_x;
    oy = clampi((4 / sub_y) * band + (mvy >> shy) - 1,
                -((4 / sub_y) + T - 2), hdim - 1) + kPadT;
    ox = clampi(x / sub_x + (mvx >> shx) - 1, -(cw + T - 2), wdim - 1) +
         kPadL;
    xs = x / sub_x;
    ws = cw;
  }
  ws = min(ws, chroma ? kWMax / sub_x : kWMax);
  const long long row0 = (long long)slot * hpad + oy;
  const int* fh = T == 8 ? kQpel[fx] : kEpel[fx];
  const int* fv = T == 8 ? kQpel[fy] : kEpel[fy];
  const int nrows = OR + T - 1, ncols = ws + T - 1;

  // each pass: the lanes split into groups of a power of two of lanes, one
  // row a group (lg2 lanes a row, 32 >> lg2 rows a pass; no division)
  int lg2 = min(5, 32 - __clz(ncols - 1));
  for (int r = lane >> lg2; r < nrows; r += 32 >> lg2) {
    const int32_t* src =
        refs + min(max(row0 + r, 0LL), ref_rows - 1) * ref_cols;
    for (int c = lane & ((1 << lg2) - 1); c < ncols; c += 1 << lg2)
      __pipeline_memcpy_async(win + r * kWinCols + c,
                              src + clampi(ox + c, 0, ref_cols - 1), 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  const int shift1 = bd - 8;
  lg2 = min(5, 32 - __clz(ws - 1));
  const int jm = (1 << lg2) - 1;
  for (int r = lane >> lg2; r < nrows; r += 32 >> lg2) {
    for (int j = lane & jm; j < ws; j += jm + 1) {
      const int32_t* src = win + r * kWinCols + j;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < T; t++) acc += fh[t] * src[t];
      th[r * kWMax + j] = (int16_t)wrap16(acc >> shift1);
    }
  }
  __syncwarp();
  for (int r = lane >> lg2; r < OR; r += 32 >> lg2) {
    int32_t* dst = out + ((long long)band * OR + r) * wout + xs;
    for (int j = lane & jm; j < ws; j += jm + 1) {
      int acc = 0;
#pragma unroll
      for (int t = 0; t < T; t++) acc += fv[t] * th[(r + t) * kWMax + j];
      dst[j] = wrap16(acc >> 6);
    }
  }
  __syncwarp();  // the window and rows are reused by the warp's next segment
}

// B3: a (band, group) grid of kMcWarps-warp CTAs; warp w of group g takes
// the band's segments (g * kMcWarps + w) * kMcSegsPerWarp onwards,
// kMcSegsPerWarp of them, one after another (a warp past nseg[band]
// returns at once).  The warp reads its segments' PU words first, one
// segment a lane, and hands them out by shuffles.
template <int T>
__global__ void __launch_bounds__(kMcWarps * 32)
mc_kernel(const int32_t* __restrict__ refs, long long ref_rows, int ref_cols,
          const int32_t* __restrict__ nseg, const int32_t* __restrict__ sidx,
          int kp, int kmax, const int32_t* __restrict__ pu, int pcap,
          int32_t* __restrict__ out, int wout, int list_idx, int OR,
          int hpad, int bd, int chroma, int hdim, int wdim, int sub_x,
          int sub_y) {
  constexpr int kRows = kORMax + T - 1;
  __shared__ __align__(16) int32_t win_all[kMcWarps][kRows * kWinCols];
  __shared__ int16_t th_all[kMcWarps][kRows * kWMax];
  const int band = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(nseg[band], kmax);
  const int k0 = (blockIdx.y * kMcWarps + warp) * kMcSegsPerWarp;
  if (k0 >= n) return;
  const int cnt = min(kMcSegsPerWarp, n - k0);
  int mvw = 0, meta = 0, geo = 0;
  if (lane < cnt) {
    const int32_t* p =
        pu + (long long)min(pu_index(sidx + (long long)band * kp, k0 + lane),
                            pcap - 1) * 5;
    mvw = p[list_idx];
    meta = p[2];
    geo = p[4];
  }
  for (int q = 0; q < cnt; ++q)
    mc_segment<T>(refs, ref_rows, ref_cols, __shfl_sync(0xffffffffu, mvw, q),
                  __shfl_sync(0xffffffffu, meta, q),
                  __shfl_sync(0xffffffffu, geo, q), band, out, wout,
                  list_idx, OR, hpad, bd, chroma, hdim, wdim, sub_x, sub_y,
                  win_all[warp], th_all[warp], lane);
}

// B2: one thread per (band, 4-pixel column); list 0's segments, then list
// 1's, in order; the last that covers the column wins, -1 where none does.
__global__ void paint_kernel(const int32_t* __restrict__ nseg2,
                             const int32_t* __restrict__ sidx2, int kp,
                             const int32_t* __restrict__ pu, int pcap,
                             int32_t* __restrict__ out, int n_bands, int w4,
                             int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_bands * w4) return;
  const int band = (int)(i / w4), col = (int)(i - (long long)band * w4);
  int v = -1;
  for (int l = 0; l < L; l++) {
    const int32_t* words = sidx2 + ((long long)band * L + l) * kp;
    const int n = min(nseg2[(long long)l * n_bands + band], 2 * kp);
    for (int k = 0; k < n; k++) {
      const int idx = pu_index(words, k);
      const int geo = pu[(long long)min(idx, pcap - 1) * 5 + 4];
      const int x4 = geo & 0x7FF, wd4 = ((geo >> 22) & 0x1F) + 1;
      if (col >= x4 && col < x4 + wd4) v = idx;
    }
  }
  out[i] = v;
}

// B5: one CTA per (segment k, band), one thread per (row, column) of the
// segment's OR x S slice.  Word w: srow = w & 0xFFFFF, xs = ((w >> 20) &
// 0xFFF) * 2; slice srow is rows (srow % per) * OR .. + OR of residual
// block srow / per (per = S / OR).
__global__ void residual_kernel(const int32_t* __restrict__ res, int N, int S,
                                const int32_t* __restrict__ nseg,
                                const int32_t* __restrict__ sw, int K,
                                int32_t* __restrict__ out, int OR, int wout) {
  const int k = blockIdx.x, band = blockIdx.y;
  if (k >= nseg[band]) return;
  const int w = sw[(long long)band * K + k];
  const int srow = w & 0xFFFFF, xs = ((w >> 20) & 0xFFF) * 2;
  const int per = S / OR, t = srow / per, r0 = (srow - t * per) * OR;
  for (int i = threadIdx.x; i < OR * S; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    const int v = t < N ? res[((long long)t * S + r0 + r) * S + c] : 0;
    out[((long long)band * OR + r) * wout + xs + c] = v;
  }
}

}  // namespace

extern "C" int tde_mc_stripes(const void* refs, long long ref_rows,
                              int ref_cols, const void* nseg,
                              const void* sidx, int kp, int kmax,
                              const void* pu, int pcap, void* out,
                              int n_bands, int wout, int list_idx, int OR,
                              int T, int hpad, int bd, int chroma, int hdim,
                              int wdim, int sub_x, int sub_y, void* stream) {
  if (n_bands <= 0 || kmax <= 0) return 0;
  if (OR <= 0 || OR > kORMax || (T != 4 && T != 8)) return -1;
  if (chroma && (sub_x < 1 || sub_x > 2)) return -1;
  auto kernel = T == 8 ? mc_kernel<8> : mc_kernel<4>;
  constexpr int per_cta = kMcWarps * kMcSegsPerWarp;
  const dim3 grid((unsigned)n_bands,
                  (unsigned)((kmax + per_cta - 1) / per_cta));
  kernel<<<grid, kMcWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)refs, ref_rows, ref_cols, (const int32_t*)nseg,
      (const int32_t*)sidx, kp, kmax, (const int32_t*)pu, pcap,
      (int32_t*)out, wout, list_idx, OR, hpad, bd, chroma, hdim, wdim, sub_x,
      sub_y);
  return (int)cudaGetLastError();
}

extern "C" int tde_paint_pu_idx(const void* nseg2, const void* sidx2, int kp,
                                const void* pu, int pcap, void* out,
                                int n_bands, int w4, int L, void* stream) {
  const long long n = (long long)n_bands * w4;
  if (n <= 0) return 0;
  const int threads = 256;
  paint_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(
      (const int32_t*)nseg2, (const int32_t*)sidx2, kp, (const int32_t*)pu,
      pcap, (int32_t*)out, n_bands, w4, L);
  return (int)cudaGetLastError();
}

extern "C" int tde_residual_stripes(const void* res, int N, int S,
                                    const void* nseg, const void* sw, int K,
                                    void* out, int n_bands, int OR, int wout,
                                    void* stream) {
  if (n_bands <= 0 || K <= 0) return 0;
  dim3 grid((unsigned)K, (unsigned)n_bands);
  residual_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)res, N, S, (const int32_t*)nseg, (const int32_t*)sw, K,
      (int32_t*)out, OR, wout);
  return (int)cudaGetLastError();
}
