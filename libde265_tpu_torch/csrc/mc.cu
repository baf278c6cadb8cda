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
// distinct TUs, which partition the picture too.  B3's CTAs therefore
// write one band's stripe without atomics.  Index words beyond
// nseg[band] are padding (PU 0) and are never read.
//
// What bounds them on the card: B3 reads each segment's window (at most
// 11 x 71 luma samples for 4 x 64 outputs) and does 2 x T multiply-adds a
// sample, ~4 integer operations a byte, so it is bound by the bytes of
// the windows (and below 1 ms at 1080p by launch and tail latency); B2 and
// B5 move a few bytes per output and are bound by memory (B2's bytes at
// 1080p, about 1 MB, take less time than one launch).  B3's first design
// gave each segment slot of a (watermark x bands) grid one 128-thread CTA,
// and every output re-read its T samples through L1; here a warp does a
// segment, from a window staged in shared memory.  B5's grid follows its
// output, so each lane is written once and the output needs no fill; B2
// reads each segment's PU word once per band (a thread per segment), not
// once per column.
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
constexpr int kPaintThreads = 128;  // B2: threads of a CTA (one band)
constexpr int kResTile = 1024;      // B5: stripe lanes of a CTA
constexpr int kResThreads = kResTile / 4;  // B5: four lanes a thread

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

// B2: one CTA per band, its row of W4 cells in shared memory.  A thread
// takes a segment (list 0's in order, then list 1's), reads its PU index
// and geo word once, and paints the segment's columns [x4, x4 + w4) cut to
// [0, W4) with the segment's ordinal l * 2*kp + k in the high half and its
// PU index in the low half, by a shared-memory atomicMax: the highest
// ordinal that covers a cell wins, as the last covering segment does in
// the plain version (which matters only where segments overlap; a
// picture's do not).  The row then goes out coalesced, -1 where no
// segment painted.  The wrapper keeps L * 2*kp <= 32768 so an ordinal
// fits in 15 bits.
__global__ void __launch_bounds__(kPaintThreads)
paint_kernel(const int32_t* __restrict__ nseg2,
             const int32_t* __restrict__ sidx2, int kp,
             const int32_t* __restrict__ pu, int pcap,
             int32_t* __restrict__ out, int n_bands, int w4, int L) {
  extern __shared__ int row[];
  const int band = blockIdx.x;
  for (int c = threadIdx.x; c < w4; c += kPaintThreads) row[c] = -1;
  __syncthreads();
  for (int l = 0; l < L; l++) {
    const int32_t* words = sidx2 + ((long long)band * L + l) * kp;
    const int n = min(nseg2[(long long)l * n_bands + band], 2 * kp);
    for (int k = threadIdx.x; k < n; k += kPaintThreads) {
      const int idx = pu_index(words, k);
      const int geo = pu[(long long)min(idx, pcap - 1) * 5 + 4];
      const int x4 = geo & 0x7FF;
      const int end = min(x4 + ((geo >> 22) & 0x1F) + 1, w4);
      const int v = ((l * 2 * kp + k) << 16) | idx;
      for (int c = x4; c < end; c++) atomicMax(&row[c], v);
    }
  }
  __syncthreads();
  int32_t* dst = out + (long long)band * w4;
  for (int c = threadIdx.x; c < w4; c += kPaintThreads)
    dst[c] = row[c] < 0 ? -1 : (row[c] & 0xFFFF);
}

// B5: one CTA per (band, kResTile-lane tile of its stripe), one thread per
// four lanes.  Word w of a band: srow = w & 0xFFFFF, xs = ((w >> 20) &
// 0xFFF) * 2; slice srow is rows (srow % per) * OR .. + OR of residual
// block srow / per (per = S / OR), placed at lanes xs .. xs + S.  The CTA
// first maps each lane of its tile to the offset in `res` of row 0 of the
// slice that covers it (-1 where none does, or the block is past N: those
// lanes are 0), one thread per (segment, column) of the band's live
// segments; then every thread writes its four lanes of each of the OR rows
// once, with one 16-byte store (the wrapper keeps Wout a multiple of 4;
// the feed's is of 128).  Lanes past the plane's width up to Wout are
// written too, so the output needs no fill.  A band's segments are disjoint (distinct TUs); a segment whose
// lanes pass Wout is outside what the feed produces, and only its lanes
// inside the stripe are placed.  Words beyond min(nseg, K) are padding and
// are never read.
__global__ void __launch_bounds__(kResThreads)
residual_kernel(const int32_t* __restrict__ res, int N, int lg_s, int lg_or,
                const int32_t* __restrict__ nseg,
                const int32_t* __restrict__ sw, int K,
                int32_t* __restrict__ out, int wout) {
  __shared__ int src[kResTile];
  const int band = blockIdx.x, c0 = blockIdx.y * kResTile;
  const int S = 1 << lg_s, OR = 1 << lg_or, lg_per = lg_s - lg_or;
  const int lanes = min(kResTile, wout - c0);
  const int n = min(nseg[band], K);
  if (n > 0) {
    for (int c = threadIdx.x; c < lanes; c += kResThreads) src[c] = -1;
    __syncthreads();
    const int32_t* words = sw + (long long)band * K;
    for (int i = threadIdx.x; i < (n << lg_s); i += kResThreads) {
      const int w = words[i >> lg_s], j = i & (S - 1);
      const int srow = w & 0xFFFFF, t = srow >> lg_per;
      const int c = ((w >> 20) & 0xFFF) * 2 + j - c0;
      if (t < N && c >= 0 && c < lanes)
        src[c] = (((t << lg_s) + ((srow & ((1 << lg_per) - 1)) << lg_or))
                  << lg_s) + j;
    }
    __syncthreads();
  }
  const int c = threadIdx.x * 4;
  if (c >= lanes) return;
  int o[4];
#pragma unroll
  for (int q = 0; q < 4; q++) o[q] = n > 0 ? src[c + q] : -1;
  int32_t* dst = out + (long long)band * OR * wout + c0 + c;
  for (int r = 0; r < OR; r++, dst += wout) {
    int v[4];
#pragma unroll
    for (int q = 0; q < 4; q++) v[q] = o[q] >= 0 ? res[o[q] + (r << lg_s)] : 0;
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
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
  if (n_bands <= 0 || w4 <= 0) return 0;
  if (L <= 0 || pcap <= 0 || (long long)L * 2 * kp > 32768 ||
      w4 * (int)sizeof(int) > 48 * 1024)
    return -1;
  paint_kernel<<<(unsigned)n_bands, kPaintThreads, w4 * sizeof(int),
                 (cudaStream_t)stream>>>(
      (const int32_t*)nseg2, (const int32_t*)sidx2, kp, (const int32_t*)pu,
      pcap, (int32_t*)out, n_bands, w4, L);
  return (int)cudaGetLastError();
}

extern "C" int tde_residual_stripes(const void* res, int N, int S,
                                    const void* nseg, const void* sw, int K,
                                    void* out, int n_bands, int OR, int wout,
                                    void* stream) {
  if (n_bands <= 0 || wout <= 0) return 0;
  if ((S != 4 && S != 8 && S != 16 && S != 32) ||
      (OR != 1 && OR != 2 && OR != 4) || K < 0 || wout % 4)
    return -1;
  const int lg_s = __builtin_ctz((unsigned)S);
  const int lg_or = __builtin_ctz((unsigned)OR);
  const dim3 grid((unsigned)n_bands, (unsigned)((wout + kResTile - 1) /
                                                kResTile));
  residual_kernel<<<grid, kResThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)res, N, lg_s, lg_or, (const int32_t*)nseg,
      (const int32_t*)sw, K, (int32_t*)out, wout);
  return (int)cudaGetLastError();
}
