// Kernels B8 (luma) and B9 (chroma): HEVC deblocking of a picture, every
// vertical edge and then every horizontal edge of a plane class in one
// launch (spec 8.7.2, 8.7.2.5.3 - 8.7.2.5.7).
//
// Replace the TPU kernels libde265_tpu/ops/deblock_pallas.py:luma_pass /
// luma_pass_h (_luma_kernel, _luma_body) and chroma_pass_stacked /
// chroma_pass_stacked_h (_chroma_body), which filter one orientation of a
// zero-padded plane each.  Here one launch takes both orientations of the
// unpadded plane (both chroma channels in one launch, the channel a grid
// axis), reads every sample from device memory once and writes it once
// into a fresh output.  The per-orientation wrappers of the port reach the
// same kernels with the other orientation switched off.
//
// Why a tile is self-contained.  The spec filters all vertical edges of a
// picture before any horizontal edge.
//   * A vertical luma edge at x = 8e reads and writes only columns
//     [8e-4, 8e+4) of the rows of its 4-row segment, and takes its
//     decisions from rows 0 and 3 of that segment.
//   * A horizontal luma edge at y = 8e reads and writes only rows
//     [8e-4, 8e+4) of the columns of its 4-column segment.
//   * So the output at (r, c) depends only on inputs inside the tile whose
//     boundaries lie at 8k-4 in both axes: such a boundary never splits a
//     group [8e-4, 8e+4), and being a multiple of 4 it never splits a
//     4-sample segment either.
//   * Chroma edges touch [8e-2, 8e+2); its segments are 2 or 4 samples
//     (4 // sub).  Any boundary in [8e+2, 8e+6] keeps the groups whole;
//     the same 8k-4 grid is taken, which keeps 16-byte alignment.
// The kernel also serves the padded layouts of the per-orientation
// wrappers, where edge j lies at 8j + x0 (x0 = 4 luma, 2 chroma): the tile
// grid then follows x0 by the same rule (Tile below).
//
// Design: one CTA of NT threads per tile of TH x kTileW samples (clipped to
// the plane), for each channel:
//   1. load the tile, a warp of 16-byte loads along a row, each thread's
//      loads issued before their values go to shared memory;
//   2. __syncthreads(); vertical edges in shared memory, one thread per
//      (segment, edge);
//   3. __syncthreads(); horizontal edges, one thread per (segment, edge);
//   4. __syncthreads(); store the tile with 16-byte stores.
// A thread reads its unit's parameters (strided [segment, edge] arrays, as
// the edge-parameter derivation gives them; edges without a parameter,
// edge 0 among them, stay as they are).  Shared rows are int32 with one
// pad word after every 8 columns (an edge group is 8 contiguous words) and
// a row pitch of 148 words, so the vertical pass's warp (16 edges x 2
// segments) hits 32 distinct banks and the horizontal pass's at most two
// a bank.  The work is bound by device memory: one read and one write of
// every sample, plus the parameters.  TH and NT are template arguments
// (16 or 32 rows; 64, 128 or 256 threads), chosen per kernel by the
// wrapper from a sweep (PERF.md).
//
// The edge parameters of a picture (tde_deblock_params, below) come from
// one more launch: one thread per 4-sample segment of one luma edge,
// vertical and horizontal, derives bS (spec 8.7.2.4), beta and tc
// (8.7.2.5.3) and, on every chroma edge, both channels' tc (8.7.2.5.5)
// from the per-4x4 grids, the per-CTB slice and tile grids and the slice
// records, and writes them into one int32 arena that B8 and B9 read as
// strided views.  Nothing of it goes back to the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128;                      // a warp of int4 per row
constexpr int kPitch = kTileW + kTileW / 8 + 4;  // shared words per row

// Per-(segment, edge) parameter: element (s, j) at p[s * ss + j * se].
struct Prm {
  const int32_t* p;
  long long ss, se;
};

// The edges of one orientation.  Edge j (j < n) lies at column (vertical)
// or row (horizontal) 8j + x0; a segment spans per_seg samples along it.
// Luma prm: bs, beta, tc, no_p, no_q; chroma: tc of channel 0, tc of
// channel 1, no_p, no_q.
struct Edges {
  Prm prm[5];
  int n, nseg, x0, per_seg;
};

// One launch: nch planes (in[c], row pitch in_pitch[c]) of R x C samples;
// out holds nch contiguous R x C planes.
struct Args {
  const int32_t* in[2];
  long long in_pitch[2];
  int32_t* out;
  int R, C, nch;
  Edges v, h;
  int bit_depth, tile_h, threads;
};

// Tile (tx, ty) starts at column tx * kTileW - offx and row ty * TH - offy;
// an edge lies dv (dh) samples into its 8-sample block of the tile.
struct Tile {
  int offx, offy, dv, dh;
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int sidx(int r, int c) {
  return r * kPitch + c + (c >> 3);
}

__device__ __forceinline__ int ld(const Prm& p, int s, int j) {
  return __ldg(p.p + s * p.ss + j * p.se);
}

// Loads and stores of the tile: TH rows of kTileW / 4 int4 each, NT
// threads, a warp along a row (NT is a multiple of 32, so a thread keeps
// its column q = threadIdx.x % 32 and takes rows tid / 32 + k * NT / 32).
// kChunk loads are issued before their shared stores, so that many are in
// flight at once.
template <int TH, int NT>
__device__ __forceinline__ void load_tile(int32_t* s,
                                          const int32_t* __restrict__ in,
                                          long long pitch, int row0, int col0,
                                          int R, int C) {
  constexpr int kRows = NT / (kTileW / 4), kIters = TH / kRows;
  constexpr int kChunk = kIters < 8 ? kIters : 8;
  const int q = threadIdx.x % (kTileW / 4), r0 = threadIdx.x / (kTileW / 4);
  const int c = col0 + 4 * q;
  const bool col_ok = c >= 0 && c < C;
#pragma unroll
  for (int k0 = 0; k0 < kIters; k0 += kChunk) {
    int4 v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int r = row0 + r0 + (k0 + k) * kRows;
      if (col_ok && r >= 0 && r < R)
        v[k] = __ldg(reinterpret_cast<const int4*>(in + r * pitch + c));
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int lr = r0 + (k0 + k) * kRows, r = row0 + lr;
      if (col_ok && r >= 0 && r < R) {
        int32_t* d = s + sidx(lr, 4 * q);  // 4q..4q+3 share an 8-block
        d[0] = v[k].x;
        d[1] = v[k].y;
        d[2] = v[k].z;
        d[3] = v[k].w;
      }
    }
  }
}

template <int TH, int NT>
__device__ __forceinline__ void store_tile(const int32_t* s,
                                           int32_t* __restrict__ out,
                                           int row0, int col0, int R, int C) {
  constexpr int kRows = NT / (kTileW / 4), kIters = TH / kRows;
  const int q = threadIdx.x % (kTileW / 4), r0 = threadIdx.x / (kTileW / 4);
  const int c = col0 + 4 * q;
  if (c < 0 || c >= C) return;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int lr = r0 + k * kRows, r = row0 + lr;
    if (r >= 0 && r < R) {
      const int32_t* d = s + sidx(lr, 4 * q);
      *reinterpret_cast<int4*>(out + (long long)r * C + c) =
          make_int4(d[0], d[1], d[2], d[3]);
    }
  }
}

// One luma segment: v[k] = p3 p2 p1 p0 q0 q1 q2 q3 of line k, filtered in
// place; false when the decisions leave it as it is.
__device__ __forceinline__ bool luma_segment(int v[4][8], int bt, int t,
                                             bool do_p, bool do_q, int maxv) {
  const int dp0 = abs(v[0][1] - 2 * v[0][2] + v[0][3]);
  const int dp3 = abs(v[3][1] - 2 * v[3][2] + v[3][3]);
  const int dq0 = abs(v[0][6] - 2 * v[0][5] + v[0][4]);
  const int dq3 = abs(v[3][6] - 2 * v[3][5] + v[3][4]);
  const int dpq0 = dp0 + dq0;
  const int dpq3 = dp3 + dq3;
  if (!(dpq0 + dpq3 < bt)) return false;

  const int tc25 = (5 * t + 1) >> 1;
  const bool s0 =
      (2 * dpq0 < (bt >> 2)) &&
      (abs(v[0][0] - v[0][3]) + abs(v[0][4] - v[0][7]) < (bt >> 3)) &&
      (abs(v[0][3] - v[0][4]) < tc25);
  const bool s3 =
      (2 * dpq3 < (bt >> 2)) &&
      (abs(v[3][0] - v[3][3]) + abs(v[3][4] - v[3][7]) < (bt >> 3)) &&
      (abs(v[3][3] - v[3][4]) < tc25);
  const bool strong = s0 && s3;
  const int side = (bt + (bt >> 1)) >> 3;
  const bool dep = (dp0 + dp3) < side;
  const bool deq = (dq0 + dq3) < side;
  const int tc2 = t >> 1;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p3 = v[k][0], p2 = v[k][1], p1 = v[k][2], p0 = v[k][3];
    const int q0 = v[k][4], q1 = v[k][5], q2 = v[k][6], q3 = v[k][7];
    if (strong) {
      if (do_p) {
        v[k][3] = p0 + clip3(-2 * t, 2 * t,
            ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0);
        v[k][2] = p1 + clip3(-2 * t, 2 * t,
            ((p2 + p1 + p0 + q0 + 2) >> 2) - p1);
        v[k][1] = p2 + clip3(-2 * t, 2 * t,
            ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2);
      }
      if (do_q) {
        v[k][4] = q0 + clip3(-2 * t, 2 * t,
            ((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3) - q0);
        v[k][5] = q1 + clip3(-2 * t, 2 * t,
            ((q2 + q1 + q0 + p0 + 2) >> 2) - q1);
        v[k][6] = q2 + clip3(-2 * t, 2 * t,
            ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2);
      }
    } else {
      const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta0) < t * 10) {
        const int delta = clip3(-t, t, delta0);
        if (do_p) {
          v[k][3] = clip3(0, maxv, p0 + delta);
          if (dep)
            v[k][2] = clip3(0, maxv, p1 + clip3(-tc2, tc2,
                ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)));
        }
        if (do_q) {
          v[k][4] = clip3(0, maxv, q0 - delta);
          if (deq)
            v[k][5] = clip3(0, maxv, q1 + clip3(-tc2, tc2,
                ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)));
        }
      }
    }
  }
  return true;
}

// Unit u of one orientation (a segment and an edge of the tile): its first
// line a0 and the start x0 of its sample group, tile-local, and its
// segment g and edge j in the parameter arrays.  For a vertical pass a
// segment runs down the rows and an edge across the columns; a horizontal
// pass swaps the two axes.  Vertical units run along the edges of a row
// (consecutive lanes on consecutive groups), horizontal ones along the
// segments of an edge row.
struct Unit {
  int a0, x0, g, j;
};

template <int TH, bool kLuma, bool vertical>
__device__ __forceinline__ Unit unit_of(const Edges& E, int u, int row0,
                                        int col0, int d) {
  const int ps = E.per_seg;
  const int nseg_t = (vertical ? TH : kTileW) / ps;   // segments per tile
  const int nblk = (vertical ? kTileW : TH) / 8;      // edge blocks
  const int sl = vertical ? u / nblk : u % nseg_t;
  const int el = vertical ? u % nblk : u / nseg_t;
  Unit t;
  t.a0 = sl * ps;
  t.x0 = 8 * el + d - (kLuma ? 4 : 2);
  t.g = ((vertical ? row0 : col0) + t.a0) / ps;               // exact
  t.j = ((vertical ? col0 : row0) + 8 * el + d - E.x0) / 8;   // exact
  return t;
}

// The edges of one orientation over the tile in shared memory.  A thread
// takes a unit's parameters from device memory, all of them at once (one
// round trip), then its samples from the tile.
template <int TH, bool kLuma, bool vertical>
__device__ void filter_edges(int32_t* s, const Edges& E, int c, int row0,
                             int col0, int R, int C, int d, int maxv) {
  const int n_units = ((vertical ? TH : kTileW) / E.per_seg) *
                      ((vertical ? kTileW : TH) / 8);
  for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
    const Unit t = unit_of<TH, kLuma, vertical>(E, u, row0, col0, d);
    if (t.j < 0 || t.j >= E.n || t.g < 0 || t.g >= E.nseg) continue;
    const int a0 = t.a0, x0 = t.x0;
    // lines of the segment inside the plane
    const int left = (vertical ? R - row0 : C - col0) - a0;
    if (kLuma) {
      if (left < 4) continue;
      const int b = ld(E.prm[0], t.g, t.j), bt = ld(E.prm[1], t.g, t.j);
      const int tc = ld(E.prm[2], t.g, t.j);
      const bool do_p = ld(E.prm[3], t.g, t.j) == 0;
      const bool do_q = ld(E.prm[4], t.g, t.j) == 0;
      if (b <= 0) continue;
      int v[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 8; ++m)
          v[k][m] = s[vertical ? sidx(a0 + k, x0 + m) : sidx(x0 + m, a0 + k)];
      if (!luma_segment(v, bt, tc, do_p, do_q, maxv)) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 1; m < 7; ++m)
          s[vertical ? sidx(a0 + k, x0 + m) : sidx(x0 + m, a0 + k)] = v[k][m];
    } else {
      const int tc = ld(E.prm[c], t.g, t.j);
      const bool do_p = ld(E.prm[2], t.g, t.j) == 0;
      const bool do_q = ld(E.prm[3], t.g, t.j) == 0;
      if (tc <= 0) continue;
      for (int k = 0; k < E.per_seg && k < left; ++k) {
        int w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          w[m] = s[vertical ? sidx(a0 + k, x0 + m) : sidx(x0 + m, a0 + k)];
        const int delta =
            clip3(-tc, tc, ((w[2] - w[1]) * 4 + w[0] - w[3] + 4) >> 3);
        if (do_p)
          s[vertical ? sidx(a0 + k, x0 + 1) : sidx(x0 + 1, a0 + k)] =
              clip3(0, maxv, w[1] + delta);
        if (do_q)
          s[vertical ? sidx(a0 + k, x0 + 2) : sidx(x0 + 2, a0 + k)] =
              clip3(0, maxv, w[2] - delta);
      }
    }
  }
}

template <int TH, int NT, bool kLuma>
__global__ void __launch_bounds__(NT)
deblock_kernel(const Args a, const Tile t) {
  __shared__ int32_t s[TH * kPitch];
  const int c = blockIdx.z;
  const int col0 = blockIdx.x * kTileW - t.offx;
  const int row0 = blockIdx.y * TH - t.offy;
  const int maxv = (1 << a.bit_depth) - 1;
  load_tile<TH, NT>(s, a.in[c], a.in_pitch[c], row0, col0, a.R, a.C);
  __syncthreads();
  if (a.v.n > 0)
    filter_edges<TH, kLuma, true>(s, a.v, c, row0, col0, a.R, a.C, t.dv,
                                  maxv);
  __syncthreads();
  if (a.h.n > 0)
    filter_edges<TH, kLuma, false>(s, a.h, c, row0, col0, a.R, a.C, t.dh,
                                   maxv);
  __syncthreads();
  store_tile<TH, NT>(s, a.out + (long long)c * a.R * a.C, row0, col0, a.R,
                     a.C);
}

// Tile boundary residue (mod 8) for edges at 8j + x0: luma at x0 - 4 (the
// only boundary that keeps [x-4, x+4) whole), chroma at the multiple of 4
// in [x0 + 2, x0 + 6].
int boundary(int x0, bool luma) {
  return luma ? (x0 + 4) & 7 : ((x0 + 5) & ~3) & 7;
}

template <int TH, int NT, bool kLuma>
int run(const Args& a, const Tile& t, cudaStream_t st) {
  const dim3 grid((a.C + t.offx + kTileW - 1) / kTileW,
                  (a.R + t.offy + TH - 1) / TH, a.nch);
  deblock_kernel<TH, NT, kLuma><<<grid, NT, 0, st>>>(a, t);
  return (int)cudaGetLastError();
}

template <bool kLuma>
int launch(const Args* a, void* stream) {
  if (a->R <= 0 || a->C <= 0) return 0;
  if (a->nch < 1 || a->nch > 2) return (int)cudaErrorInvalidValue;
  const int rv = boundary(a->v.x0, kLuma), rh = boundary(a->h.x0, kLuma);
  const Tile t{(8 - rv) & 7, (8 - rh) & 7, (a->v.x0 - rv) & 7,
               (a->h.x0 - rh) & 7};
  cudaStream_t st = (cudaStream_t)stream;
  switch (a->tile_h * 1000 + a->threads) {
    case 16064: return run<16, 64, kLuma>(*a, t, st);
    case 16128: return run<16, 128, kLuma>(*a, t, st);
    case 16256: return run<16, 256, kLuma>(*a, t, st);
    case 32064: return run<32, 64, kLuma>(*a, t, st);
    case 32128: return run<32, 128, kLuma>(*a, t, st);
    case 32256: return run<32, 256, kLuma>(*a, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The edge parameters of a picture (replaces the PyTorch composition of
// ops/deblock_cuda.deblock_params_plain, the port of the JAX program's
// _edge_params_jnp, its gate() and its chroma tc).
// ---------------------------------------------------------------------------

__constant__ int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
    8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,  4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
__constant__ int kChromaQp[14] = {29, 30, 31, 32, 33, 33, 34,
                                  34, 35, 35, 36, 36, 37, 37};

constexpr int kNoRef = -1000000;   // the POC of a list a cell does not use
constexpr int kParamThreads = 256;

// One launch's inputs and outputs.  Per-4x4 grids: h4 x w4, row pitch w4
// (cu4 bit 0 intra; nzc4 bit 0; dbf4 bits 0-3 TU edge V, H, PU edge V, H;
// qp4; unfilt a byte, nonzero where the loop filters leave the samples;
// the cell grids pf, mv, poc as the PU gather gives them; allow_v / allow_h
// optional, null = every edge).  Per-CTB grids: row pitch ctb_w, a CTB of
// cs4 x cs4 cells.  Slice records: row pitch rec_pitch,
// columns 1 deblocking disabled, 2 beta offset, 3 tc offset, 9 filter
// across slices, 10 / 11 Cb / Cr QP offset.
struct ParamArgs {
  const int32_t *cu4, *nzc4, *dbf4, *qp4;
  const uint8_t* unfilt;
  const int32_t *pf, *mv[4], *poc[2];   // mv: 0x 0y 1x 1y
  const int32_t *allow_v, *allow_h;
  const int32_t *slice_idx, *slice_addr, *tile_id, *recs;
  long long rec_pitch;
  int ctb_w, cs4, n_slices, across_tiles;
  int h4, w4, bd, bdc, sub_x, sub_y, is420;
  // outputs: lv [5][h4][ev], lh [5][eh][w4] (bs, beta, tc, no_p, no_q);
  // cv [2][h4][ecv], ch [2][ech][w4] (tc of Cb, Cr); chroma ones only
  // where cv / ch are set
  int32_t *lv, *lh, *cv, *ch;
  int ev, eh, ecv, ech;
};

__device__ __forceinline__ bool far4(int ax, int ay, int bx, int by) {
  return abs(ax - bx) >= 4 || abs(ay - by) >= 4;
}

// bS of a P / Q cell pair that is neither intra nor a coded TU edge:
// the motion rule of spec 8.7.2.4.
__device__ __forceinline__ int motion_bs(const ParamArgs& a, int pi, int qi) {
  const int pfp = __ldg(a.pf + pi), pfq = __ldg(a.pf + qi);
  int rp[2], rq[2], mp[2][2], mq[2][2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const bool hp = (pfp >> l) & 1, hq = (pfq >> l) & 1;
    rp[l] = hp ? __ldg(a.poc[l] + pi) : kNoRef;
    rq[l] = hq ? __ldg(a.poc[l] + qi) : kNoRef;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mp[l][c] = hp ? __ldg(a.mv[2 * l + c] + pi) : 0;
      mq[l][c] = hq ? __ldg(a.mv[2 * l + c] + qi) : 0;
    }
  }
  const bool same = (rp[0] == rq[0] && rp[1] == rq[1]) ||
                    (rp[0] == rq[1] && rp[1] == rq[0]);
  if (!same) return 1;     // different reference pictures
  const bool straight = far4(mp[0][0], mp[0][1], mq[0][0], mq[0][1]) ||
                        far4(mp[1][0], mp[1][1], mq[1][0], mq[1][1]);
  const bool crossed = far4(mp[0][0], mp[0][1], mq[1][0], mq[1][1]) ||
                       far4(mp[1][0], mp[1][1], mq[0][0], mq[0][1]);
  if (rp[0] != rp[1]) return (rp[0] == rq[0] ? straight : crossed) ? 1 : 0;
  return (straight && crossed) ? 1 : 0;
}

// Threads [0, h4 * ev) take the vertical edges (segment row y, edge j at
// x = 8(j + 1): P cell column 2j + 1, Q cell 2j + 2), the rest the
// horizontal ones (edge i at y = 8(i + 1), segment column x).
__global__ void __launch_bounds__(kParamThreads)
deblock_params_kernel(const ParamArgs a) {
  const long long nv = (long long)a.h4 * a.ev;
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= nv + (long long)a.eh * a.w4) return;
  const bool vertical = u < nv;
  int e, s, qy, qx, py, px;     // edge, segment; Q and P cells
  if (vertical) {
    s = (int)(u / a.ev);
    e = (int)(u % a.ev);
    qy = py = s;
    qx = 2 * e + 2;
    px = qx - 1;
  } else {
    const long long k = u - nv;
    e = (int)(k / a.w4);
    s = (int)(k % a.w4);
    qx = px = s;
    qy = 2 * e + 2;
    py = qy - 1;
  }
  const int qi = qy * a.w4 + qx, pi = py * a.w4 + px;

  // the Q side's slice governs; an edge between slices or tiles is
  // filtered only where that slice and the picture allow it
  const int cq = (qy / a.cs4) * a.ctb_w + qx / a.cs4;
  const int cp = (py / a.cs4) * a.ctb_w + px / a.cs4;
  const int sl = min(max(__ldg(a.slice_idx + cq), 0), a.n_slices - 1);
  const int32_t* rec = a.recs + sl * a.rec_pitch;
  bool allow = (__ldg(a.slice_addr + cq) == __ldg(a.slice_addr + cp) ||
                __ldg(rec + 9) != 0) &&
               (a.across_tiles ||
                __ldg(a.tile_id + cq) == __ldg(a.tile_id + cp)) &&
               __ldg(rec + 1) == 0;
  const int32_t* mask = vertical ? a.allow_v : a.allow_h;
  if (mask != nullptr) allow = allow && __ldg(mask + qi) != 0;

  const int dbf = __ldg(a.dbf4 + qi);
  const bool tu = (dbf & (vertical ? 1 : 2)) != 0;
  const bool pu = (dbf & (vertical ? 4 : 8)) != 0;
  int bs = 0;
  if ((tu || pu) && allow) {
    if ((__ldg(a.cu4 + pi) & 1) || (__ldg(a.cu4 + qi) & 1))
      bs = 2;
    else if (tu && ((__ldg(a.nzc4 + pi) & 1) || (__ldg(a.nzc4 + qi) & 1)))
      bs = 1;
    else
      bs = motion_bs(a, pi, qi);
  }
  const int qp_l = (__ldg(a.qp4 + pi) + __ldg(a.qp4 + qi) + 1) >> 1;
  const int toff = __ldg(rec + 3);
  const int beta = kBeta[min(max(qp_l + __ldg(rec + 2), 0), 51)]
                   << (a.bd - 8);
  const int tc = kTc[min(max(qp_l + 2 * (bs - 1) + toff, 0), 53)]
                 << (a.bd - 8);

  const long long plane = vertical ? (long long)a.h4 * a.ev
                                   : (long long)a.eh * a.w4;
  const long long o = vertical ? (long long)s * a.ev + e
                               : (long long)e * a.w4 + s;
  int32_t* out = vertical ? a.lv : a.lh;
  out[o] = bs;
  out[plane + o] = beta;
  out[2 * plane + o] = tc;
  out[3 * plane + o] = a.unfilt[pi] != 0;
  out[4 * plane + o] = a.unfilt[qi] != 0;

  // chroma edge k lies on luma edge k * sub + sub - 1
  int32_t* cout = vertical ? a.cv : a.ch;
  const int sub = vertical ? a.sub_x : a.sub_y;
  if (cout == nullptr || e % sub != sub - 1) return;
  const int k = e / sub;
  const long long cplane = vertical ? (long long)a.h4 * a.ecv
                                    : (long long)a.ech * a.w4;
  const long long co = vertical ? (long long)s * a.ecv + k
                                : (long long)k * a.w4 + s;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int t = 0;
    if (bs == 2) {
      const int qpi = qp_l + __ldg(rec + 10 + c);
      const int qpc = !a.is420 ? min(max(qpi, 0), 51)
                      : qpi < 30 ? qpi
                      : qpi > 43 ? qpi - 6
                                 : kChromaQp[qpi - 30];
      t = kTc[min(max(qpc + 2 + toff, 0), 53)] << (a.bdc - 8);
    }
    cout[c * cplane + co] = t;
  }
}

int launch_params(const ParamArgs* a, void* stream) {
  const long long n = (long long)a->h4 * a->ev + (long long)a->eh * a->w4;
  if (n <= 0) return 0;
  const long long blocks = (n + kParamThreads - 1) / kParamThreads;
  deblock_params_kernel<<<(unsigned)blocks, kParamThreads, 0,
                          (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tde_deblock_params(const void* args, void* stream) {
  return launch_params(static_cast<const ParamArgs*>(args), stream);
}

extern "C" int tde_deblock_luma(const void* args, void* stream) {
  return launch<true>(static_cast<const Args*>(args), stream);
}

extern "C" int tde_deblock_chroma(const void* args, void* stream) {
  return launch<false>(static_cast<const Args*>(args), stream);
}
