// Intra super-wave scan on the padded plane: kernels B6 (border gather),
// B7 (window scatter), and the scan's body, which runs B6's gather and B7's
// store around the prediction: launched once per picture by the persistent
// scan (tde_intra_scan, the decode's path) or once per (step, size bin) by
// the fused step (tde_intra_step, held against its plain version only).
//
// Replace the TPU kernels libde265_tpu/ops/intra_window_pallas.py
// border_gather (B6) and window_scatter (B7), and with them the XLA math of
// libde265_tpu/fused_decode.py _wave_body(pallas=True) between the two
// (spec 8.4.4.2: substitution 8.4.4.2.2, filtering 8.4.4.2.3, planar, DC
// and angular prediction 8.4.4.2.4-6) and the fori_loop over the steps of
// _intra_scan_all_inner.
//
// The plane is int32, zero-padded so that every border sample of a block
// lies inside it (ops/intra_window.py scan_pad_sizes); coordinates are
// clamped anyway, for the records of invalid slots.  Border index j of a
// block of size s: j < 2s the left column from bottom to top, j = 2s the
// corner, j > 2s the top row from left to right.
//
// Bound: each step is tiny (at most 256 blocks, 16K pixels), so a step
// launched on its own costs about one launch (the fused step); below
// that, the bytes of the residual rows read and of the blocks written.  The
// steps of a picture form a chain of dependent steps (528 per plane at
// 1080p), so the persistent scan runs them all in one launch: one CTA per
// plane walks its steps with block barriers between them.  The records are
// copied a step ahead and the residual blocks beside the border gather,
// asynchronously, and the prediction moves four samples at once; a 1080p
// step still takes about 4 us, spread over the compaction, the gather, the
// filter and the prediction, all on the one SM's memory pipeline and four
// barriers (PERF.md).
//
// Invariant the persistent scan relies on: the native scheduler
// (native/src/intraplan.cc build_intra_plan) gives a block the step
// max(wmap over its available border cells), where wmap holds 1 + the step
// of the block that wrote each 4x4 cell.  A block of step i therefore reads
// only samples written at steps < i, by a block of any size bin of its
// plane, or before the scan (MC, residual, PCM); the three planes never read
// each other.  So one CTA per plane may walk the steps in order, the bins of
// a step one after another, and a __syncthreads() between steps makes the
// step's global stores visible to the next step's loads (one CTA, so no
// grid barrier).  test_schedule_reads_only_earlier_steps checks this on real
// and synthetic schedules.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Raw border sample j of the block at padded origin (y0p, x0p) (B6, and
// the scan's gather).  The plane is read through a plain pointer (no
// __restrict__, no __ldg): in the scan the read-only path could serve
// samples that an earlier step of the same kernel stored.
__device__ __forceinline__ int border_sample(const int32_t* plane, int Hp,
                                             int Wp, int y0p, int x0p, int s,
                                             int j) {
  const int n2 = 2 * s;
  int y, x;
  if (j < n2) {
    y = y0p + n2 - 1 - j;
    x = x0p - 1;
  } else {
    y = y0p - 1;
    x = x0p + j - n2 - 1;
  }
  y = min(max(y, 0), Hp - 1);
  x = min(max(x, 0), Wp - 1);
  return plane[(long long)y * Wp + x];
}

// One reconstructed sample into the plane (B7, and the scan's store).
__device__ __forceinline__ void store_sample(int32_t* plane, int Hp, int Wp,
                                             int y, int x, int v) {
  if (y >= 0 && y < Hp && x >= 0 && x < Wp) plane[(long long)y * Wp + x] = v;
}

// B6: one thread per (block, border sample).  Rows k >= nvalid are zero.
__global__ void border_gather_kernel(const int32_t* __restrict__ plane,
                                     int Hp, int Wp,
                                     const int32_t* __restrict__ y0p,
                                     const int32_t* __restrict__ x0p, int K,
                                     int nvalid, int s,
                                     int32_t* __restrict__ tops,
                                     int32_t* __restrict__ lefts) {
  const int nb = 4 * s + 1, n2 = 2 * s;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)K * nb) return;
  const int k = (int)(t / nb), j = (int)(t % nb);
  const int v = k < nvalid ? border_sample(plane, Hp, Wp, y0p[k], x0p[k], s, j)
                           : 0;
  if (j < n2)
    lefts[(long long)k * n2 + (n2 - 1 - j)] = v;
  else
    tops[(long long)k * (n2 + 1) + (j - n2)] = v;
}

// B7: one thread per (block, pixel); only valid blocks are written, and the
// valid blocks of a step are disjoint, so the writes never race.
__global__ void window_scatter_kernel(int32_t* __restrict__ plane, int Hp,
                                      int Wp,
                                      const int32_t* __restrict__ blocks,
                                      const int32_t* __restrict__ y0p,
                                      const int32_t* __restrict__ x0p,
                                      const uint8_t* __restrict__ valid,
                                      int K, int s) {
  const int ss = s * s;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)K * ss) return;
  const int k = (int)(t / ss), p = (int)(t % ss);
  if (!valid[k]) return;
  store_sample(plane, Hp, Wp, y0p[k] + p / s, x0p[k] + p % s, blocks[t]);
}

// ---------------------------------------------------------------------------
// The scan's body: one CTA of kScanThreads per plane (the persistent scan)
// or for one (step, bin) (the fused step).
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 1024;
constexpr int kMaxSlots = 256;       // WAVE_CAP[2], the widest size bin
constexpr int kMaxAwWords = 5;       // feed.AVAIL_WORDS
constexpr int kBorderElems = 4352;   // max over sizes of K * (4s + 1)
constexpr int kMaxPixels = 16384;    // max over sizes of K * s * s
constexpr int kBorderPerThread =
    (kBorderElems + kScanThreads - 1) / kScanThreads;
constexpr int kQuadsPerThread = kMaxPixels / 4 / kScanThreads;

// One (plane, size) bin of the scan records, as _scatter_intra_bins builds
// them; depth 0: no bin of this size in the plane.  The records and the
// residual rows are 16-byte aligned and K is a multiple of 4 (K = WAVE_CAP),
// so that every copy below moves 16 bytes.
struct ScanBin {
  const int32_t* meta;  // [rows, K, 5]
  const int32_t* rrow;  // [rows, K]
  const int32_t* aw;    // [rows, K, aw_words]
  const int32_t* res;   // [n_res, s, s] residual rows of the size bin
  int K, depth, n_res, unused;
};

struct ScanPlane {
  int32_t* plane;  // padded [Hp, Wp], updated in place
  int Hp, Wp, bit_depth, nsteps;
  ScanBin bins[4];  // by lg - 2
};

// Passed by value (ops/intra_cuda.py builds it as a ctypes struct).
struct ScanArgs {
  ScanPlane planes[3];
  // angular tables [35, s*s] by lg - 2, packed: P0 | (P1 + 1) << 9 |
  // WT << 18 (ops/intra_cuda.packed_mode_table)
  const int32_t* PT[4];
  int n_planes, pad_t, pad_l, aw_words;
};

constexpr int kRecWords = kMaxSlots * (6 + kMaxAwWords);

// Dynamic shared memory (about 130 KB), one CTA per SM.
struct ScanSmem {
  int res[kMaxPixels];  // the residual blocks of the step's valid slots
  int b[kBorderElems];  // substituted borders of the step's valid blocks
  int f[kBorderElems];  // filtered borders
  // raw records of a (step, bin), two buffers: meta [K, 5] (mode, edge,
  // y0, x0, flags 1 unavailable | 2 filter | 4 strong | 8 valid), rrow
  // [K], aw [K, aw_words]
  int rec[2][kRecWords];
  int mode[kMaxSlots], edge[kMaxSlots], y0p[kMaxSlots], x0p[kMaxSlots];
  int flags[kMaxSlots], rrow[kMaxSlots], dc[kMaxSlots];
  uint32_t aw[kMaxSlots][kMaxAwWords];
  int wcnt[kScanThreads / 32];
};

// The scan's dynamic shared memory.
__device__ __forceinline__ ScanSmem& scan_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<ScanSmem*>(smem);
}

// The records of a (step, bin) into a shared buffer by asynchronous copies
// of 16 bytes (one commit group).  They do not depend on the plane, so the
// next (step, bin)'s are copied while this one computes.
__device__ __forceinline__ void fetch_rec(const ScanBin& B, int step,
                                          int aw_words, int* dst) {
  const int K = B.K, n5 = 5 * K, n6 = 6 * K, nall = (6 + aw_words) * K;
  const int32_t* meta = B.meta + (long long)step * n5;
  const int32_t* rrow = B.rrow + (long long)step * K;
  const int32_t* aw = B.aw + (long long)step * K * aw_words;
  for (int i = 4 * threadIdx.x; i < nall; i += 4 * kScanThreads)
    __pipeline_memcpy_async(
        dst + i,
        i < n5 ? meta + i : i < n6 ? rrow + (i - n5) : aw + (i - n6), 16);
  __pipeline_commit();
}

// The (step, bin) after (i, l) in scan order: the next bin of step i whose
// depth exceeds i, else the first such bin of a later step; i >= nsteps when
// none is left.
__device__ __forceinline__ void next_bin(const ScanPlane& P, int& i, int& l) {
  for (;;) {
    if (++l == 4) {
      l = 0;
      if (++i >= P.nsteps) return;
    }
    if (i < P.bins[l].depth) return;
  }
}

// The valid slots of a (step, bin) compacted into shared memory by a
// block-wide ballot; returns their number (uniform over the CTA).  Its two
// barriers also order the previous (step, bin)'s stores to the plane and
// reads of shared memory before this one's.
__device__ __forceinline__ int compact(const int* rec, int K, int aw_words,
                                       int pad_t, int pad_l, ScanSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* m = rec + 5 * tid;
  const bool v = tid < K && (m[4] & 8);
  const unsigned bal = __ballot_sync(0xffffffffu, v);
  if (lane == 0) sm.wcnt[warp] = __popc(bal);
  __syncthreads();
  int nv = 0, off = 0;
  for (int w = 0; w < (K + 31) >> 5; ++w) {
    const int c = sm.wcnt[w];
    nv += c;
    off += w < warp ? c : 0;
  }
  if (v) {
    const int n = off + __popc(bal & ((1u << lane) - 1u));
    sm.mode[n] = m[0];
    sm.edge[n] = m[1];
    sm.y0p[n] = m[2] + pad_t;
    sm.x0p[n] = m[3] + pad_l;
    sm.flags[n] = m[4];
    sm.rrow[n] = rec[5 * K + tid];
    sm.dc[n] = 0;
    const int* aw = rec + 6 * K + tid * aw_words;
#pragma unroll
    for (int q = 0; q < kMaxAwWords; ++q)
      sm.aw[n][q] = q < aw_words ? (uint32_t)aw[q] : 0u;
  }
  __syncthreads();
  return nv;
}

// The border index whose sample substitution (8.4.4.2.2) puts at j: the
// last available one at or before j, else the first available one; -1 if
// none is available.  A bit search over the availability words, so every
// sample finds its source at once instead of along a 4s+1 chain.
__device__ __forceinline__ int avail_source(const uint32_t* aw, int j,
                                            int nb) {
  int w = j >> 5;
  uint32_t m = aw[w] & (0xffffffffu >> (31 - (j & 31)));
  for (;;) {
    if (m) return (w << 5) + 31 - __clz(m);
    if (--w < 0) break;
    m = aw[w];
  }
  for (w = 0; (w << 5) < nb; ++w) {
    m = aw[w];
    const int rem = nb - (w << 5);
    if (rem < 32) m &= (1u << rem) - 1u;
    if (m) return (w << 5) + __ffs(m) - 1;
  }
  return -1;
}

// The work of one (step, bin) after its compaction: the residual blocks
// copied to shared memory asynchronously, then three passes over (block,
// sample) work items with a barrier after the first two: gather (B6's
// border_sample) + substitution, filtering (+ the DC sums), prediction +
// residual + store (B7's store_sample, or four samples at once).  A pass
// issues all of a thread's loads before it uses the first.  The records,
// residual rows and tables are never written, so they are read through the
// read-only path; the plane is not (border_sample).
template <int LG>
__device__ __forceinline__ void scan_bin(const ScanArgs& a,
                                         const ScanPlane& P, const ScanBin& B,
                                         int nv, ScanSmem& sm) {
  constexpr int S = 1 << LG, N2 = 2 * S, NB = 4 * S + 1, SS = S * S;
  constexpr int NT = kScanThreads;
  const int tid = threadIdx.x;
  int32_t* plane = P.plane;
  const int bd = P.bit_depth, maxv = (1 << bd) - 1;

  // ---- residual blocks into shared memory, 16 bytes a copy (zeros for a
  // slot without one)
  for (int it = tid; it < nv * SS / 4; it += NT) {
    const int rr = sm.rrow[it >> (2 * LG - 2)];
    const int32_t* src = B.res + (long long)min(max(rr, 0), B.n_res - 1) * SS +
                         4 * (it & (SS / 4 - 1));
    __pipeline_memcpy_async(&sm.res[4 * it], src, 16, rr >= 0 ? 0 : 16);
  }
  __pipeline_commit();

  // ---- border gather (B6's function) with the substitution folded in:
  // each sample reads its source sample straight from the plane
  int val[kBorderPerThread];
#pragma unroll
  for (int u = 0; u < kBorderPerThread; ++u) {
    const int it = tid + u * NT;
    val[u] = 0;
    if (it < nv * NB) {
      const int n = it / NB, j = it - n * NB;
      if (sm.flags[n] & 1) {
        val[u] = 1 << (bd - 1);
      } else {
        const int src = avail_source(sm.aw[n], j, NB);
        if (src >= 0)
          val[u] = border_sample(plane, P.Hp, P.Wp, sm.y0p[n], sm.x0p[n], S,
                                 src);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kBorderPerThread; ++u)
    if (tid + u * NT < nv * NB) sm.b[tid + u * NT] = val[u];
  __syncthreads();

  // ---- filtering (8.4.4.2.3) and the DC sums of DC-mode blocks
  for (int it = tid; it < nv * NB; it += NT) {
    const int n = it / NB, j = it - n * NB;
    const int* b = sm.b + n * NB;
    const int flags = sm.flags[n];
    int v = b[j];
    bool bilinear = false;
    if (S == 32 && (flags & 4)) {
      const int thr = 1 << (bd - 5);
      bilinear = abs(b[N2] + b[4 * S] - 2 * b[N2 + S]) < thr &&
                 abs(b[N2] + b[0] - 2 * b[S]) < thr;
    }
    if (bilinear) {
      if (j > 0 && j < N2)
        v = (j * b[N2] + (N2 - j) * b[0] + 32) >> 6;
      else if (j > N2 && j < 4 * S)
        v = ((4 * S - j) * b[N2] + (j - N2) * b[4 * S] + 32) >> 6;
    } else if ((flags & 2) && j > 0 && j < NB - 1) {
      v = (b[j - 1] + 2 * b[j] + b[j + 1] + 2) >> 2;
    }
    sm.f[it] = v;
    if (sm.mode[n] == 1 && j >= N2 - S && j <= N2 + S && j != N2)
      atomicAdd(&sm.dc[n], v);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- prediction, residual add, clip, store (B7's function).  A work
  // item is a quad, four adjacent samples of one block row, so that its
  // table entries, its residual and its store move 16 bytes at once; a
  // thread loads the table entries of all its quads before it uses the
  // first.
  const int32_t* PT = a.PT[LG - 2];
  const int nq = nv * SS / 4;
  const bool vec_store = ((uintptr_t)plane & 15) == 0 && (P.Wp & 3) == 0;
  int4 tab[kQuadsPerThread];
#pragma unroll
  for (int u = 0; u < kQuadsPerThread; ++u) {
    const int it = tid + u * NT;
    const int mode = it < nq ? sm.mode[it >> (2 * LG - 2)] : 0;
    tab[u] = mode >= 2 ? __ldg(reinterpret_cast<const int4*>(
                             PT + min(mode, 34) * SS + 4 * (it & (SS / 4 - 1))))
                       : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kQuadsPerThread; ++u) {
    const int it = tid + u * NT;
    if (it >= nq) continue;
    const int n = it >> (2 * LG - 2), q = it & (SS / 4 - 1);
    const int y = q >> (LG - 2), x0 = 4 * (q & (S / 4 - 1));
    const int* f = sm.f + n * NB;
    const int mode = sm.mode[n], edge = sm.edge[n];
    const int corner = f[N2], left = f[N2 - 1 - y];
    const int4 rv = *reinterpret_cast<const int4*>(&sm.res[4 * it]);
    const int res4[4] = {rv.x, rv.y, rv.z, rv.w};
    const int pt4[4] = {tab[u].x, tab[u].y, tab[u].z, tab[u].w};
    const int dc = (sm.dc[n] + S) >> (LG + 1);
    int out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = x0 + k;
      int pred;
      if (mode == 0) {  // planar
        pred = ((S - 1 - x) * left + (x + 1) * f[N2 + 1 + S] +
                (S - 1 - y) * f[N2 + 1 + x] + (y + 1) * f[N2 - 1 - S] + S) >>
               (LG + 1);
      } else if (mode == 1) {  // DC, with the edge filter below 32x32
        pred = dc;
        if (S < 32 && edge == 1) {
          if (y == 0 && x == 0)
            pred = (f[N2 - 1] + 2 * dc + f[N2 + 1] + 2) >> 2;
          else if (y == 0)
            pred = (f[N2 + 1 + x] + 3 * dc + 2) >> 2;
          else if (x == 0)
            pred = (left + 3 * dc + 2) >> 2;
        }
      } else {  // angular
        const int pt = pt4[k];
        const int p0 = pt & 511, p1 = ((pt >> 9) & 511) - 1, wt = pt >> 18;
        const int g0 = (p0 >= 0 && p0 < NB) ? f[p0] : 0;
        const int g1 = (p1 >= 0 && p1 < NB) ? f[p1] : 0;
        pred = ((32 - wt) * g0 + wt * g1 + 16) >> 5;
        if (S < 32 && edge == 2 && x == 0)
          pred = min(max(f[N2 + 1] + ((left - corner) >> 1), 0), maxv);
        else if (S < 32 && edge == 3 && y == 0)
          pred = min(max(f[N2 - 1] + ((f[N2 + 1 + x] - corner) >> 1), 0),
                     maxv);
      }
      out[k] = min(max(pred + res4[k], 0), maxv);
    }
    const int yy = sm.y0p[n] + y, xx = sm.x0p[n] + x0;
    int32_t* dst = plane + (long long)yy * P.Wp + xx;
    if (vec_store && yy >= 0 && yy < P.Hp && xx >= 0 && xx + 3 < P.Wp) {
      *reinterpret_cast<int4*>(dst) = make_int4(out[0], out[1], out[2],
                                                out[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        store_sample(plane, P.Hp, P.Wp, yy, xx + k, out[k]);
    }
  }
}

// A compacted (step, bin) of size bin l (lg - 2) with nv valid slots; for
// none, only the wait for the pending copies and a barrier.
__device__ __forceinline__ void run_bin(const ScanArgs& a, const ScanPlane& P,
                                        int l, int nv, ScanSmem& sm) {
  const ScanBin& B = P.bins[l];
  switch (nv > 0 ? l : -1) {
    case 0: scan_bin<2>(a, P, B, nv, sm); break;
    case 1: scan_bin<3>(a, P, B, nv, sm); break;
    case 2: scan_bin<4>(a, P, B, nv, sm); break;
    case 3: scan_bin<5>(a, P, B, nv, sm); break;
    default:
      __pipeline_wait_prior(0);
      __syncthreads();
  }
}

// One CTA per plane walks the plane's (step, bin) pairs in scan order:
// compaction, then the copy of the next pair's records started, then this
// pair's work.  The next compaction's barriers separate this pair's stores
// from the next pair's gather; the wait before this pair's prediction (or
// the one in run_bin, for a pair without valid slots) covers the records'
// copy.
__global__ void __launch_bounds__(kScanThreads, 1)
intra_scan_kernel(const __grid_constant__ ScanArgs a) {
  ScanSmem& sm = scan_smem();
  const ScanPlane& P = a.planes[blockIdx.x];
  if (P.nsteps <= 0) return;
  int i = 0, l = -1;
  next_bin(P, i, l);
  int buf = 0;
  fetch_rec(P.bins[l], i, a.aw_words, sm.rec[0]);
  __pipeline_wait_prior(0);
  __syncthreads();
  while (i < P.nsteps) {
    const int nv = compact(sm.rec[buf], P.bins[l].K, a.aw_words, a.pad_t,
                           a.pad_l, sm);
    int ni = i, nl = l;
    next_bin(P, ni, nl);
    if (ni < P.nsteps) fetch_rec(P.bins[nl], ni, a.aw_words, sm.rec[buf ^ 1]);
    run_bin(a, P, l, nv, sm);
    buf ^= 1;
    i = ni;
    l = nl;
  }
}

// The fused step: the scan's body on one (step, bin) of plane 0, one CTA.
__global__ void __launch_bounds__(kScanThreads, 1)
intra_step_kernel(const __grid_constant__ ScanArgs a, int step, int l) {
  ScanSmem& sm = scan_smem();
  const ScanPlane& P = a.planes[0];
  fetch_rec(P.bins[l], step, a.aw_words, sm.rec[0]);
  __pipeline_wait_prior(0);
  __syncthreads();
  run_bin(a, P, l,
          compact(sm.rec[0], P.bins[l].K, a.aw_words, a.pad_t, a.pad_l, sm),
          sm);
}

bool size_ok(int s) { return s == 4 || s == 8 || s == 16 || s == 32; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The checks of both scan entry points: sizes within the shared memory,
// pointers present and 16-byte aligned, K a multiple of 4.
bool scan_args_ok(const ScanArgs& a) {
  if (a.n_planes < 1 || a.n_planes > 3 || a.aw_words < 1 ||
      a.aw_words > kMaxAwWords)
    return false;
  for (int c = 0; c < a.n_planes; ++c) {
    const ScanPlane& P = a.planes[c];
    if (P.nsteps > 0 && (!P.plane || P.bit_depth < 5 || P.bit_depth > 16))
      return false;
    for (int l = 0; l < 4; ++l) {
      const ScanBin& B = P.bins[l];
      const int nb = 4 * (4 << l) + 1, ss = (4 << l) * (4 << l);
      if (B.depth <= 0) continue;
      if (B.K <= 0 || B.K > kMaxSlots || (B.K & 3) || B.K * nb > kBorderElems ||
          B.K * ss > kMaxPixels || B.n_res <= 0 || a.aw_words * 32 < nb ||
          !B.meta || !B.rrow || !B.aw || !B.res || !a.PT[l] ||
          !aligned16(B.meta) || !aligned16(B.rrow) || !aligned16(B.aw) ||
          !aligned16(B.res) || !aligned16(a.PT[l]))
        return false;
    }
  }
  return true;
}

// Both kernels take about 130 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_scan_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(ScanSmem));
}

}  // namespace

extern "C" int tde_border_gather(const void* plane, int Hp, int Wp,
                                 const void* y0p, const void* x0p, int K,
                                 int nvalid, int s, void* tops, void* lefts,
                                 void* stream) {
  if (!size_ok(s)) return (int)cudaErrorInvalidValue;
  if (K <= 0) return 0;
  const int threads = 256;
  const long long n = (long long)K * (4 * s + 1);
  border_gather_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)plane, Hp, Wp, (const int32_t*)y0p,
      (const int32_t*)x0p, K, nvalid, s, (int32_t*)tops, (int32_t*)lefts);
  return (int)cudaGetLastError();
}

extern "C" int tde_window_scatter(void* plane, int Hp, int Wp,
                                  const void* blocks, const void* y0p,
                                  const void* x0p, const void* valid, int K,
                                  int s, void* stream) {
  if (!size_ok(s)) return (int)cudaErrorInvalidValue;
  if (K <= 0) return 0;
  const int threads = 256;
  const long long n = (long long)K * s * s;
  window_scatter_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (int32_t*)plane, Hp, Wp, (const int32_t*)blocks, (const int32_t*)y0p,
      (const int32_t*)x0p, (const uint8_t*)valid, K, s);
  return (int)cudaGetLastError();
}

// The whole scan of a picture in one launch: one CTA per plane walks steps
// 0 .. nsteps-1 of its plane, each bin whose depth exceeds the step.
extern "C" int tde_intra_scan(const void* args, void* stream) {
  const ScanArgs& a = *(const ScanArgs*)args;
  if (!scan_args_ok(a)) return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_ok = allow_scan_smem(intra_scan_kernel);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  intra_scan_kernel<<<a.n_planes, kScanThreads, sizeof(ScanSmem),
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One (step, bin) of plane 0 of the same arguments: bins[lg - 2], `step`
// below its depth.
extern "C" int tde_intra_step(const void* args, int step, int lg,
                              void* stream) {
  const ScanArgs& a = *(const ScanArgs*)args;
  if (lg < 2 || lg > 5 || step < 0 || a.n_planes != 1 || !scan_args_ok(a) ||
      step >= a.planes[0].bins[lg - 2].depth)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_ok = allow_scan_smem(intra_step_kernel);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  intra_step_kernel<<<1, kScanThreads, sizeof(ScanSmem),
                      (cudaStream_t)stream>>>(a, step, lg - 2);
  return (int)cudaGetLastError();
}
