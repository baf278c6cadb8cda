// Intra super-wave scan on the padded plane: kernels B6 (border gather),
// B7 (window scatter), and the persistent scan (tde_intra_scan, one launch
// per picture), which runs B6's gather and B7's store around the
// prediction in every step.
//
// Replace the TPU kernels libde265_tpu/ops/intra_window_pallas.py
// border_gather (B6) and window_scatter (B7), and with them the XLA math of
// libde265_tpu/fused_decode.py _wave_body(pallas=True) between the two
// (spec 8.4.4.2: substitution 8.4.4.2.2, filtering 8.4.4.2.3, planar, DC
// and angular prediction 8.4.4.2.4-6) and the JAX program's fori_loop over
// the steps.
//
// The plane is int32, zero-padded so that every border sample of a block
// lies inside it (ops/intra_window.py scan_pad_sizes); coordinates are
// clamped anyway, for the records of invalid slots.  Border index j of a
// block of size s: j < 2s the left column from bottom to top, j = 2s the
// corner, j > 2s the top row from left to right.
//
// Bound: not the bytes (records, residual rows and stored blocks: about
// 10 us for a 1080p I picture) but the chain of dependent steps (528 per
// plane at 1080p, each of at most a few hundred small blocks): a step's
// gather reads what the step before stored, so each step costs at least a
// store, a block barrier and a load (chain_probe_kernel measures that
// round trip; PERF.md holds both bounds).  The scan therefore runs in one
// launch, one CTA per plane, and keeps a step's dependent chain to what the
// data forces: one block barrier and one round trip through the plane.
// Everything that does not depend on the plane is prepared off that chain
// by the CTA's last warp: the records are copied two steps ahead and
// compacted one step ahead, each valid block with its mode's angle.  The
// other warps run all size bins of a step in one pass, each block by one
// warp or a part of one (4x4 blocks 8 lanes, 8x8 16, larger ones 32), from
// its residual and border loads through the filtering (its border in the
// warp's shared memory, between __syncwarp()s), the DC sum (shuffles) and
// an angular mode's reference array (the spec's ref[], built once a block)
// to the store.  A warp's border memory is reused by every block it runs,
// in the step and in the next one, so each block starts with a __syncwarp()
// that orders the previous block's reads before its writes.
//
// Invariant the persistent scan relies on: the native scheduler
// (native/src/intraplan.cc build_intra_plan) gives a block the step
// max(wmap over its available border cells), where wmap holds 1 + the step
// of the block that wrote each 4x4 cell.  A block of step i therefore reads
// only samples written at steps < i, by a block of any size bin of its
// plane, or before the scan (MC, residual, PCM); the three planes never read
// each other.  So one CTA per plane may walk the steps in order, all bins of
// a step at once, and a __syncthreads() between steps makes the step's
// global stores visible to the next step's loads (one CTA, so no grid
// barrier).  test_schedule_reads_only_earlier_steps checks this on real and
// synthetic schedules.
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
// The scan: one CTA per plane (the persistent scan) or for one (step, bin)
// of plane 0 (the fused step).  The CTA's last warp prepares step i + 1
// while the other warps run step i; one block barrier a step.
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// The scan's CTA: 1024 threads, from scripts/scan_probe.py's sweep, which
// builds other sizes with TDE_SCAN_THREADS defined; one producer warp, the
// others consumers.
#ifndef TDE_SCAN_THREADS
#define TDE_SCAN_THREADS 1024
#endif
constexpr int kScanThreads = TDE_SCAN_THREADS;
constexpr int kScanWarps = kScanThreads / 32;
static_assert(kScanThreads % 32 == 0 && kScanWarps >= 2 &&
                  kScanThreads <= kMaxThreads,
              "the scan needs a producer warp and a consumer warp");
// Timing-only builds (scripts/scan_probe.py --ablate; wrong output):
// TDE_SCAN_ABLATE 1 the consumers run no block (the producer alone), 2 nor
// does the producer copy records (its compaction alone), 3 the producer
// does nothing after the first step (the consumers alone, every step on the
// first step's blocks).
#ifndef TDE_SCAN_ABLATE
#define TDE_SCAN_ABLATE 0
#endif
constexpr int kMaxAwWords = 5;  // feed.AVAIL_WORDS
// The most slots of a size bin (feed.WAVE_CAP), by lg - 2: a step of all
// four bins holds at most 464 blocks.
__host__ __device__ constexpr int max_slots(int l) {
  return l < 3 ? 256 >> l : 16;
}
constexpr int kMaxBlocks = 256 + 128 + 64 + 16;
constexpr int kRecWords = kMaxBlocks * (6 + kMaxAwWords);
constexpr int kBorderWords = 132;  // a warp's borders: at most 4 * 32 + 1
#ifdef TDE_SCAN_STAMPS
constexpr int kPhases = 5;  // clock64() stamps
#endif

// One (plane, size) bin of the scan records, as tde_intra_bins writes
// them; depth 0: no bin of this size in the plane.  The records and the
// residual rows are 16-byte aligned and K is a multiple of 4, so that every
// copy of the records moves 16 bytes and every residual read a quad.
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

// Passed by value (ops/intra_cuda.py builds it as a ctypes struct).  The
// CTA runs steps 0 .. nsteps - 1 of its plane; stamps: [n_planes,
// kMaxWarps, 5] cycles, written only by a build with TDE_SCAN_STAMPS
// defined (scripts/scan_probe.py).
struct ScanArgs {
  ScanPlane planes[3];
  long long* stamps;
  int n_planes, pad_t, pad_l, aw_words;
};

// A step's valid blocks as the producer warp leaves them, bin by bin, a
// field an array (consecutive blocks in consecutive banks): everything
// about them that does not depend on the plane.  flags: 1 unavailable |
// 2 filter | 4 strong.
struct StepBlocks {
  int y0p[kMaxBlocks], x0p[kMaxBlocks], mode[kMaxBlocks], edge[kMaxBlocks];
  int flags[kMaxBlocks], rrow[kMaxBlocks], angle[kMaxBlocks];
  int inv[kMaxBlocks];
  uint32_t aw[kMaxAwWords][kMaxBlocks];
  int nv[4];  // valid blocks of each bin
};

// Dynamic shared memory (about 143 KB), one CTA per SM.
struct ScanSmem {
  // raw records of a step, bins of depth > step in order: meta [K, 5],
  // rrow [K], aw [K, aw_words]; two buffers
  int rec[2][kRecWords];
  StepBlocks blk[2];
  // a warp's borders: substituted (then the angular reference array),
  // filtered
  int bord[kScanWarps][2][kBorderWords];
  int angle[35], inv[35];  // intraPredAngle and invAngle by mode
};

__device__ __forceinline__ ScanSmem& scan_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<ScanSmem*>(smem);
}

__constant__ int kAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,
                               2,   0,   -2,  -5,  -9,  -13, -17, -21, -26,
                               -32, -26, -21, -17, -13, -9,  -5,  -2, 0,
                               2,   5,   9,   13,  17,  21,  26,  32};
__constant__ int kInvAngle[35] = {
    0,    0,    0,    0,    0,    0,    0,    0,     0,     0,    0,    -4096,
    -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482, -630, -910,
    -1638, -4096, 0,   0,    0,    0,    0,    0,     0,     0,    0};

// Per-warp cycle counts of the phases of a step (a TDE_SCAN_STAMPS build):
// 0 the block barrier, 1 records, residual loads and border gather, 2
// filtering and DC sums, 3 prediction and stores, 4 the producer's work.
struct Stamps {
#ifdef TDE_SCAN_STAMPS
  long long acc[kPhases];
  long long last;
  __device__ void begin() {
    for (int p = 0; p < kPhases; ++p) acc[p] = 0;
    last = clock64();
  }
  __device__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
#else
  __device__ void begin() {}
  __device__ void mark(int) {}
#endif
};

// The records of step t (bins of depth > t) into a shared buffer by
// asynchronous copies of 16 bytes, by one warp (the caller commits them).
__device__ __forceinline__ void fetch_step(const ScanPlane& P, int t,
                                           int aw_words, int* dst) {
  const int lane = threadIdx.x & 31;
  for (int l = 0; l < 4; ++l) {
    const ScanBin& B = P.bins[l];
    if (t >= B.depth) continue;
    const int K = B.K, n5 = 5 * K, n6 = 6 * K, nall = (6 + aw_words) * K;
    const int32_t* meta = B.meta + (long long)t * n5;
    const int32_t* rrow = B.rrow + (long long)t * K;
    const int32_t* aw = B.aw + (long long)t * K * aw_words;
    for (int i = 4 * lane; i < nall; i += 128)
      __pipeline_memcpy_async(
          dst + i,
          i < n5 ? meta + i : i < n6 ? rrow + (i - n5) : aw + (i - n6), 16);
    dst += nall;
  }
}

// The valid slots of step t (its records in rec, as fetch_step left them)
// compacted by one warp into blk, bin by bin, with their counts; the
// angles from the shared copies of the tables (sm.angle, sm.inv).
__device__ __forceinline__ void compact_step(const ScanPlane& P, int t,
                                             const ScanArgs& a,
                                             const int* rec, StepBlocks& blk,
                                             const ScanSmem& sm) {
  const int lane = threadIdx.x & 31, aw_words = a.aw_words;
  int n = 0;
  for (int l = 0; l < 4; ++l) {
    const ScanBin& B = P.bins[l];
    const int n0 = n;
    if (t < B.depth) {
      const int K = B.K;
      for (int s0 = 0; s0 < K; s0 += 32) {
        const int slot = s0 + lane;
        const int* m = rec + 5 * slot;
        const bool v = slot < K && (m[4] & 8);
        const unsigned bal = __ballot_sync(0xffffffffu, v);
        if (v) {
          const int b = n + __popc(bal & ((1u << lane) - 1u));
          const int mode = min(max(m[0], 0), 34);
          blk.y0p[b] = m[2] + a.pad_t;
          blk.x0p[b] = m[3] + a.pad_l;
          blk.mode[b] = m[0];
          blk.edge[b] = m[1];
          blk.flags[b] = m[4];
          blk.rrow[b] = rec[5 * K + slot];
          blk.angle[b] = sm.angle[mode];
          blk.inv[b] = sm.inv[mode];
          const int* aw = rec + 6 * K + slot * aw_words;
#pragma unroll
          for (int q = 0; q < kMaxAwWords; ++q)
            blk.aw[q][b] = q < aw_words ? (uint32_t)aw[q] : 0u;
        }
        n += __popc(bal);
      }
      rec += (6 + aw_words) * K;
    }
    if (lane == 0) blk.nv[l] = n - n0;
  }
}

// The border index whose sample substitution (8.4.4.2.2) puts at j: the
// last available one at or before j, else the first available one; -1 if
// none is available.  A bit search over the AW availability words held in
// registers, so every sample finds its source at once.
template <int AW>
__device__ __forceinline__ int avail_source(const uint32_t (&aw)[AW], int j,
                                            int nb) {
  int src = -1;
#pragma unroll
  for (int w = 0; w < AW; ++w) {
    uint32_t m = aw[w];
    if (w == (j >> 5)) m &= 0xffffffffu >> (31 - (j & 31));
    if (w <= (j >> 5) && m) src = (w << 5) + 31 - __clz(m);
  }
  if (src >= 0) return src;
#pragma unroll
  for (int w = AW - 1; w >= 0; --w) {
    uint32_t m = aw[w];
    const int rem = nb - (w << 5);
    if (rem < 32) m &= (1u << rem) - 1u;
    if (m) src = (w << 5) + __ffs(m) - 1;
  }
  return src;
}

// The blocks of one task: blocks n0 .. n0 + nblk - 1 (nblk 1 .. 32 / G) of
// a step, of size 2^LG and bin B, G lanes a block, run by one warp from
// gather to store: the residual quads and the border samples loaded at
// once, the substituted border and its filtered copy in the warp's shared
// memory (bord) between __syncwarp()s, the DC sum over the block's lanes by
// shuffles, and for an angular mode the spec's reference array ref[-S ..
// 2S + 1] (8.4.4.2.6, the projection by invAngle included) built from the
// filtered border in place of the substituted one, so that a sample reads
// two entries at an index of its row (vertical modes) or column.  The
// warp's border memory (bord) is the one its previous block used.
template <int LG>
__device__ __forceinline__ void run_blocks(const ScanPlane& P,
                                           const ScanBin& B,
                                           const StepBlocks& blk, int n0,
                                           int nblk, int* bord,
                                           Stamps& st) {
  constexpr int S = 1 << LG, N2 = 2 * S, NB = 4 * S + 1, SS = S * S;
  constexpr int G = LG == 2 ? 8 : LG == 3 ? 16 : 32;  // lanes a block
  constexpr int U = (NB + G - 1) / G;                // border samples a lane
  constexpr int Q = SS / 4;                          // quads a block
  constexpr int QL = (Q + G - 1) / G;                // quads a lane
  constexpr int AW = (NB + 31) / 32;                 // availability words
  const int lane = threadIdx.x & 31, lig = lane % G, grp = lane / G;
  const bool act = grp < nblk;
  const int n = n0 + (act ? grp : 0);
  const int y0p = blk.y0p[n], x0p = blk.x0p[n], flags = blk.flags[n];
  const int rr = blk.rrow[n];
  const int bd = P.bit_depth, maxv = (1 << bd) - 1;
  int32_t* plane = P.plane;
  __syncwarp();  // the warp's previous block has read bord

  // residual quads (read-only, never written by the scan) and border
  // samples: all loads issued before the first use.  A 32x32 block's lane
  // loads each of its eight quads where it uses it instead: held ahead,
  // they cost the kernel's other paths registers (spills).
  constexpr int QP = QL <= 2 ? QL : 0;  // quads a lane loads ahead
  const int32_t* rsrc =
      B.res + (long long)min(max(rr, 0), B.n_res - 1) * SS;
  int4 res[QP > 0 ? QP : 1];
#pragma unroll
  for (int u = 0; u < QP; ++u) {
    const int q = lig + G * u;
    res[u] = make_int4(0, 0, 0, 0);
    if (act && q < Q && rr >= 0)
      res[u] = __ldg(reinterpret_cast<const int4*>(rsrc + 4 * q));
  }
  uint32_t aw[AW];
#pragma unroll
  for (int w = 0; w < AW; ++w) aw[w] = blk.aw[w][n];
  int val[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lig + G * u;
    val[u] = 0;
    if (act && j < NB) {
      if (flags & 1) {
        val[u] = 1 << (bd - 1);
      } else {
        const int src = avail_source(aw, j, NB);
        if (src >= 0)
          val[u] = border_sample(plane, P.Hp, P.Wp, y0p, x0p, S, src);
      }
    }
  }
  int* b = bord + grp * NB;
  int* f = bord + kBorderWords + grp * NB;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (act && lig + G * u < NB) b[lig + G * u] = val[u];
  __syncwarp();
  st.mark(1);

  // filtering (8.4.4.2.3) and the DC sum
  int dcs = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lig + G * u;
    if (!act || j >= NB) continue;
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
    f[j] = v;
    if (j >= N2 - S && j <= N2 + S && j != N2) dcs += v;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    dcs += __shfl_xor_sync(0xffffffffu, dcs, o);
  __syncwarp();
  st.mark(2);

  // the reference array of an angular mode: ref[i] at b[i + S]
  const int mode = blk.mode[n], edge = blk.edge[n], angle = blk.angle[n];
  const bool vert = mode >= 18;
  if (act && mode >= 2) {
    const int inv = blk.inv[n];
#pragma unroll
    for (int u = 0; u < (3 * S + 2 + G - 1) / G; ++u) {
      const int r = lig + G * u, i = r - S;
      if (r >= 3 * S + 2) continue;
      int j;
      if (i >= 0) {
        j = vert ? N2 + i : N2 - i;
      } else {
        const int off = (i * inv + 128) >> 8;
        j = vert ? max(N2 - off, 0) : min(N2 + off, 4 * S);
      }
      b[r] = j >= 0 && j < NB ? f[j] : 0;
    }
  }
  __syncwarp();

  // prediction, residual add, clip and store, a quad (four samples of a
  // block row) at a time
  const int dc = (dcs + S) >> (LG + 1);
  const bool vec_store = ((uintptr_t)plane & 15) == 0 && (P.Wp & 3) == 0;
#pragma unroll
  for (int u = 0; u < QL; ++u) {
    const int q = lig + G * u;
    if (!act || q >= Q) continue;
    const int y = q >> (LG - 2), x0 = 4 * (q & (S / 4 - 1));
    const int corner = f[N2], left = f[N2 - 1 - y];
    const int4 rv =  // (the index is clamped only for the compiler)
        u < QP ? res[u < QP ? u : 0]
        : rr >= 0 ? __ldg(reinterpret_cast<const int4*>(rsrc + 4 * q))
                  : make_int4(0, 0, 0, 0);
    const int res4[4] = {rv.x, rv.y, rv.z, rv.w};
    int out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = x0 + c;
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
      } else {  // angular: ref[i0], ref[i0 + 1] with i0 = idx + 1 + x (y)
        const int t = ((vert ? y : x) + 1) * angle, wt = t & 31;
        const int* r = b + S + (t >> 5) + 1 + (vert ? x : y);
        pred = ((32 - wt) * r[0] + wt * r[1] + 16) >> 5;
        if (S < 32 && edge == 2 && x == 0)
          pred = min(max(f[N2 + 1] + ((left - corner) >> 1), 0), maxv);
        else if (S < 32 && edge == 3 && y == 0)
          pred = min(max(f[N2 - 1] + ((f[N2 + 1 + x] - corner) >> 1), 0),
                     maxv);
      }
      out[c] = min(max(pred + res4[c], 0), maxv);
    }
    const int yy = y0p + y, xx = x0p + x0;
    int32_t* dst = plane + (long long)yy * P.Wp + xx;
    if (vec_store && yy >= 0 && yy < P.Hp && xx >= 0 && xx + 3 < P.Wp) {
      *reinterpret_cast<int4*>(dst) = make_int4(out[0], out[1], out[2],
                                                out[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store_sample(plane, P.Hp, P.Wp, yy, xx + c, out[c]);
    }
  }
  st.mark(3);
}

// A consumer warp's share of a step: tasks of the largest size first, a
// task the blocks of one bin that one warp runs together (four 4x4, two
// 8x8, one 16x16 or 32x32), task k to consumer warp k % ncons.
__device__ __forceinline__ void run_step(const ScanPlane& P,
                                         const StepBlocks& blk, int warp,
                                         int ncons, int* bord, Stamps& st) {
  int nv[4], off[4], n = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    nv[l] = blk.nv[l];
    off[l] = n;
    n += nv[l];
  }
  int task = warp, base = 0;
#pragma unroll
  for (int l = 3; l >= 0; --l) {
    const int per = l == 0 ? 4 : l == 1 ? 2 : 1;
    const int ntask = (nv[l] + per - 1) / per;
    for (; task < base + ntask; task += ncons) {
      const int i = (task - base) * per, kb = off[l] + i;
      const int nb = min(per, nv[l] - i);
      switch (l) {
        case 0: run_blocks<2>(P, P.bins[0], blk, kb, nb, bord, st); break;
        case 1: run_blocks<3>(P, P.bins[1], blk, kb, nb, bord, st); break;
        case 2: run_blocks<4>(P, P.bins[2], blk, kb, nb, bord, st); break;
        default: run_blocks<5>(P, P.bins[3], blk, kb, nb, bord, st);
      }
    }
    base += ntask;
  }
}

// One CTA per plane walks steps 0 .. nsteps - 1.  The last warp
// (the producer) starts the copy of step i + 2's records, then compacts
// step i + 1's, copied a step earlier, while the other warps (the
// consumers) run step i from the blocks it compacted one step before.  The
// one block barrier a step makes step i's stores to the plane visible to
// step i + 1's gather, and the producer's compaction to the consumers.
// Each step's copy is one commit group, an empty one where no step is
// left, so that waiting for all but the newest group waits for the step to
// be compacted.
__global__ void __launch_bounds__(kScanThreads, 1)
intra_scan_kernel(const __grid_constant__ ScanArgs a) {
  ScanSmem& sm = scan_smem();
  const ScanPlane& P = a.planes[blockIdx.x];
  const int last = P.nsteps;
  if (last <= 0) return;
  const int warp = threadIdx.x >> 5;
  const bool producer = warp == kScanWarps - 1;
  Stamps st;
  st.begin();
  if (producer) {
    const int lane = threadIdx.x & 31;
    for (int m = lane; m < 35; m += 32) {
      sm.angle[m] = kAngle[m];
      sm.inv[m] = kInvAngle[m];
    }
    fetch_step(P, 0, a.aw_words, sm.rec[0]);
    __pipeline_commit();
    if (last > 1) fetch_step(P, 1, a.aw_words, sm.rec[1]);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    compact_step(P, 0, a, sm.rec[0], sm.blk[0], sm);
    if (TDE_SCAN_ABLATE == 3) {
      __pipeline_wait_prior(0);
      compact_step(P, 0, a, sm.rec[0], sm.blk[1], sm);
    }
  }
  __syncthreads();
  st.mark(0);
  for (int i = 0; i < last; ++i) {
    const int q = i & 1;
    if (!producer) {
      if (TDE_SCAN_ABLATE != 1 && TDE_SCAN_ABLATE != 2)
        run_step(P, sm.blk[q], warp, kScanWarps - 1, sm.bord[warp][0], st);
    } else if (TDE_SCAN_ABLATE != 3) {
      if (i + 2 < last && TDE_SCAN_ABLATE != 2)
        fetch_step(P, i + 2, a.aw_words, sm.rec[q]);
      __pipeline_commit();
      if (i + 1 < last) {
        __pipeline_wait_prior(1);
        __syncwarp();
        compact_step(P, i + 1, a, sm.rec[q ^ 1], sm.blk[q ^ 1], sm);
      }
      st.mark(4);
    }
    __syncthreads();
    st.mark(0);
  }
#ifdef TDE_SCAN_STAMPS
  if ((threadIdx.x & 31) == 0 && a.stamps)
    for (int p = 0; p < kPhases; ++p)
      a.stamps[((long long)blockIdx.x * kMaxWarps + warp) * kPhases + p] =
          st.acc[p];
#endif
}

// The least latency of one dependent step of the scan on this card: rounds
// of (store, block barrier, load of the sample that the next warp stored,
// store), through shared memory (mode 0), through global memory with the
// scan's loads (mode 1: ld.global, cached in L1) or with loads from L2
// (mode 2: ld.global.cg).  buf holds 2 * blockDim.x ints; cycles gets the
// clock64() span of the rounds.
__global__ void __launch_bounds__(kMaxThreads)
chain_probe_kernel(int32_t* buf, int rounds, int mode, long long* cycles) {
  __shared__ int sh[2 * kMaxThreads];
  const int t = threadIdx.x, n = blockDim.x, src = (t + 32) % n;
  int v = t;
  __syncthreads();
  const long long c0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    const int o = (r & 1) * n;
    if (mode == 0) {
      sh[o + t] = v;
      __syncthreads();
      v = sh[o + src] + 1;
    } else {
      buf[o + t] = v;
      __syncthreads();
      v = (mode == 1 ? buf[o + src] : __ldcg(buf + o + src)) + 1;
    }
  }
  const long long c1 = clock64();
  buf[(rounds & 1) * n + t] = v;
  if (t == 0) *cycles = c1 - c0;
}

bool size_ok(int s) { return s == 4 || s == 8 || s == 16 || s == 32; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The scan's checks: bin widths within the shared memory, pointers present
// and 16-byte aligned, K a multiple of 4.
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
      if (B.depth <= 0) continue;
      if (B.K <= 0 || B.K > max_slots(l) || (B.K & 3) || B.n_res <= 0 ||
          a.aw_words * 32 < 4 * (4 << l) + 1 || !B.meta || !B.rrow ||
          !B.aw || !B.res || !aligned16(B.meta) || !aligned16(B.rrow) ||
          !aligned16(B.aw) || !aligned16(B.res))
        return false;
    }
  }
  return true;
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
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      intra_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ScanSmem));
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  intra_scan_kernel<<<a.n_planes, kScanThreads, sizeof(ScanSmem),
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The scan's CTA size in this build (kScanThreads).
extern "C" int tde_scan_threads() { return kScanThreads; }

// chain_probe_kernel on one CTA of `threads` threads; buf: 2 * threads
// int32, cycles: one int64.
extern "C" int tde_chain_probe(void* buf, int threads, int rounds, int mode,
                               void* cycles, void* stream) {
  if (threads < 32 || threads > kMaxThreads || (threads & 31) || rounds < 1 ||
      mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  chain_probe_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)buf, rounds, mode, (long long*)cycles);
  return (int)cudaGetLastError();
}
