// Kernel B4: the CSR coefficient streams of a picture's TU size bins ->
// dense [N, S, S] int32 levels, every bin in one launch; and after it the
// residual bins kernel (below): those levels -> residuals, in place.
//
// Replaces the TPU kernel libde265_tpu/ops/coef_pallas.py:densify_bin
// (_densify_kernel).  Same input, per bin: a CSR stream of 8-bit entries,
// four per int32 word (little-endian), positions delta-coded per TU.  A
// running position P starts at -1; an entry with val != 0 (high nibble,
// 4-bit signed) advances P by dpos+1 (low nibble + 1) and writes val at
// P; a zero byte advances P by 15 and writes nothing.  coff[t] ..
// coff[t+1] are TU t's entries (any offsets; the feed's are multiples of
// 4); entries past the stream's end and positions >= S*S are dropped.
//
// What bounds it on the card: device memory.  It reads about one byte per
// coded coefficient and writes every dense level, so the store of the
// levels (the whole picture's samples at 4 bytes each) is nearly all of
// the bytes.  Design: each CTA owns a tile of consecutive TUs of one bin
// in shared memory.  It zeroes the tile and loads the tile's coff run
// (coalesced), then groups of `lanes` lanes decode one TU each: a lane
// loads whole words and decodes their four entries, a group scan of the
// per-word advances gives each entry's position, and the nonzero levels
// go into the tile.  After a barrier the tile leaves with 16-byte stores.
// Every output level, padding TUs included, is written exactly once, so
// the output needs no fill; CTA 0 also zeroes the scratch element after
// the last bin, where the caller's escape corrections send padding rows.
// The TPU kernel's DMA windows and one-hot MXU matmul do not carry over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 4;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 48 * 1024;  // static limit without an opt-in

struct Bin {
  const uint32_t* cv;    // the bin's CSR words
  const int32_t* coff;   // [>= N + 1] entry offsets
  long long n_entries;   // 4 x the words of cv
  long long out_off;     // the bin's first level in out
  int N, S;
  int tus;               // TUs of a CTA's tile
  int lanes;             // lanes that decode one TU: 1, 2, ..., 32
  int first_cta;         // set by the launcher
};

struct Args {
  Bin bin[kMaxBins];
  int nbins;
  int32_t* out;          // levels of all bins, then the scratch element
  long long total;       // levels of all bins
  int threads;
};

__global__ void __launch_bounds__(kMaxThreads)
densify_bins_kernel(const Args a) {
  extern __shared__ int4 smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) a.out[a.total] = 0;
  Bin b = a.bin[0];
#pragma unroll
  for (int i = 1; i < kMaxBins; ++i)
    if (i < a.nbins && (int)blockIdx.x >= a.bin[i].first_cta) b = a.bin[i];
  const int ss = b.S * b.S;
  const long long t0 = (long long)((int)blockIdx.x - b.first_cta) * b.tus;
  if (t0 >= b.N) return;  // the one CTA of a launch whose bins are empty
  const int nt = (int)min((long long)b.tus, (long long)b.N - t0);
  const int n4 = nt * ss / 4;  // ss is a multiple of 16
  int* tile = reinterpret_cast<int*>(smem);
  int* toff = tile + b.tus * ss;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    smem[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i <= nt; i += blockDim.x)
    toff[i] = b.coff[t0 + i];
  __syncthreads();

  const int lg = __ffs(b.lanes) - 1;
  const int L = 1 << lg;
  const int sl = threadIdx.x & (L - 1);
  const int sub = threadIdx.x >> lg;
  const int nsub = blockDim.x >> lg;
  // The trip counts are uniform over a warp (the TU loop over the CTA,
  // the word loop by a warp maximum), so the shuffles see every lane.
  for (int k0 = 0; k0 < nt; k0 += nsub) {
    const int t = k0 + sub;
    long long beg = 0, end = 0;
    if (t < nt) {
      beg = toff[t];
      end = min((long long)toff[t + 1], b.n_entries);
    }
    const long long w0 = beg >> 2;
    const int nw = end > beg ? (int)(((end + 3) >> 2) - w0) : 0;
    const int iters = __reduce_max_sync(0xffffffffu, (nw + L - 1) >> lg);
    int* dst = tile + t * ss;
    int carry = -1;  // the TU's position before the group's next word
    for (int it = 0; it < iters; ++it) {
      const int wi = (it << lg) + sl;
      const uint32_t word = wi < nw ? __ldg(b.cv + w0 + wi) : 0u;
      const long long j0 = (w0 + wi) << 2;
      int step[4], val[4], sum = 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const unsigned e = (word >> (8 * h)) & 0xFFu;
        const bool ok = wi < nw && j0 + h >= beg && j0 + h < end;
        val[h] = ok ? (int)((e >> 4) ^ 8u) - 8 : 0;
        step[h] = ok ? (val[h] == 0 ? 15 : (int)(e & 0xFu) + 1) : 0;
        sum += step[h];
      }
      int incl = sum;
      for (int d = 1; d < L; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d, L);
        if (sl >= d) incl += v;
      }
      int p = carry + incl - sum;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        p += step[h];
        if (val[h] != 0 && p < ss) dst[p] = val[h];  // p >= 0 here
      }
      carry += __shfl_sync(0xffffffffu, incl, L - 1, L);
    }
  }
  __syncthreads();
  int4* out4 = reinterpret_cast<int4*>(a.out + b.out_off + t0 * ss);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) out4[i] = smem[i];
}

}  // namespace

// out must be 16-byte aligned: every bin's levels start at a multiple of
// 16 of them (S*S is), so every tile's store is aligned too.
extern "C" int tde_densify_bins(const void* args, void* stream) {
  Args a = *static_cast<const Args*>(args);
  if (a.nbins < 0 || a.nbins > kMaxBins || a.threads < 32 ||
      a.threads > kMaxThreads || a.threads % 32 ||
      reinterpret_cast<uintptr_t>(a.out) % 16)
    return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  size_t smem = 0;
  for (int i = 0; i < a.nbins; ++i) {
    Bin& b = a.bin[i];
    const int ss = b.S * b.S;
    if (b.N < 0 || b.tus < 1 || b.lanes < 1 || b.lanes > 32 ||
        (b.lanes & (b.lanes - 1)) || ss % 16 || b.out_off % 16 ||
        a.threads % b.lanes)
      return (int)cudaErrorInvalidValue;
    b.first_cta = (int)ctas;
    ctas += (b.N + b.tus - 1) / b.tus;
    const size_t need = (size_t)b.tus * ss * 4 + ((size_t)b.tus + 1) * 4;
    if (b.N > 0 && need > smem) smem = need;
  }
  if (smem > (size_t)kMaxSmem || ctas >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  densify_bins_kernel<<<(unsigned)(ctas > 0 ? ctas : 1), a.threads, smem,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The residual bins: dequantisation and inverse transform of every TU size
// bin of a picture in one launch, written over B4's levels in place.
//
// Replaces no TPU kernel: the JAX program does this work with XLA ops
// (libde265_tpu/ops/transform.py residual_batch; the escape corrections,
// the bypass select and RDPCM in libde265_tpu/fused_decode.py).  Per TU,
// as ops/transform.py computes it (spec 8.6.2-8.6.4, 8.6.8):
//   1. the bin's escape corrections: cfx is sorted (TU row, then sample)
//      with the padding rows (-1) last, so a CTA finds the run of its TUs
//      by two warp-wide 32-ary searches (-1 compares as the largest
//      unsigned value); the positions are distinct;
//   2. dequantisation at the TU's channel depth: flat, (level * fact +
//      offset) >> bdShift, or with a scaling list the shift split of
//      residual_batch; clipped to 16 bits.  The products wrap at 32 bits
//      as PyTorch's int32 arithmetic does;
//   3. the inverse transform in int32: stage 1 down the columns, (sum +
//      64) >> 7 clipped to 16 bits; stage 2 along the rows, (sum + rnd) >>
//      (20 - bd); the DST for flagged 4x4 TUs only.  Every sum is exact:
//      |sum| <= 32 * 90 * 32768 + 64 < 2^31.  Transform-skip TUs take
//      ((c << (5 + lg)) + rnd) >> (20 - bd), bypass TUs keep their levels,
//      and RDPCM turns either into prefix sums down the columns or along
//      the rows where the TU is flagged;
//   4. the residual written over its levels.
//
// What bounds it on the card: device memory.  Each TU sample's level is
// read once and its residual written once, 8 bytes a sample (and 16 bytes
// of parameters a TU, 8 an escape), over 3.35 TB/s.  Not float64, as the
// PyTorch formulation computes it: two GEMMs and four casts a bin, at a
// fraction of the int32 rate.  Not the tensor cores: the coefficients are
// 16-bit, so int8 IMMA is not exact, while int32 sums on the CUDA cores
// are exact and cost little next to the bytes.
//
// Design: a CTA owns a tile of 1024 samples, 1024 / S^2 consecutive TUs of
// one bin, in shared memory, and each of its 256 threads owns four
// consecutive samples of one row.  The levels arrive by 16-byte loads; the
// escapes are added; each thread dequantises its samples in place and
// notes the last nonzero row and column of a transformed TU.  In stage 1 a
// thread sums four rows of one column (the S-point matrix in shared
// memory, read as 16-byte rows), for columns up to the TU's last nonzero
// one and over rows up to its last nonzero one; in stage 2 it sums its own
// four samples over columns up to the last nonzero one (a zero column of
// the coefficients is a zero column after stage 1), and they leave by one
// 16-byte store.  The stage-1 rows are padded by one word, so stage 2's
// reads of four rows fall in four banks.

namespace {

constexpr int kResTile = 1024;               // samples of a CTA's tile
constexpr int kResThreads = kResTile / 4;    // four samples a thread
constexpr int kResMaxTus = kResTile / 16;    // 4x4 TUs of a tile

// spec 8.6.4.2 transMatrix (libde265_tpu_torch/ops/transform.py DCT32)
__device__ const signed char kDct32[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4, -4, -13,
     -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
     89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
     -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
     -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
     83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38, -38,
     -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
     -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
     46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
     75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
     -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
     61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
     64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
     -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
     -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
     73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
     50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78, -78,
     -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
     -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
     82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
     36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
     -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
     -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
     88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
     18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
     -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9, -9,
     25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
     90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4},
};
__constant__ int kDst4[16] = {29, 55, 74, 84, 74, 74, 0, -74,
                              84, -29, -74, 55, 55, -84, 74, -29};
__constant__ int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// TU flags (libde265_tpu_torch/decoder.py TU_*)
constexpr int kFlagSkip = 1, kFlagBypass = 2, kFlagDst = 4, kFlagRdpcm = 8,
              kFlagRdpcmVertical = 16;
enum { kDct = 0, kDst = 1, kSkip = 2, kBypass = 3 };

struct ResBin {
  int32_t* res;          // [N, S, S]: levels in, residuals out
  const int32_t* qp;     // [N] QP' of each TU
  const int32_t* flags;  // [N] TU flags
  const int32_t* mid;    // [N] the TU's row of sf
  const int32_t* cidx;   // [N] channel of each TU, or null: every TU at bd
  const int32_t* cfx;    // [n_cf] escape positions in the bin, sorted
  const int32_t* cfv;    // [n_cf] their deltas
  const int32_t* sf;     // [n_sf, S, S] scaling factors, or null: flat
  int n_cf, n_sf;
  int N, lg;
  int first_cta;         // set by the launcher
};

struct ResArgs {
  ResBin bin[kMaxBins];
  int nbins;
  int bd, bdc;           // luma and chroma bit depths
};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// The first k in [0, n] with (unsigned)v[k] >= x, v ascending as unsigned.
// Every lane of a warp calls it and gets the answer; each round probes 32
// evenly spaced entries and keeps the span between the last one below x
// and the next.
__device__ int warp_lower_bound(const int32_t* v, int n, unsigned x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int chunk = (hi - lo + 31) >> 5;
    const int p = lo + lane * chunk;
    const bool below = p < hi && (unsigned)__ldg(v + p) < x;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(lo + c * chunk, hi);
      lo += (c - 1) * chunk + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kResThreads)
residual_bins_kernel(const ResArgs a) {
  __shared__ int4 lv4[kResTile / 4];           // levels, then coefficients
  __shared__ int gs[kResTile + kResTile / 4];  // stage 1, rows of S + 1
  __shared__ int4 mat4[kResTile / 4];          // the S-point matrix [j][i]
  __shared__ int4 dst4[4];
  __shared__ int tu_kind[kResMaxTus], tu_rd[kResMaxTus], tu_mul[kResMaxTus],
      tu_sh[kResMaxTus], tu_sh2[kResMaxTus], tu_sf[kResMaxTus],
      tu_last_r[kResMaxTus], tu_last_c[kResMaxTus];
  __shared__ int esc[2];
  ResBin b = a.bin[0];
#pragma unroll
  for (int i = 1; i < kMaxBins; ++i)
    if (i < a.nbins && (int)blockIdx.x >= a.bin[i].first_cta) b = a.bin[i];
  const int lg = b.lg, S = 1 << lg, ss = S * S;
  const int tus = kResTile >> (2 * lg);
  const int t0 = ((int)blockIdx.x - b.first_cta) * tus;
  if (t0 >= b.N) return;  // the one CTA of a launch whose bins are empty
  const int nt = min(tus, b.N - t0);
  const int tid = threadIdx.x;
  const int e = 4 * tid;  // this thread's samples: e .. e + 3 of the tile
  const bool mine = e < nt * ss;
  int32_t* res = b.res + (long long)t0 * ss;
  int* lv = reinterpret_cast<int*>(lv4);
  int* mat = reinterpret_cast<int*>(mat4);

  if (mine) lv4[tid] = *reinterpret_cast<const int4*>(res + e);
  const int step = 32 >> lg;
  for (int k = tid; k < ss; k += kResThreads)
    mat[k] = kDct32[(k >> lg) * step][k & (S - 1)];
  if (lg == 2 && tid < 16) reinterpret_cast<int*>(dst4)[tid] = kDst4[tid];
  if (tid < nt) {
    const int u = t0 + tid;
    const int f = __ldg(b.flags + u), q = __ldg(b.qp + u);
    const int bdt = b.cidx != nullptr && __ldg(b.cidx + u) != 0 ? a.bdc
                                                                 : a.bd;
    const int qm = (q % 6 + 6) % 6, qd = (q - qm) / 6;  // as Python's % //
    const bool skip = f & kFlagSkip, byp = f & kFlagBypass;
    tu_kind[tid] = byp ? kBypass : skip ? kSkip
                 : lg == 2 && (f & kFlagDst) ? kDst : kDct;
    tu_rd[tid] = (f & kFlagRdpcm) && (skip || byp)
                     ? ((f & kFlagRdpcmVertical) ? 2 : 1) : 0;
    tu_sh2[tid] = 20 - bdt;
    if (b.sf != nullptr) {
      tu_mul[tid] = kLevelScale[qm];
      tu_sh[tid] = bdt + lg - 5 - qd;
      tu_sf[tid] = min(max(__ldg(b.mid + u), 0), b.n_sf - 1);
    } else {
      tu_mul[tid] = (int)((unsigned)kLevelScale[qm] << (qd & 31));
      tu_sh[tid] = bdt + lg - 9;
      tu_sf[tid] = -1;
    }
    tu_last_r[tid] = tu_last_c[tid] = -1;
  }
  if (b.n_cf > 0 && tid < 64) {  // warp 0: the run's start, warp 1: its end
    const long long key = (long long)(t0 + (tid >> 5) * nt) * ss;
    const int k = warp_lower_bound(b.cfx, b.n_cf, (unsigned)key);
    if ((tid & 31) == 0) esc[tid >> 5] = k;
  }
  __syncthreads();

  if (b.n_cf > 0) {
    const int lo = t0 * ss;
    for (int k = esc[0] + tid; k < esc[1]; k += kResThreads) {
      const int p = __ldg(b.cfx + k) - lo;
      lv[p] = (int)((unsigned)lv[p] + (unsigned)__ldg(b.cfv + k));
    }
    __syncthreads();
  }

  // dequantisation of this thread's samples: TU t, row y, columns x0 ..
  const int t = e >> (2 * lg);
  const int y = (e >> lg) & (S - 1);
  const int x0 = e & (S - 1);
  if (mine && tu_kind[t] != kBypass) {
    const int4 v = lv4[tid];
    int c[4] = {v.x, v.y, v.z, v.w};
    const int mul = tu_mul[t], sh = tu_sh[t], row = tu_sf[t];
    int last = -1;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      int d;
      if (row < 0) {
        d = (int)((unsigned)c[h] * (unsigned)mul + (1u << (sh - 1))) >> sh;
      } else {
        const int m = __ldg(b.sf + (long long)row * ss + (e & (ss - 1)) + h)
                      * mul;
        const unsigned p = (unsigned)c[h] * (unsigned)m;
        d = sh > 0 ? (int)(p + (1u << (sh - 1))) >> sh : (int)(p << -sh);
      }
      c[h] = clip16(d);
      if (c[h] != 0) last = h;
    }
    lv4[tid] = make_int4(c[0], c[1], c[2], c[3]);
    if (last >= 0 && tu_kind[t] <= kDst) {
      atomicMax(&tu_last_r[t], y);
      atomicMax(&tu_last_c[t], x0 + last);
    }
  }
  __syncthreads();

  // stage 1: rows i1 .. i1 + 3 of column c1 of TU t1
  {
    const int c1 = tid & (S - 1);
    const int i1 = ((tid >> lg) & ((S >> 2) - 1)) << 2;
    const int t1 = tid >> (2 * lg - 2);
    if (t1 < nt && tu_kind[t1] <= kDst && c1 <= tu_last_c[t1]) {
      const int4* m4 = tu_kind[t1] == kDst ? dst4 : mat4;
      const int* col = lv + t1 * ss + c1;
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (int j = 0, jn = tu_last_r[t1]; j <= jn; ++j) {
        const int v = col[j << lg];
        const int4 w = m4[((j << lg) + i1) >> 2];
        s0 += v * w.x;
        s1 += v * w.y;
        s2 += v * w.z;
        s3 += v * w.w;
      }
      int* g = gs + t1 * S * (S + 1) + i1 * (S + 1) + c1;
      g[0] = clip16((s0 + 64) >> 7);
      g[S + 1] = clip16((s1 + 64) >> 7);
      g[2 * (S + 1)] = clip16((s2 + 64) >> 7);
      g[3 * (S + 1)] = clip16((s3 + 64) >> 7);
    }
  }
  __syncthreads();

  // stage 2 (or transform skip, bypass, RDPCM) and the store
  if (mine) {
    const int kind = tu_kind[t], sh2 = tu_sh2[t];
    const int rnd = 1 << (sh2 - 1);
    int r[4];
    if (kind <= kDst) {
      const int4* m4 = kind == kDst ? dst4 : mat4;
      const int* g = gs + t * S * (S + 1) + y * (S + 1);
      int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
      for (int j = 0, jn = tu_last_c[t]; j <= jn; ++j) {
        const int v = g[j];
        const int4 w = m4[((j << lg) + x0) >> 2];
        s0 += v * w.x;
        s1 += v * w.y;
        s2 += v * w.z;
        s3 += v * w.w;
      }
      r[0] = (s0 + rnd) >> sh2;
      r[1] = (s1 + rnd) >> sh2;
      r[2] = (s2 + rnd) >> sh2;
      r[3] = (s3 + rnd) >> sh2;
    } else {
      const int* tu = lv + t * ss;
      const int ts = 5 + lg;
      auto base = [&](int yy, int xx) -> unsigned {
        const int v = tu[(yy << lg) + xx];
        return kind == kBypass
                   ? (unsigned)v
                   : (unsigned)((int)(((unsigned)v << ts) + (unsigned)rnd)
                                >> sh2);
      };
      const int rd = tu_rd[t];
      if (rd == 0) {
#pragma unroll
        for (int h = 0; h < 4; ++h) r[h] = (int)base(y, x0 + h);
      } else if (rd == 1) {  // along the row
        unsigned acc = 0;
        for (int x = 0; x < x0; ++x) acc += base(y, x);
#pragma unroll
        for (int h = 0; h < 4; ++h) r[h] = (int)(acc += base(y, x0 + h));
      } else {               // down the column
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          unsigned acc = 0;
          for (int yy = 0; yy <= y; ++yy) acc += base(yy, x0 + h);
          r[h] = (int)acc;
        }
      }
    }
    *reinterpret_cast<int4*>(res + e) = make_int4(r[0], r[1], r[2], r[3]);
  }
}

}  // namespace

// Every bin's res must be 16-byte aligned (B4's buffer and views are).
extern "C" int tde_residual_bins(const void* args, void* stream) {
  ResArgs a = *static_cast<const ResArgs*>(args);
  if (a.nbins < 1 || a.nbins > kMaxBins || a.bd < 8 || a.bd > 16 ||
      a.bdc < 8 || a.bdc > 16)
    return (int)cudaErrorInvalidValue;
  long long ctas = 0;
  for (int i = 0; i < a.nbins; ++i) {
    ResBin& b = a.bin[i];
    if (b.lg < 2 || b.lg > 5 || b.N < 0 || b.n_cf < 0 ||
        (b.sf != nullptr && b.n_sf < 1) ||
        reinterpret_cast<uintptr_t>(b.res) % 16 ||
        ((long long)b.N << (2 * b.lg)) >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    b.first_cta = (int)ctas;
    const int tus = kResTile >> (2 * b.lg);
    ctas += (b.N + tus - 1) / tus;
  }
  if (ctas >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  residual_bins_kernel<<<(unsigned)(ctas > 0 ? ctas : 1), kResThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
