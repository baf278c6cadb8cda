// Kernel B4: the CSR coefficient streams of a picture's TU size bins ->
// dense [N, S, S] int32 levels, every bin in one launch.
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
