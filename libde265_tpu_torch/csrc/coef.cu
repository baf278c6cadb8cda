// Kernel B4: CSR coefficient stream -> dense [N, S, S] int32 levels.
//
// Replaces the TPU kernel libde265_tpu/ops/coef_pallas.py:densify_bin
// (_densify_kernel).  Same input: one size bin's CSR stream of 8-bit
// entries, four per int32 word (little-endian), positions delta-coded per
// TU.  A running position P starts at -1; an entry with val != 0 (high
// nibble, 4-bit signed) advances P by dpos+1 (low nibble + 1) and writes
// val at P; a zero byte advances P by 15 and writes nothing.  coff[t] ..
// coff[t+1] are TU t's entries.  Positions >= S*S are dropped.
//
// Design: one warp per TU.  Each lane decodes one entry; a warp inclusive
// scan of the per-entry advance gives every entry's position, and the
// warp's running sum carries into the next 32 entries.  The output is
// zero-filled by the caller and written sparsely.  The pass is bound by
// device memory: it reads ~1 byte per coded coefficient and writes the
// nonzero levels; the zero fill of [N, S, S] dominates the bytes moved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void densify_kernel(const uint32_t* __restrict__ cv,
                               long long n_entries,
                               const int32_t* __restrict__ coff,
                               int32_t* __restrict__ out, int N, int S) {
  const int lane = threadIdx.x & 31;
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (t >= N) return;  // uniform per warp
  long long beg = coff[t];
  long long end = coff[t + 1];
  if (end > n_entries) end = n_entries;
  const int ss = S * S;
  int32_t* dst = out + t * (long long)ss;
  int carry = -1;
  for (long long base = beg; base < end; base += 32) {
    const long long j = base + lane;
    int step = 0, val = 0;
    if (j < end) {
      const uint32_t e = (cv[j >> 2] >> (8 * (int)(j & 3))) & 0xFFu;
      val = (int)((e >> 4) ^ 8u) - 8;
      step = val == 0 ? 15 : (int)(e & 0xFu) + 1;
    }
    int incl = step;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int pos = carry + incl;
    if (j < end && val != 0 && pos >= 0 && pos < ss) dst[pos] = val;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
}

}  // namespace

extern "C" int tde_densify(const void* cv, long long n_words,
                           const void* coff, void* out, int N, int S,
                           void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)N * 32 + threads - 1) / threads;
  densify_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cv, n_words * 4, (const int32_t*)coff,
      (int32_t*)out, N, S);
  return (int)cudaGetLastError();
}
