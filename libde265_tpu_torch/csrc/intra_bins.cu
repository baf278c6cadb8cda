// The intra records of a picture into the persistent scan's per-bin arrays
// (tde_intra_bins): one memset of the arena and one launch.
//
// Replaces no TPU kernel: the JAX program scatters the flat records with
// XLA ops (libde265_tpu/fused_decode.py _scatter_intra_bins, three
// .at[].set per (plane, size) bin), and the port ran the same composition
// as some 22 PyTorch ops a bin (ops/intra_cuda.py scatter_records), after
// a device unpack of the wire records into 15 columns.  Here every bin of
// a picture is written in one pass over the wire records themselves.
//
// Input: the wire-compact records [8, pitch] int32, column-major
// (feed._pack_irec), of which columns [0, n) are read:
//   w0 = mode(6) | edge(4)<<6 | flags(4)<<10 | cidx(2)<<14 | lg(3)<<16 |
//        step(13)<<19;  w1 = y0(16) | x0(16)<<16;
//   w2 = (rrow + 1)(22) | slot(10)<<22;  w3..w7 = availability words.
// Output, per (plane c, size lg) bin b = 4c + lg - 2 with K[b] > 0: meta
// [scap, K, 5] (mode, edge, y0, x0, flags), rrow [scap, K] and aw [scap, K,
// aw_words] at the arena's word offsets meta[b], rrow[b], aw[b].  A record
// goes to (step, slot) of its bin; one of no bin, with step >= scap or with
// slot >= K is dropped (the zero padding records have lg 0: no bin).  An
// unused slot holds 0 in meta and aw and -1 in rrow.
//
// The records come in parse order, not in slot order, so no thread knows
// which slots stay empty, and the clear cannot be folded into the scatter
// without a grid-wide barrier.  So cudaMemsetAsync sets the arena to 0;
// then one launch adds -1 to every rrow element (all bins' rrow arrays lie
// in one run of the arena) while each record adds rrow + 1 to its own and
// stores its meta and aw words.  Integer adds commute, so an empty slot
// ends at -1 and a filled one at its rrow in any order (the scheduler gives
// each (step, slot) of a bin at most one record).
//
// Bound: device memory.  The memset writes the whole arena (11 words a
// slot: about 61 MB for a 1080p picture's ten bins at 1024 steps, some
// 18 us at 3.35 TB/s), the records are read once (32 bytes each, coalesced
// by word), and the rrow run is read and written once more through L2
// atomics (adjacent threads, adjacent words).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 12;      // bin 4c + lg - 2 of plane c, size 1 << lg
constexpr int kThreads = 256;
constexpr int kMaxAwWords = 5;

// Passed by value (ops/intra_cuda.py _BinArgs).
struct BinArgs {
  const int32_t* rec;       // [8, pitch] wire records
  long long pitch;
  int n;                    // records read: columns [0, n)
  int scap;                 // steps of every bin
  int32_t* arena;
  long long arena_words;    // set to 0 before the launch
  long long rrow_at;        // the run of every bin's rrow array
  long long rrow_words;
  long long meta[kBins], rrow[kBins], aw[kBins];  // word offsets
  int K[kBins];             // slots a step; 0: no such bin
  int aw_words;
};

// Threads [0, n) scatter record u; threads [n, n + rrow_words) add -1 to
// rrow element u - n.
__global__ void __launch_bounds__(kThreads) intra_bins_kernel(const BinArgs a) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= a.n) {
    if (u - a.n < a.rrow_words) atomicAdd(a.arena + a.rrow_at + (u - a.n), -1);
    return;
  }
  const uint32_t w0 = (uint32_t)__ldg(a.rec + u);
  const int c = (w0 >> 14) & 3, lg = (w0 >> 16) & 7, step = (int)(w0 >> 19);
  if (c > 2 || lg < 2 || lg > 5) return;
  const int b = 4 * c + lg - 2;
  const int K = a.K[b];
  const uint32_t w2 = (uint32_t)__ldg(a.rec + 2 * a.pitch + u);
  const int slot = (int)(w2 >> 22);
  if (K == 0 || step >= a.scap || slot >= K) return;
  const long long e = (long long)step * K + slot;
  const uint32_t w1 = (uint32_t)__ldg(a.rec + a.pitch + u);
  int32_t* m = a.arena + a.meta[b] + 5 * e;
  m[0] = w0 & 63;
  m[1] = (w0 >> 6) & 15;
  m[2] = w1 & 0xFFFF;
  m[3] = w1 >> 16;
  m[4] = (w0 >> 10) & 15;
  atomicAdd(a.arena + a.rrow[b] + e, (int)(w2 & 0x3FFFFF));
  int32_t* w = a.arena + a.aw[b] + (long long)a.aw_words * e;
  for (int j = 0; j < a.aw_words; ++j)
    w[j] = __ldg(a.rec + (3 + j) * a.pitch + u);
}

}  // namespace

// The arena cleared, then the records scattered: two device operations on
// `stream`, no synchronisation.
extern "C" int tde_intra_bins(const void* args, void* stream) {
  const BinArgs& a = *(const BinArgs*)args;
  if (a.n < 0 || a.n > a.pitch || a.scap < 0 || a.aw_words < 0 ||
      a.aw_words > kMaxAwWords || a.arena_words < 0 || a.rrow_words < 0 ||
      a.rrow_at < 0 || a.rrow_at + a.rrow_words > a.arena_words ||
      ((uintptr_t)a.arena & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.arena_words > 0) {
    const cudaError_t e =
        cudaMemsetAsync(a.arena, 0, (size_t)a.arena_words * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (long long)a.n + a.rrow_words;
  if (total == 0) return 0;
  intra_bins_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(a);
  return (int)cudaGetLastError();
}
