// Kernel B1: rebuild the int32 picture feed from its uploaded nonzero
// blocks.
//
// Replaces the TPU kernel libde265_tpu/fused_decode.py:
// _expand_blocks_pallas (_expand_kernel).  The host ships only the feed's
// blocks of B words that hold a nonzero word (blocks [M, B]) and the
// inverse map inv [nb]: output block b is compact row inv[b], or zeros
// when inv[b] < 0 or inv[b] >= M; the last block stops at `total`.
//
// Bound by device memory: it reads the compact rows that inv names and
// writes the whole feed once (about 2 MB read and 3 MB written per 1080p
// picture, some 1.5 us at 3.35 TB/s).  Design for Hopper:
//   * a CTA of T threads owns PER consecutive output blocks; one thread
//     reads each block's inv entry once into shared memory;
//   * every load and store moves 16 bytes (int4), each thread issuing U
//     loads before its stores, so a thread keeps U requests in flight;
//   * an output block with no compact row is stores of zeros only;
//   * the last block's words past its last whole int4 (total % 4) are
//     scalar stores by the first threads.
// B must be a multiple of 4 and blocks and out 16-byte aligned (the wrapper
// raises otherwise; tde_expand_blocks refuses them too).  The arguments
// come in one struct (Args, ops/expand.py _Args), which costs the host less
// to pass through ctypes than eight converted arguments.  The stores keep
// the default cache policy: the picture program reads the 3 MB feed right
// after, and it fits the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const void* blocks;    // [M, B] int32 compact rows
  const void* inv;       // [nb] int32 inverse map
  void* out;             // [total] int32 feed
  long long total;
  int M, nb, B;
  int threads;           // 64, 128 or 256 a CTA
  int per;               // 1, 2 or 4 output blocks a CTA
};

constexpr int U = 4;    // 16-byte loads in flight per thread

template <int T, int PER>
__global__ void __launch_bounds__(T)
expand_kernel(const int4* __restrict__ blocks, int M,
              const int32_t* __restrict__ inv, int nb,
              int4* __restrict__ out, long long total, int B4) {
  __shared__ int rows[PER];
  const long long b0 = (long long)blockIdx.x * PER;
  if (threadIdx.x < PER) {
    const long long b = b0 + threadIdx.x;
    const int r = b < nb ? inv[b] : -1;
    rows[threadIdx.x] = (r >= 0 && r < M) ? r : -1;
  }
  __syncthreads();
  for (int p = 0; p < PER; ++p) {
    const long long b = b0 + p;
    if (b >= nb) break;
    // words of this block below total: B, or fewer in the last block
    const long long left = total - b * B4 * 4;
    const int n = left < (long long)B4 * 4 ? (int)left : B4 * 4;
    const int n4 = n >> 2;
    int4* dst = out + b * B4;
    const int r = rows[p];
    const int4* src = blocks + (long long)(r < 0 ? 0 : r) * B4;
    if (r < 0) {
      const int4 z = make_int4(0, 0, 0, 0);
      for (int i = threadIdx.x; i < n4; i += T) dst[i] = z;
    } else {
      for (int i0 = threadIdx.x; i0 < n4; i0 += U * T) {
        int4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u * T < n4) v[u] = src[i0 + u * T];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u * T < n4) dst[i0 + u * T] = v[u];
      }
    }
    if (threadIdx.x < (n & 3)) {
      const int k = n4 * 4 + threadIdx.x;
      reinterpret_cast<int32_t*>(dst)[k] =
          r < 0 ? 0 : reinterpret_cast<const int32_t*>(src)[k];
    }
  }
}

template <int T, int PER>
int launch(const Args& a, cudaStream_t s) {
  expand_kernel<T, PER><<<(unsigned)((a.nb + PER - 1) / PER), T, 0, s>>>(
      (const int4*)a.blocks, a.M, (const int32_t*)a.inv, a.nb, (int4*)a.out,
      a.total, a.B / 4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tde_expand_blocks(const void* args, void* stream) {
  const Args* a = (const Args*)args;
  if (a->nb <= 0 || a->total <= 0) return 0;
  if (a->B <= 0 || a->B % 4 != 0 ||
      (((uintptr_t)a->blocks | (uintptr_t)a->out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TDE_EXPAND(T, PER) \
  if (a->threads == T && a->per == PER) return launch<T, PER>(*a, s);
  TDE_EXPAND(64, 1) TDE_EXPAND(64, 2) TDE_EXPAND(64, 4)
  TDE_EXPAND(128, 1) TDE_EXPAND(128, 2) TDE_EXPAND(128, 4)
  TDE_EXPAND(256, 1) TDE_EXPAND(256, 2) TDE_EXPAND(256, 4)
#undef TDE_EXPAND
  return (int)cudaErrorInvalidConfiguration;
}
