// Kernel B1: rebuild the int32 picture feed from its uploaded nonzero
// blocks.
//
// Replaces the TPU kernel libde265_tpu/fused_decode.py:
// _expand_blocks_pallas (_expand_kernel).  The host ships only the feed's
// blocks of B words that hold a nonzero word (blocks [M, B]) and the
// inverse map inv [nb]: output block b is compact row inv[b], or zeros
// when inv[b] < 0.  One CTA per output block copies its row (or writes
// zeros); the last block stops at `total`.  Bound by device memory: it
// reads the M compact blocks and writes the whole feed once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_kernel(const int32_t* __restrict__ blocks, int M,
                              const int32_t* __restrict__ inv,
                              int32_t* __restrict__ out, long long total,
                              int B) {
  const long long b = blockIdx.x;
  const int row = inv[b];
  const int32_t* src = (row >= 0 && row < M) ? blocks + (long long)row * B
                                             : nullptr;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const long long o = b * B + i;
    if (o < total) out[o] = src ? src[i] : 0;
  }
}

}  // namespace

extern "C" int tde_expand_blocks(const void* blocks, int M, const void* inv,
                                 int nb, void* out, long long total, int B,
                                 void* stream) {
  if (nb <= 0 || total <= 0) return 0;
  expand_kernel<<<(unsigned)nb, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)blocks, M, (const int32_t*)inv, (int32_t*)out, total,
      B);
  return (int)cudaGetLastError();
}
