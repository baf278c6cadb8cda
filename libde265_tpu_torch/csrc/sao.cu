// Kernel B10: per-sample SAO (spec 8.7.3).
//
// Replaces the TPU kernel libde265_tpu/ops/sao_pallas.py:sao_plane_fused
// (sao_plane_pallas, _kernel) together with its neighbour pre-pass
// sao_neighbors_jnp.  Same arguments as ops/sao.sao_plane: the plane and
// per-sample type, edge class, band position and four offsets, the skip
// mask and the optional slice/tile edge mask.
//
// Design: one thread per sample.  The thread resolves its two edge-class
// neighbours from EO_D itself (edge-replicated reads, invalid outside the
// picture), so the na/nb planes and the (8, 128) tile padding of the TPU
// version do not exist.  Band offset: k = ((s >> (bd-5)) - band) & 31 and
// offset k if k < 4.  Edge offset: category from sign(s-na) + sign(s-nb).
// Skipped samples and type 0 pass through; the rest are clipped.  The pass
// is bound by device memory: about 36 bytes of maps read per sample.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kEoD[4][4] = {
    {0, -1, 0, 1}, {-1, 0, 1, 0}, {-1, -1, 1, 1}, {1, -1, -1, 1}};
__constant__ int kEdgeCat[5] = {1, 2, 0, 3, 4};

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__global__ void sao_kernel(const int32_t* __restrict__ src,
                           const int32_t* __restrict__ tmap,
                           const int32_t* __restrict__ emap,
                           const int32_t* __restrict__ bmap,
                           const int32_t* __restrict__ omap,
                           const uint8_t* __restrict__ skip,
                           const uint8_t* __restrict__ edge_ok,
                           int32_t* __restrict__ out, int H, int W,
                           int bit_depth) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int s = src[i];
  const int type = tmap[i];
  if (skip[i] || type == 0) {
    out[i] = s;
    return;
  }
  const int maxv = (1 << bit_depth) - 1;
  const int32_t* o = omap + 4 * i;
  int res = s;
  if (type == 1) {
    const int k = ((s >> (bit_depth - 5)) - bmap[i]) & 31;
    res = s + (k < 4 ? o[k] : 0);
  } else if (type == 2) {
    const int y = (int)(i / W), x = (int)(i % W);
    const int cls = emap[i];
    int na = 0, nb = 0;
    bool valid = true;
    if (cls >= 0 && cls < 4) {
      const int ya = y + kEoD[cls][0], xa = x + kEoD[cls][1];
      const int yb = y + kEoD[cls][2], xb = x + kEoD[cls][3];
      valid = ya >= 0 && ya < H && xa >= 0 && xa < W && yb >= 0 && yb < H &&
              xb >= 0 && xb < W;
      na = src[(long long)min(max(ya, 0), H - 1) * W + min(max(xa, 0), W - 1)];
      nb = src[(long long)min(max(yb, 0), H - 1) * W + min(max(xb, 0), W - 1)];
    }
    if (edge_ok != nullptr && !edge_ok[i]) valid = false;
    const int cat = kEdgeCat[2 + sgn(s - na) + sgn(s - nb)];
    if (cat > 0 && valid) res = s + o[cat - 1];
  }
  out[i] = res < 0 ? 0 : (res > maxv ? maxv : res);
}

}  // namespace

extern "C" int tde_sao_plane(const void* src, const void* tmap,
                             const void* emap, const void* bmap,
                             const void* omap, const void* skip,
                             const void* edge_ok, void* out, int H, int W,
                             int bit_depth, void* stream) {
  const long long n = (long long)H * W;
  if (n <= 0) return 0;
  const int threads = 256;
  sao_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
               (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)tmap, (const int32_t*)emap,
      (const int32_t*)bmap, (const int32_t*)omap, (const uint8_t*)skip,
      (const uint8_t*)edge_ok, (int32_t*)out, H, W, bit_depth);
  return (int)cudaGetLastError();
}
