// Kernels B8 (luma) and B9 (chroma): HEVC deblocking of one edge
// orientation (spec 8.7.2.5.3 - 8.7.2.5.7).
//
// Replace the TPU kernels libde265_tpu/ops/deblock_pallas.py:luma_pass /
// luma_pass_h (_luma_kernel, _luma_body) and chroma_pass_stacked /
// chroma_pass_stacked_h (_chroma_body).  Same arguments: a padded plane
// with an 8-sample group [p3 p2 p1 p0 | q0 q1 q2 q3] at group offset 8e
// for every edge e, and per-(segment, edge) parameters.
//
// Design: one thread per (4-sample segment, edge) - and per channel for
// chroma.  The thread reads its parameters once, takes the segment's
// decisions from rows 0 and 3, and filters the segment's rows in place.
// The groups of a pass are disjoint, so threads never touch each other's
// samples and the kernel runs on one copy of the plane.  Both orientations
// use the natural layout: sample (r, g) of a pass lives at
// r * stride_r + g * stride_g, r running along the edge, g across it, and
// the parameters at seg * pstride_s + e * pstride_e.  No transposes.
// The pass is bound by device memory (each sample of a group is read once
// and at most six of eight written); the TPU kernel's roll ladders and
// per-pixel parameter broadcast have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void luma_kernel(int32_t* __restrict__ img,
                            const int32_t* __restrict__ bs,
                            const int32_t* __restrict__ beta,
                            const int32_t* __restrict__ tc,
                            const int32_t* __restrict__ no_p,
                            const int32_t* __restrict__ no_q, int nseg, int E,
                            int R, long long stride_r, long long stride_g,
                            int pstride_s, int pstride_e, int bit_depth) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nseg * E) return;
  const int e = (int)(idx % E);
  const int sg = (int)(idx / E);
  const int pi = sg * pstride_s + e * pstride_e;
  const int b = bs[pi];
  const int bt = beta[pi];
  const int t = tc[pi];
  const int r0 = 4 * sg;
  if (b <= 0 || r0 + 3 >= R) return;
  const int maxv = (1 << bit_depth) - 1;
  int32_t* base = img + (long long)r0 * stride_r + (long long)(8 * e) * stride_g;

  int v[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int m = 0; m < 8; ++m)
      v[k][m] = base[k * stride_r + m * stride_g];

  // v[k] = p3 p2 p1 p0 q0 q1 q2 q3 of row k
  const int dp0 = abs(v[0][1] - 2 * v[0][2] + v[0][3]);
  const int dp3 = abs(v[3][1] - 2 * v[3][2] + v[3][3]);
  const int dq0 = abs(v[0][6] - 2 * v[0][5] + v[0][4]);
  const int dq3 = abs(v[3][6] - 2 * v[3][5] + v[3][4]);
  const int dpq0 = dp0 + dq0;
  const int dpq3 = dp3 + dq3;
  if (!(dpq0 + dpq3 < bt)) return;

  const int tc25 = (5 * t + 1) >> 1;
  const bool s0 = (2 * dpq0 < (bt >> 2)) &&
                  (abs(v[0][0] - v[0][3]) + abs(v[0][4] - v[0][7]) < (bt >> 3)) &&
                  (abs(v[0][3] - v[0][4]) < tc25);
  const bool s3 = (2 * dpq3 < (bt >> 2)) &&
                  (abs(v[3][0] - v[3][3]) + abs(v[3][4] - v[3][7]) < (bt >> 3)) &&
                  (abs(v[3][3] - v[3][4]) < tc25);
  const bool strong = s0 && s3;
  const int side = (bt + (bt >> 1)) >> 3;
  const bool dep = (dp0 + dp3) < side;
  const bool deq = (dq0 + dq3) < side;
  const bool do_p = no_p[pi] == 0;
  const bool do_q = no_q[pi] == 0;
  const int tc2 = t >> 1;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p3 = v[k][0], p2 = v[k][1], p1 = v[k][2], p0 = v[k][3];
    const int q0 = v[k][4], q1 = v[k][5], q2 = v[k][6], q3 = v[k][7];
    int32_t* row = base + k * stride_r;
    if (strong) {
      if (do_p) {
        row[3 * stride_g] = p0 + clip3(-2 * t, 2 * t,
            ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0);
        row[2 * stride_g] = p1 + clip3(-2 * t, 2 * t,
            ((p2 + p1 + p0 + q0 + 2) >> 2) - p1);
        row[1 * stride_g] = p2 + clip3(-2 * t, 2 * t,
            ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2);
      }
      if (do_q) {
        row[4 * stride_g] = q0 + clip3(-2 * t, 2 * t,
            ((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3) - q0);
        row[5 * stride_g] = q1 + clip3(-2 * t, 2 * t,
            ((q2 + q1 + q0 + p0 + 2) >> 2) - q1);
        row[6 * stride_g] = q2 + clip3(-2 * t, 2 * t,
            ((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2);
      }
    } else {
      const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta0) < t * 10) {
        const int delta = clip3(-t, t, delta0);
        if (do_p) {
          row[3 * stride_g] = clip3(0, maxv, p0 + delta);
          if (dep)
            row[2 * stride_g] = clip3(0, maxv, p1 + clip3(-tc2, tc2,
                ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)));
        }
        if (do_q) {
          row[4 * stride_g] = clip3(0, maxv, q0 - delta);
          if (deq)
            row[5 * stride_g] = clip3(0, maxv, q1 + clip3(-tc2, tc2,
                ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)));
        }
      }
    }
  }
}

__global__ void chroma_kernel(int32_t* __restrict__ imgs,
                              const int32_t* __restrict__ tcs,
                              const int32_t* __restrict__ no_p,
                              const int32_t* __restrict__ no_q, int nseg,
                              int E, int R, int rows_per_seg,
                              long long stride_r, long long stride_g,
                              long long plane_stride, int pstride_s,
                              int pstride_e, long long tc_plane_stride,
                              int bit_depth) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_plane = (long long)nseg * E;
  if (idx >= 2 * per_plane) return;
  const int c = (int)(idx / per_plane);
  const long long rem = idx % per_plane;
  const int e = (int)(rem % E);
  const int sg = (int)(rem / E);
  const int pi = sg * pstride_s + e * pstride_e;
  const int t = tcs[c * tc_plane_stride + pi];
  if (t <= 0) return;
  const bool do_p = no_p[pi] == 0;
  const bool do_q = no_q[pi] == 0;
  const int maxv = (1 << bit_depth) - 1;
  int32_t* base = imgs + c * plane_stride + (long long)(8 * e) * stride_g;
  for (int k = 0; k < rows_per_seg; ++k) {
    const int r = sg * rows_per_seg + k;
    if (r >= R) break;
    int32_t* row = base + (long long)r * stride_r;
    const int p1 = row[0], p0 = row[stride_g];
    const int q0 = row[2 * stride_g], q1 = row[3 * stride_g];
    const int delta = clip3(-t, t, ((q0 - p0) * 4 + p1 - q1 + 4) >> 3);
    if (do_p) row[stride_g] = clip3(0, maxv, p0 + delta);
    if (do_q) row[2 * stride_g] = clip3(0, maxv, q0 - delta);
  }
}

}  // namespace

extern "C" int tde_luma_pass(void* img, const void* bs, const void* beta,
                             const void* tc, const void* no_p,
                             const void* no_q, int nseg, int E, int R,
                             long long stride_r, long long stride_g,
                             int pstride_s, int pstride_e, int bit_depth,
                             void* stream) {
  const long long n = (long long)nseg * E;
  if (n <= 0) return 0;
  const int threads = 128;
  luma_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                (cudaStream_t)stream>>>(
      (int32_t*)img, (const int32_t*)bs, (const int32_t*)beta,
      (const int32_t*)tc, (const int32_t*)no_p, (const int32_t*)no_q, nseg, E,
      R, stride_r, stride_g, pstride_s, pstride_e, bit_depth);
  return (int)cudaGetLastError();
}

extern "C" int tde_chroma_pass(void* imgs, const void* tcs, const void* no_p,
                               const void* no_q, int nseg, int E, int R,
                               int rows_per_seg, long long stride_r,
                               long long stride_g, long long plane_stride,
                               int pstride_s, int pstride_e,
                               long long tc_plane_stride, int bit_depth,
                               void* stream) {
  const long long n = 2LL * nseg * E;
  if (n <= 0) return 0;
  const int threads = 128;
  chroma_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  (cudaStream_t)stream>>>(
      (int32_t*)imgs, (const int32_t*)tcs, (const int32_t*)no_p,
      (const int32_t*)no_q, nseg, E, R, rows_per_seg, stride_r, stride_g,
      plane_stride, pstride_s, pstride_e, tc_plane_stride, bit_depth);
  return (int)cudaGetLastError();
}
