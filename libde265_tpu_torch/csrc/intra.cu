// Intra super-wave scan on the padded plane: kernels B6 (border gather),
// B7 (window scatter) and the fused step that runs both around the
// prediction.
//
// Replace the TPU kernels libde265_tpu/ops/intra_window_pallas.py
// border_gather (B6) and window_scatter (B7), and with them the XLA math of
// libde265_tpu/fused_decode.py _wave_body(pallas=True) between the two
// (spec 8.4.4.2: substitution 8.4.4.2.2, filtering 8.4.4.2.3, planar, DC
// and angular prediction 8.4.4.2.4-6).
//
// The plane is int32, zero-padded so that every border sample of a block
// lies inside it (ops/intra_window.py scan_pad_sizes); coordinates are
// clamped anyway, for the records of invalid slots.  Border index j of a
// block of size s: j < 2s the left column from bottom to top, j = 2s the
// corner, j > 2s the top row from left to right.
//
// Bound: each step is tiny (at most 256 blocks, 16K pixels), so a step
// costs about one launch; below that, the bytes of the residual rows read
// and of the blocks written.  The fused kernel therefore does a step in
// one launch: one CTA per block slot (a slot whose valid bit is clear
// returns at once), s*s threads, one per pixel, the raw and the filtered
// border in shared memory, the substitution chain on one thread.
//
// Invariant the fused step relies on: within one launch a CTA gathers its
// border from the plane while other CTAs store their blocks into it.  The
// result is exact only because the scan's schedule never marks available a
// border sample that lies inside a valid block of the same step (nor one
// outside the picture).  Unavailable samples may be read mid-store, but the
// substitution replaces them before anything uses them.  The test
// test_schedule_borders_avoid_own_step checks the schedule of the test
// streams for this.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBorder = 4 * 32 + 1;

// Raw border sample j of the block at padded origin (y0p, x0p) (B6).
__device__ __forceinline__ int border_sample(const int32_t* __restrict__ plane,
                                             int Hp, int Wp, int y0p, int x0p,
                                             int s, int j) {
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

// One reconstructed sample into the plane (B7).
__device__ __forceinline__ void store_sample(int32_t* __restrict__ plane,
                                             int Hp, int Wp, int y, int x,
                                             int v) {
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

// The fused step: one CTA per block slot, s*s threads (pixel y*s + x).
// meta [K, 5] (mode, edge, y0, x0, flags 1 unavailable | 2 filter |
// 4 strong | 8 valid), rrow [K], aw [K, aw_words] are this step's rows;
// res [n_res, s, s]; P0/P1/WT [35, s*s] angular tables.
__global__ void __launch_bounds__(1024)
intra_step_kernel(int32_t* __restrict__ plane, int Hp, int Wp, int pad_t,
                  int pad_l, const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ rrow,
                  const int32_t* __restrict__ aw, int aw_words,
                  const int32_t* __restrict__ res, int n_res,
                  const int32_t* __restrict__ P0,
                  const int32_t* __restrict__ P1,
                  const int32_t* __restrict__ WT, int s, int lg,
                  int bit_depth) {
  __shared__ int32_t b[kMaxBorder];   // raw, then substituted
  __shared__ int32_t f[kMaxBorder];   // filtered
  __shared__ uint8_t av[kMaxBorder];  // availability bits
  __shared__ int32_t dc_s;

  const int k = blockIdx.x;
  const int32_t* m = meta + 5LL * k;
  const int flags = m[4];
  if (!(flags & 8)) return;  // uniform over the CTA
  const int mode = m[0], edge = m[1];
  const int y0p = m[2] + pad_t, x0p = m[3] + pad_l;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nb = 4 * s + 1, n2 = 2 * s;
  const int maxv = (1 << bit_depth) - 1;

  // ---- border gather (B6's function) ----
  const int32_t* awk = aw + (long long)k * aw_words;
  for (int j = tid; j < nb; j += nt) {
    b[j] = border_sample(plane, Hp, Wp, y0p, x0p, s, j);
    av[j] = (uint8_t)((awk[j >> 5] >> (j & 31)) & 1);
  }
  __syncthreads();

  // ---- substitution (8.4.4.2.2): each sample takes the last available one
  // at or before it, else the first available one ----
  if (tid == 0) {
    if (flags & 1) {
      for (int j = 0; j < nb; ++j) b[j] = 1 << (bit_depth - 1);
    } else {
      int first = -1;
      for (int j = 0; j < nb; ++j)
        if (av[j]) {
          first = j;
          break;
        }
      if (first < 0) {
        for (int j = 0; j < nb; ++j) b[j] = 0;
      } else {
        for (int j = 0; j < first; ++j) b[j] = b[first];
        for (int j = first + 1; j < nb; ++j)
          if (!av[j]) b[j] = b[j - 1];
      }
    }
  }
  __syncthreads();

  // ---- filtering (8.4.4.2.3): [1 2 1], or bilinear for strong 32x32 ----
  const int corner_raw = b[n2];
  bool bilinear = false;
  if (s == 32 && (flags & 4)) {
    const int thr = 1 << (bit_depth - 5);
    bilinear = abs(corner_raw + b[4 * s] - 2 * b[n2 + s]) < thr &&
               abs(corner_raw + b[0] - 2 * b[s]) < thr;
  }
  for (int j = tid; j < nb; j += nt) {
    int v = b[j];
    if (bilinear) {
      if (j > 0 && j < n2)
        v = (j * corner_raw + (n2 - j) * b[0] + 32) >> 6;
      else if (j > n2 && j < 4 * s)
        v = ((4 * s - j) * corner_raw + (j - n2) * b[4 * s] + 32) >> 6;
    } else if ((flags & 2) && j > 0 && j < nb - 1) {
      v = (b[j - 1] + 2 * b[j] + b[j + 1] + 2) >> 2;
    }
    f[j] = v;
  }
  __syncthreads();
  // left[i] = f[2s-1-i], top[i] = f[2s+1+i], corner = f[2s]
  if (mode == 1 && tid == 0) {
    int sum = 0;
    for (int i = 0; i < s; ++i) sum += f[n2 - 1 - i] + f[n2 + 1 + i];
    dc_s = (sum + s) >> (lg + 1);
  }
  __syncthreads();

  // ---- prediction, one pixel per thread ----
  const int y = tid / s, x = tid - (tid / s) * s;
  const int corner = f[n2];
  int pred;
  if (mode == 0) {  // planar
    pred = ((s - 1 - x) * f[n2 - 1 - y] + (x + 1) * f[n2 + 1 + s] +
            (s - 1 - y) * f[n2 + 1 + x] + (y + 1) * f[n2 - 1 - s] + s) >>
           (lg + 1);
  } else if (mode == 1) {  // DC, with the edge filter below 32x32
    const int dc = dc_s;
    pred = dc;
    if (s < 32 && edge == 1) {
      if (y == 0 && x == 0)
        pred = (f[n2 - 1] + 2 * dc + f[n2 + 1] + 2) >> 2;
      else if (y == 0)
        pred = (f[n2 + 1 + x] + 3 * dc + 2) >> 2;
      else if (x == 0)
        pred = (f[n2 - 1 - y] + 3 * dc + 2) >> 2;
    }
  } else {  // angular: two table-indexed samples, weighted
    const int row = min(max(mode, 0), 34) * s * s + tid;
    const int p0 = P0[row], p1 = P1[row], wt = WT[row];
    // entries outside the border are only paired with weight 0: read as 0
    const int g0 = (p0 >= 0 && p0 < nb) ? f[p0] : 0;
    const int g1 = (p1 >= 0 && p1 < nb) ? f[p1] : 0;
    pred = ((32 - wt) * g0 + wt * g1 + 16) >> 5;
    if (s < 32 && edge == 2 && x == 0)
      pred = min(max(f[n2 + 1] + ((f[n2 - 1 - y] - corner) >> 1), 0), maxv);
    else if (s < 32 && edge == 3 && y == 0)
      pred = min(max(f[n2 - 1] + ((f[n2 + 1 + x] - corner) >> 1), 0), maxv);
  }

  // ---- residual add, clip, store (B7's function) ----
  const int r = rrow[k];
  const int rv =
      r >= 0 ? res[(long long)min(r, n_res - 1) * (s * s) + tid] : 0;
  store_sample(plane, Hp, Wp, y0p + y, x0p + x,
               min(max(pred + rv, 0), maxv));
}

bool size_ok(int s) { return s == 4 || s == 8 || s == 16 || s == 32; }

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

// meta/rrow/aw are the bin's [steps, K, ...] records; `step` selects the row.
extern "C" int tde_intra_step(void* plane, int Hp, int Wp, int pad_t,
                              int pad_l, const void* meta, const void* rrow,
                              const void* aw, int aw_words, long long step,
                              int K, const void* res, int n_res,
                              const void* P0, const void* P1, const void* WT,
                              int s, int bit_depth, void* stream) {
  if (!size_ok(s) || n_res <= 0 || aw_words * 32 < 4 * s + 1)
    return (int)cudaErrorInvalidValue;
  if (K <= 0) return 0;
  const int lg = s == 4 ? 2 : s == 8 ? 3 : s == 16 ? 4 : 5;
  const long long row = step * K;
  intra_step_kernel<<<K, s * s, 0, (cudaStream_t)stream>>>(
      (int32_t*)plane, Hp, Wp, pad_t, pad_l, (const int32_t*)meta + row * 5,
      (const int32_t*)rrow + row, (const int32_t*)aw + row * aw_words,
      aw_words, (const int32_t*)res, n_res, (const int32_t*)P0,
      (const int32_t*)P1, (const int32_t*)WT, s, lg, bit_depth);
  return (int)cudaGetLastError();
}
