// Fused FAST-9/16 corner score + 3x3 non-max suppression, one pyramid level.
//
// Replaces the TPU kernel `fast_score_nms` (the JAX package's ops/pallas_kernels.py,
// body `_fast_kernel`). Plain twin: `nms3(fast_score(img))` in ops/fast.py, which
// this kernel equals bit for bit over the whole image: every operation is a
// float subtraction, min or max, and the borders follow the twin exactly --
// circle reads outside the image take the nearest edge pixel (edge padding),
// and the NMS treats pixels outside the image as -inf. (The TPU kernel zero-pads
// and wraps columns instead, and agrees with the twin only inside the 19-px
// extraction border.)
//
// What bounds it on an H100: memory. Each pixel needs 16 circle reads, 32
// window mins/maxes and 9 NMS reads, but only one 4-byte load and one 4-byte
// store must reach device memory; at 640x480 that is 2.4 MB of traffic, so a
// level costs about a launch. Design: one 32x8 output tile per block, staged
// with a 4-pixel halo on all four sides into shared memory (3 for the circle,
// 1 for the NMS); the block scores the (tile+2)-wide region from shared memory
// into a second shared buffer and takes the 3x3 max from there, so the score
// map never goes to device memory. Scoring the NMS ring costs 33% redundant
// work per block; fusing all 8 levels into one launch is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;  // output tile width (one warp per row)
constexpr int TH = 8;   // output tile height
constexpr int HALO = 4;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;  // scored region incl. the NMS ring
constexpr int RH = TH + 2;

__device__ __forceinline__ float fast_score_at(const float (*tile)[SW], int r, int c) {
  // Bresenham circle of radius 3 in circular order (dy, dx), as ops/fast.py.
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float center = tile[r][c];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[r + dy[k]][c + dx[k]] - center;
  // bright: max over k of min(d[k..k+8]); dark: max over k of min(-d[k..k+8])
  // = max over k of -max(d[k..k+8]) (negation is exact).
  float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float mn = d[k], mx = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = fminf(mn, d[(k + j) & 15]);
      mx = fmaxf(mx, d[(k + j) & 15]);
    }
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);
  }
  return fmaxf(fmaxf(bright, dark), 0.0f);
}

__global__ void __launch_bounds__(TW * TH)
fast_score_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W) {
  __shared__ float tile[SH][SW];
  __shared__ float score[RH][RW];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int r = i / SW, c = i % SW;
    const int y = min(max(y0 - HALO + r, 0), H - 1);
    const int x = min(max(x0 - HALO + c, 0), W - 1);
    tile[r][c] = img[(size_t)y * W + x];
  }
  __syncthreads();

  for (int i = tid; i < RH * RW; i += TW * TH) {
    const int r = i / RW, c = i % RW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    score[r][c] = (y < 0 || y >= H || x < 0 || x >= W)
                      ? -INFINITY
                      : fast_score_at(tile, r + HALO - 1, c + HALO - 1);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x < W && y < H) {
    const int r = threadIdx.y + 1, c = threadIdx.x + 1;
    const float s = score[r][c];
    float m = s;
#pragma unroll
    for (int a = -1; a <= 1; ++a)
#pragma unroll
      for (int b = -1; b <= 1; ++b) m = fmaxf(m, score[r + a][c + b]);
    out[(size_t)y * W + x] = (s >= m) ? s : 0.0f;
  }
}

}  // namespace

// img, out: (H, W) float32, contiguous, on the device. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int fast_score_nms(const float* img, float* out, int H, int W, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  fast_score_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}
