// Fused masked Hamming search: best, argmin and second-best per query.
//
// Replaces the TPU kernel `masked_best_two` (the JAX package's ops/pallas_kernels.py,
// body `_match_kernel`), the reduction behind SearchByProjection. Plain twin:
// `best_two(distance_matrix, window & level & valid)` in ops/matching.py, which
// this kernel equals exactly. A target counts for a query when both are valid,
// |dx| <= radius and |dy| <= radius (float32, the twin's arithmetic), and its
// octave minus the query's is in [level_lo, level_hi]. Ties of the best go to
// the lowest target index; a row without candidates gives idx 0 and
// best = second = 1 << 20.
//
// What bounds it on an H100: neither bytes nor arithmetic at the path's shapes
// (Q <= 4096 queries x N = 1000 targets, or a batch of 20 x 1000 x 1000). The
// plain version materializes (Q, N) distance, window and level tensors in
// device memory over ~6 launches; here nothing (Q, N)-shaped exists. Distances
// use XOR + __popc on the 8 packed 32-bit words (exact, 32 B per descriptor,
// against 512 B of +-1 bf16 on the TPU). Design: one warp per query, 8 queries
// per block; target tiles (words, xy, level, valid) are staged through shared
// memory; each lane scans every 32nd target of the tile in increasing order,
// keeping its own (best, idx, second); lanes then merge with shuffles by the
// TPU kernel's rule: best = lexicographic min of (dist, idx),
// second = min(second_a, second_b, max(best_a, best_b)). A leading batch
// dimension B (grid.y) makes the 2x10 fuse searches of a keyframe one launch.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 256;
constexpr int BIG = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
masked_best_two_kernel(const int* __restrict__ q_words, const float* __restrict__ q_xy,
                       const int* __restrict__ q_level, const unsigned char* __restrict__ q_valid,
                       const float* __restrict__ radius, const int* __restrict__ t_words,
                       const float* __restrict__ t_xy, const int* __restrict__ t_level,
                       const unsigned char* __restrict__ t_valid, int Q, int N, int level_lo,
                       int level_hi, int* __restrict__ out_idx, int* __restrict__ out_best,
                       int* __restrict__ out_second) {
  __shared__ uint4 s_words[TILE][2];
  __shared__ float2 s_xy[TILE];
  __shared__ int s_level[TILE];
  __shared__ unsigned char s_valid[TILE];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * WARPS + warp;
  const bool q_in = q < Q;
  const size_t qi = (size_t)b * Q + q;

  uint4 qa = make_uint4(0, 0, 0, 0), qb = make_uint4(0, 0, 0, 0);
  float qx = 0.f, qy = 0.f, r = 0.f;
  int ql = 0;
  bool qv = false;
  if (q_in) {
    const uint4* w = reinterpret_cast<const uint4*>(q_words) + 2 * qi;
    qa = w[0];
    qb = w[1];
    qx = q_xy[2 * qi];
    qy = q_xy[2 * qi + 1];
    r = radius[qi];
    ql = q_level[qi];
    qv = q_valid[qi] != 0;
  }

  int best = BIG, second = BIG, idx = INT_MAX;
  const uint4* tw = reinterpret_cast<const uint4*>(t_words) + 2 * (size_t)b * N;
  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int n_tile = min(TILE, N - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile; i += THREADS) {
      const size_t j = (size_t)b * N + t0 + i;
      s_words[i][0] = tw[2 * (t0 + i)];
      s_words[i][1] = tw[2 * (t0 + i) + 1];
      s_xy[i] = make_float2(t_xy[2 * j], t_xy[2 * j + 1]);
      s_level[i] = t_level[j];
      s_valid[i] = t_valid[j];
    }
    __syncthreads();
    if (qv) {
      for (int i = lane; i < n_tile; i += 32) {
        const int dl = s_level[i] - ql;
        const bool m = s_valid[i] != 0 && fabsf(qx - s_xy[i].x) <= r &&
                       fabsf(qy - s_xy[i].y) <= r && dl >= level_lo && dl <= level_hi;
        if (m) {
          const uint4 a = s_words[i][0], c = s_words[i][1];
          const int d = __popc(qa.x ^ a.x) + __popc(qa.y ^ a.y) + __popc(qa.z ^ a.z) +
                        __popc(qa.w ^ a.w) + __popc(qb.x ^ c.x) + __popc(qb.y ^ c.y) +
                        __popc(qb.z ^ c.z) + __popc(qb.w ^ c.w);
          if (d < best) {
            second = best;
            best = d;
            idx = t0 + i;
          } else if (d < second) {
            second = d;
          }
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, idx, off);
    const int os = __shfl_xor_sync(FULL, second, off);
    second = min(min(second, os), max(best, ob));
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0 && q_in) {
    out_idx[qi] = best >= BIG ? 0 : idx;
    out_best[qi] = best;
    out_second[qi] = second;
  }
}

}  // namespace

// Queries (B, Q, ...) and targets (B, N, ...), all contiguous on the device:
// words int32 (.., 8) 16-byte aligned, xy float32 (.., 2), level int32,
// valid uint8, radius float32 (B, Q). Outputs (B, Q) int32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int masked_best_two(const int* q_words, const float* q_xy, const int* q_level,
                               const unsigned char* q_valid, const float* radius,
                               const int* t_words, const float* t_xy, const int* t_level,
                               const unsigned char* t_valid, int B, int Q, int N, int level_lo,
                               int level_hi, int* out_idx, int* out_best, int* out_second,
                               cudaStream_t stream) {
  if (B <= 0 || Q <= 0) return 0;
  const dim3 grid((Q + WARPS - 1) / WARPS, B);
  masked_best_two_kernel<<<grid, THREADS, 0, stream>>>(
      q_words, q_xy, q_level, q_valid, radius, t_words, t_xy, t_level, t_valid, Q, N, level_lo,
      level_hi, out_idx, out_best, out_second);
  return (int)cudaGetLastError();
}
