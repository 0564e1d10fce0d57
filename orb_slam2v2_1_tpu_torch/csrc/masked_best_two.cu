// Masked Hamming search (SearchByProjection's reduction), ending either in
// (argmin, best, second-best) per query or in the finished one-to-one match.
//
// Replaces the TPU kernel `masked_best_two` (the JAX package's
// ops/pallas_kernels.py, body `_match_kernel`). Two forms, one scan:
//   - best-two form (`masked_best_two`): per query the best and second-best
//     distance and the best target. Plain version: `masked_best_two_plain` in
//     ops/matching.py.
//   - match form (`masked_match`): the scan, then `best <= max_dist`, the
//     float32 ratio test, and the one-to-one resolution (per target the best
//     distance wins, ties to the first query). Plain version:
//     `resolve_duplicates(.., _ratio_ok(..))` over the best-two form, which is
//     `match_projection` on the CPU.
// Both equal their plain versions exactly. A target counts for a query when
// both are valid, |dx| <= radius and |dy| <= radius (float32, the plain
// version's arithmetic), and its octave minus the query's is in
// [level_lo, level_hi]. Ties of the best go to the lowest target index; a
// query without candidates gives idx 0 and best = second = 1 << 20.
//
// What bounds it on an H100: a launch. At the path's shapes (1000 or 4096
// queries x 1000 targets, or 20 x 1000 x 1000) the inputs and outputs are
// 0.1-2.1 MB (under 1 us at 3.35 TB/s) and the window-and-level test is about
// 8 operations a pair (8-160 M, 0.25-5 us at 33.5 T/s); popcounts run only for
// the pairs inside a window. Distances are XOR + __popc on the 8 packed words
// (exact, 32 B per descriptor). Nothing (Q, N)-shaped exists.
//
// Design. The targets are staged in tiles of 512 with cp.async into two
// shared-memory buffers, so both tiles of a 1000-target search are in flight
// from the first instruction and the scan of one overlaps the load of the
// next. A block has 8 warps. Every lane scans its share of a tile in
// increasing order keeping (best, idx, second); lanes merge by shuffles, and
// warps that share a query through shared memory, by the TPU kernel's rule:
// best = lexicographic min of (dist, idx), second = min(second_a, second_b,
// max(best_a, best_b)). How queries map to warps depends on how many there
// are (`dispatch`): under 2048, two warps per query, so that one 1000-query
// search puts 2000 warps on the 132 SMs; under 8192, one warp per query;
// above, two queries per warp, so that each staged target is read once for
// both. A leading batch dimension (grid.y) makes the 2 x 10 fuse searches of a
// keyframe one launch. The match form resolves duplicates across blocks with
// a 64-bit atomicMin of (distance << 32 | query) into one word per target,
// which is "best distance, ties to the first query" in any block order; a
// second short kernel keeps each query that holds its target's word. The
// caller fills the words with ones on the same stream.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (device time of one call in
// a CUDA graph, `kernel_times.py`) at 1x1000x1000 / 1x4096x1000 / 20x1000x1000:
// best-two form 6.0 / 12.4 / 40.1 us, match form (fill, search, mark) 9.1 /
// 14.9 / 43.1 us. The version before this one (one warp per query, synchronous
// 256-target tiles) took 11.4 / 14.7 / 52.3 us for the best-two form, and the
// match was 27 launches and 83 / 80 / 134 us. By mapping, best-two form: one
// warp per query 8.2 / 11.9 / 46.1 us; two warps per query 6.2 / 14.7 / 57.7;
// two queries per warp 11.0 / 12.5 / 43.1. Tried and dropped, same order: four
// warps per query 7.1 / 20.0 / 85.8 us; four and eight queries per warp 16.3 /
// 16.2 / 48.5 and 27.5 / 27.3 / 75.8 us; no staging, lanes reading the targets
// through L1 (1, 2, 4, 8 warps per query) 18.2-6.7 / 14.4-17.4 / 61.2-84.7 us.
// Testing the window with one predicate instead of a short circuit took the
// large batch from 43.1 to 40.1 us. It stays about nine times over its bound:
// the scan is bound by instruction throughput (a warp runs the popcount path
// whenever any of its 32 lanes has a candidate), not by the staging, since
// reading each staged target for two or four queries at once changed little.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 512;
constexpr int BIG = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;

struct Search {
  const int* q_words;
  const float* q_xy;
  const int* q_level;
  const unsigned char* q_valid;
  const float* radius;
  const int* t_words;
  const float* t_xy;
  const int* t_level;
  const unsigned char* t_valid;
  int Q, N, level_lo, level_hi;
};

struct Best {
  int best, second, idx;
};

__device__ __forceinline__ void merge(Best& a, int ob, int os, int oi) {
  a.second = min(min(a.second, os), max(a.best, ob));
  if (ob < a.best || (ob == a.best && oi < a.idx)) {
    a.best = ob;
    a.idx = oi;
  }
}

struct Query {
  uint4 a, b;
  float x, y, r;
  int level;
  bool live;  // in range and valid
};

// Tests valid target i against query q and, inside the window, takes its distance.
__device__ __forceinline__ void consider(Best& s, const Query& q, const Search& p, float2 xy,
                                         int level, const uint4* words, int i) {
  const int dl = level - q.level;
  // One predicate, no short circuit: the lanes of a warp diverge only for a candidate.
  if (q.live & (fabsf(q.x - xy.x) <= q.r) & (fabsf(q.y - xy.y) <= q.r) & (dl >= p.level_lo) &
      (dl <= p.level_hi)) {
    const uint4 a = words[0], c = words[1];
    const int d = __popc(q.a.x ^ a.x) + __popc(q.a.y ^ a.y) + __popc(q.a.z ^ a.z) +
                  __popc(q.a.w ^ a.w) + __popc(q.b.x ^ c.x) + __popc(q.b.y ^ c.y) +
                  __popc(q.b.z ^ c.z) + __popc(q.b.w ^ c.w);
    if (d < s.best) {
      s.second = s.best;
      s.best = d;
      s.idx = i;
    } else if (d < s.second) {
      s.second = d;
    }
  }
}

struct Tile {
  uint4 words[TILE][2];
  float2 xy[TILE];
  int level[TILE];
  unsigned char valid[TILE];
};

// Starts the copy of targets [t0, t0 + n) of batch row b into `s`. The valid
// bytes go as 4-byte pieces when their address allows it, else by plain loads.
__device__ __forceinline__ void stage(Tile& s, const Search& p, size_t row, int t0, int n) {
  const uint4* tw = reinterpret_cast<const uint4*>(p.t_words) + 2 * (row + t0);
  const float2* txy = reinterpret_cast<const float2*>(p.t_xy) + row + t0;
  const int* tl = p.t_level + row + t0;
  const unsigned char* tv = p.t_valid + row + t0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    __pipeline_memcpy_async(&s.words[i][0], tw + 2 * i, 16);
    __pipeline_memcpy_async(&s.words[i][1], tw + 2 * i + 1, 16);
    __pipeline_memcpy_async(&s.xy[i], txy + i, 8);
    __pipeline_memcpy_async(&s.level[i], tl + i, 4);
  }
  const int n4 = (reinterpret_cast<uintptr_t>(tv) & 3) == 0 ? n / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += THREADS)
    __pipeline_memcpy_async(&s.valid[4 * i], tv + 4 * i, 4);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += THREADS) s.valid[i] = tv[i];
  __pipeline_commit();
}

// One warp scans for QPW queries at once (each staged target is read once and
// tested against all of them) and WPQ warps share one scan (each takes every
// WPQ-th group of 32 targets); at most one of the two is above 1.
template <int WPQ, int QPW, bool MATCH>
__global__ void __launch_bounds__(THREADS)
search_kernel(const Search p, int max_dist, float nn_ratio, long long* __restrict__ out_idx,
              int* __restrict__ out_best, int* __restrict__ out_second,
              unsigned char* __restrict__ out_ok, unsigned long long* __restrict__ owner) {
  static_assert(WPQ == 1 || QPW == 1, "several warps per query or several queries per warp");
  constexpr int QPB = WARPS / WPQ * QPW;  // queries per block
  __shared__ Tile tiles[2];
  __shared__ Best parts[WARPS];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % WPQ;
  const int q0 = blockIdx.x * QPB + warp / WPQ * QPW;  // this warp's first query
  const size_t row = (size_t)b * p.N;

  Query q[QPW];
  Best s[QPW];
  bool any = false;
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    s[j] = {BIG, BIG, INT_MAX};
    q[j] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0), 0.f, 0.f, -1.f, 0};
    const size_t qi = (size_t)b * p.Q + q0 + j;
    if (q0 + j < p.Q && __ldg(p.q_valid + qi) != 0) {
      const uint4* w = reinterpret_cast<const uint4*>(p.q_words) + 2 * qi;
      q[j].a = __ldg(w);
      q[j].b = __ldg(w + 1);
      q[j].x = __ldg(p.q_xy + 2 * qi);
      q[j].y = __ldg(p.q_xy + 2 * qi + 1);
      q[j].r = __ldg(p.radius + qi);
      q[j].level = __ldg(p.q_level + qi);
      q[j].live = true;
      any = true;
    }
  }

  const int n_tiles = (p.N + TILE - 1) / TILE;
  if (n_tiles > 0) stage(tiles[0], p, row, 0, min(TILE, p.N));
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * TILE;
    if (t + 1 < n_tiles) {
      stage(tiles[(t + 1) & 1], p, row, t0 + TILE, min(TILE, p.N - t0 - TILE));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const Tile& cur = tiles[t & 1];
    const int n = min(TILE, p.N - t0);
    if (any)
      for (int i = part * 32 + lane; i < n; i += 32 * WPQ) {
        if (cur.valid[i] == 0) continue;
        const float2 xy = cur.xy[i];
        const int level = cur.level[i];
#pragma unroll
        for (int j = 0; j < QPW; ++j) consider(s[j], q[j], p, xy, level, cur.words[i], t0 + i);
      }
    __syncthreads();  // the next round's copy overwrites this buffer
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(FULL, s[j].best, off);
      const int os = __shfl_xor_sync(FULL, s[j].second, off);
      const int oi = __shfl_xor_sync(FULL, s[j].idx, off);
      merge(s[j], ob, os, oi);
    }
  if (WPQ > 1) {  // QPW == 1
    if (lane == 0) parts[warp] = s[0];
    __syncthreads();
    if (part != 0) return;
#pragma unroll
    for (int w = 1; w < WPQ; ++w) {
      const Best o = parts[warp + w];
      merge(s[0], o.best, o.second, o.idx);
    }
  }

  // Every lane holds every result; lane j finishes query j.
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int qn = q0 + j;
    if (lane != j || qn >= p.Q) continue;
    const size_t qi = (size_t)b * p.Q + qn;
    const int idx = s[j].best >= BIG ? 0 : s[j].idx;
    out_idx[qi] = idx;
    out_best[qi] = s[j].best;
    if (!MATCH) {
      out_second[qi] = s[j].second;
      continue;
    }
    // ops/matching.py _ratio_ok: one float32 product, then two comparisons.
    const bool ok = s[j].best < BIG && s[j].best <= max_dist &&
                    (float)s[j].best <= __fmul_rn(nn_ratio, (float)s[j].second);
    out_ok[qi] = ok;
    if (ok)
      atomicMin(owner + row + idx,
                ((unsigned long long)(unsigned)s[j].best << 32) | (unsigned)qn);
  }
}

// Keeps `ok` only for the query that holds its target's word.
__global__ void __launch_bounds__(THREADS)
mark_kernel(const long long* __restrict__ idx, const int* __restrict__ best,
            const unsigned long long* __restrict__ owner, int B, int Q, int N,
            unsigned char* __restrict__ ok) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * Q || !ok[i]) return;
  const size_t b = i / Q;
  const unsigned qn = (unsigned)(i - b * Q);
  const unsigned long long mine = ((unsigned long long)(unsigned)best[i] << 32) | qn;
  ok[i] = owner[b * N + idx[i]] == mine;
}

template <int WPQ, int QPW>
int launch(const Search& p, int B, bool match, int max_dist, float nn_ratio, long long* out_idx,
           int* out_best, int* out_second, unsigned char* out_ok, unsigned long long* owner,
           cudaStream_t stream) {
  constexpr int QPB = WARPS / WPQ * QPW;
  const dim3 grid((p.Q + QPB - 1) / QPB, B);
  if (match)
    search_kernel<WPQ, QPW, true><<<grid, THREADS, 0, stream>>>(
        p, max_dist, nn_ratio, out_idx, out_best, out_second, out_ok, owner);
  else
    search_kernel<WPQ, QPW, false><<<grid, THREADS, 0, stream>>>(
        p, max_dist, nn_ratio, out_idx, out_best, out_second, out_ok, owner);
  return (int)cudaGetLastError();
}

// Which instantiation runs, by the number of queries (the times are in the
// note at the head of this file): a small search gives every query two warps
// so that it fills the card, a large batch gives every warp two queries so
// that each staged target is read half as often.
int dispatch(const Search& p, int B, bool match, int max_dist, float nn_ratio, long long* out_idx,
             int* out_best, int* out_second, unsigned char* out_ok, unsigned long long* owner,
             cudaStream_t stream) {
  const long long queries = (long long)B * p.Q;
  if (queries < 2048)
    return launch<2, 1>(p, B, match, max_dist, nn_ratio, out_idx, out_best, out_second, out_ok,
                        owner, stream);
  if (queries < 8192)
    return launch<1, 1>(p, B, match, max_dist, nn_ratio, out_idx, out_best, out_second, out_ok,
                        owner, stream);
  return launch<1, 2>(p, B, match, max_dist, nn_ratio, out_idx, out_best, out_second, out_ok,
                      owner, stream);
}

}  // namespace

// Queries (B, Q, ...) and targets (B, N, ...), all contiguous on the device:
// words int32 (.., 8) 16-byte aligned, xy float32 (.., 2) 8-byte aligned, level
// int32, valid uint8, radius float32 (B, Q). All entries launch on `stream`,
// allocate nothing and return cudaGetLastError().

// Best-two form: out_idx int64, out_best and out_second int32, each (B, Q).
extern "C" int masked_best_two(const int* q_words, const float* q_xy, const int* q_level,
                               const unsigned char* q_valid, const float* radius,
                               const int* t_words, const float* t_xy, const int* t_level,
                               const unsigned char* t_valid, int B, int Q, int N, int level_lo,
                               int level_hi, long long* out_idx, int* out_best,
                               int* out_second, cudaStream_t stream) {
  if (B <= 0 || Q <= 0) return 0;
  const Search p = {q_words, q_xy,    q_level, q_valid, radius,   t_words, t_xy,
                    t_level, t_valid, Q,       N,       level_lo, level_hi};
  return dispatch(p, B, false, 0, 0.f, out_idx, out_best, out_second, nullptr, nullptr,
                  stream);
}

// Match form: out_idx int64, out_dist int32, out_ok uint8 (0 or 1), each
// (B, Q); owner: (B, N) 64-bit words that the caller has filled with ones on
// the same stream. Needs max_dist < 1 << 20. Two launches: search, mark.
extern "C" int masked_match(const int* q_words, const float* q_xy, const int* q_level,
                            const unsigned char* q_valid, const float* radius, const int* t_words,
                            const float* t_xy, const int* t_level, const unsigned char* t_valid,
                            int B, int Q, int N, int level_lo, int level_hi,
                            int max_dist, float nn_ratio, long long* out_idx, int* out_dist,
                            unsigned char* out_ok, unsigned long long* owner,
                            cudaStream_t stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (max_dist >= BIG) return (int)cudaErrorInvalidValue;
  const Search p = {q_words, q_xy,    q_level, q_valid, radius,   t_words, t_xy,
                    t_level, t_valid, Q,       N,       level_lo, level_hi};
  const int rc = dispatch(p, B, true, max_dist, nn_ratio, out_idx, out_dist, nullptr,
                          out_ok, owner, stream);
  if (rc != 0) return rc;
  const size_t total = (size_t)B * Q;
  mark_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      out_idx, out_dist, owner, B, Q, N, out_ok);
  return (int)cudaGetLastError();
}
