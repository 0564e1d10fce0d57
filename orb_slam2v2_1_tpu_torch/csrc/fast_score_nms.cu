// FAST-9/16 corner score + 3x3 non-max suppression for a whole pyramid in one
// launch, ending either in the suppressed score map or in the best corner of
// every 16x16 cell.
//
// Replaces the TPU kernel `fast_score_nms` (the JAX package's
// ops/pallas_kernels.py, body `_fast_kernel`). Two forms, one kernel body:
//   - map form (`fast_score_nms`): one level -> its suppressed score map. Plain
//     version: `nms3(fast_score(img))` in ops/fast.py.
//   - cell form (`fast_score_nms_cells`): all levels of a pyramid -> per 16x16
//     cell the best rank and the row-major index of its first maximal entry.
//     Plain version: `rank_cells(nms3(fast_score(img)), ...)` per level. The
//     score map is never written in this form.
// Both equal their plain versions bit for bit over whole levels: every
// operation is a float subtraction, comparison, min or max, plus one rounded
// float32 add of 1e4 in the cell form. Circle reads outside the image take the
// nearest edge pixel, the NMS sees -inf outside the image, and cells at the
// ragged edge are padded with rank 0, as the plain versions do. (The TPU kernel
// zero-pads and wraps columns, and agrees only inside the 19-px border.)
//
// What bounds it on an H100: operations, not bytes. The 8 levels of a 640x480
// frame hold 950,532 pixels. Bytes: one 4-byte read per pixel and, in the map
// form, one 4-byte write (7.6 MB, 2.3 us at 3.35 TB/s; the cell form writes
// 12 bytes per cell instead). Operations: 16 subtractions, 64 mins and 64 maxes
// for the circular 9-windows in doubling form (2, 4, 8, then 9), 32 more to
// reduce them and 9 for the NMS: about 185 float32 operations per pixel that
// are not multiply-adds, 176 M per frame, 5.2 us at 33.5 T/s (half the card's
// 67 TFLOP/s, which counts a multiply-add as two).
//
// Design. The grid walks a flat list of 64x16 tiles over all levels; a table
// of levels goes to the kernel by value. A tile is 4 cells wide, so the NMS
// ring costs (66*18)/(64*16) - 1 = 16% more scoring. The image tile and a 4-px
// halo are staged into shared memory with aligned 16-byte loads (level rows
// are not 16-byte multiples, so each row starts at its aligned-down address
// and the pieces are placed by column); columns beyond the left or right edge
// are filled with the edge pixel afterwards. Scores of the (tile + ring) region
// stay in shared memory. Each thread then suppresses 4 pixels of one cell
// column, and in the cell form ranks them and reduces (rank, first index) per
// cell through 16-lane shuffles and one shared-memory step; the maximum of
// `rank bits << 32 | 255 - index` is argmax's rule, since ranks are >= +0.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (device time of one call in
// a CUDA graph, `kernel_times.py`): the cell form takes 22 us for the 8 levels
// of a 640x480 frame (48 registers, 11.8 KB of shared memory, 991 blocks),
// where the 8 per-level launches of the version before (32x8 tiles, 16
// separate 9-windows, score map written) summed to 52 us and about 350 small
// PyTorch launches followed them. That is 4 times the bound above. 32x16 tiles
// of 128 threads (three even waves of blocks) and skipping the pixels inside
// the border both left the time within 2%, so the tail of the grid is not
// what holds it; min and max issuing at half the rate of an add would account
// for it (not measured). The map form takes 8.9 us at 480x640 (was 12.3) and
// 5.0 us at 134x179 (was 3.4: a small level alone is only 27 tiles).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CELL = 16;
constexpr int TW = 64;  // output tile: 4 cells wide, 1 cell high
constexpr int TH = 16;
constexpr int THREADS = 256;
constexpr int HALO = 4;  // 3 for the circle + 1 for the NMS ring
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;  // scored region incl. the NMS ring
constexpr int RH = TH + 2;
constexpr int VEC_PER_ROW = SW / 4 + 1;  // aligned float4s covering SW floats at any misalignment
constexpr int MAX_LEVELS = 16;

struct Level {
  const float* img;
  float* map;  // map form only
  int H, W, tiles_x, first_tile, first_cell, cells_x;
};

struct Pyramid {
  Level lv[MAX_LEVELS];
  int n_levels;
};

struct Rank {
  float threshold, min_threshold;
  int border;
};

__device__ __forceinline__ float fast_score_at(const float (*tile)[SW], int r, int c) {
  // Bresenham circle of radius 3 in circular order (dy, dx), as ops/fast.py.
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float center = tile[r][c];
  float d[16], lo[16], hi[16], lo2[16], hi2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[r + dy[k]][c + dx[k]] - center;
  // Min and max over each circular window of 9, doubling: 2, 4, 8, then 9.
  // Exact in any order, since min and max do not round.
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo[k] = fminf(d[k], d[(k + 1) & 15]);
    hi[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(lo[k], lo[(k + 2) & 15]);
    hi2[k] = fmaxf(hi[k], hi[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo[k] = fminf(lo2[k], lo2[(k + 4) & 15]);
    hi[k] = fmaxf(hi2[k], hi2[(k + 4) & 15]);
  }
  // bright: max over windows of min(d); dark: max over windows of min(-d)
  // = -(min over windows of max(d)) (negation is exact).
  float bright = -INFINITY, dark = INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright = fmaxf(bright, fminf(lo[k], d[(k + 8) & 15]));
    dark = fminf(dark, fmaxf(hi[k], d[(k + 8) & 15]));
  }
  return fmaxf(fmaxf(bright, -dark), 0.0f);
}

template <bool CELLS>
__global__ void __launch_bounds__(THREADS)
fast_kernel(const __grid_constant__ Pyramid pyr, const Rank rank, float* __restrict__ cell_best,
            long long* __restrict__ cell_arg) {
  __shared__ float tile[SH][SW];
  __shared__ float score[RH][RW];
  __shared__ unsigned long long part_key[TW / CELL][THREADS / TW];

  int l = 0;
  while (l + 1 < pyr.n_levels && (int)blockIdx.x >= pyr.lv[l + 1].first_tile) ++l;
  const Level& L = pyr.lv[l];
  const int H = L.H, W = L.W;
  const float* __restrict__ img = L.img;
  const int t = (int)blockIdx.x - L.first_tile;
  const int tx = t % L.tiles_x, ty = t / L.tiles_x;
  const int x0 = tx * TW, y0 = ty * TH;
  const int tid = threadIdx.x;

  // Stage the tile and its halo. Row r starts at flat index g0 of the level;
  // its aligned-down 16-byte address is `first` floats into the level
  // (first = g0 - 0..3, negative only before the level's first pixel).
  const long long HW = (long long)H * W;
  const long long base = (long long)reinterpret_cast<uintptr_t>(img);
  for (int i = tid; i < SH * VEC_PER_ROW; i += THREADS) {
    const int r = i / VEC_PER_ROW, k = i % VEC_PER_ROW;
    const int y = min(max(y0 - HALO + r, 0), H - 1);
    const long long g0 = (long long)y * W + (x0 - HALO);
    const long long first = (((base + 4 * g0) & ~15LL) - base) / 4;
    const long long e = first + 4 * k;  // flat index of this vector's first float
    const int c0 = (int)(e - g0);       // its column in the staged tile
    float v[4];
    if (e >= 0 && e + 3 < HW) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(img + e));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (e + j >= 0 && e + j < HW) ? __ldg(img + e + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j, x = x0 - HALO + c;
      if (c >= 0 && c < SW && x >= 0 && x < W) tile[r][c] = v[j];
    }
  }
  if (x0 == 0 || x0 + TW + HALO > W) {  // columns beyond an edge take the edge pixel
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int r = i / SW, c = i % SW;
      const int x = x0 - HALO + c;
      if (x < 0 || x >= W) {
        const int y = min(max(y0 - HALO + r, 0), H - 1);
        tile[r][c] = __ldg(img + (long long)y * W + min(max(x, 0), W - 1));
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < RH * RW; i += THREADS) {
    const int r = i / RW, c = i % RW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    score[r][c] = (y < 0 || y >= H || x < 0 || x >= W)
                      ? -INFINITY
                      : fast_score_at(tile, r + HALO - 1, c + HALO - 1);
  }
  __syncthreads();

  // Thread tid owns column tid % 64 of rows tid / 64 + {0, 4, 8, 12}: four
  // pixels of one cell; a warp covers 32 neighbouring columns of one row.
  const int col = tid % TW, row0 = tid / TW;
  const int x = x0 + col;
  unsigned long long key = 0;
#pragma unroll
  for (int e = 0; e < CELL / (THREADS / TW); ++e) {
    const int row = row0 + e * (THREADS / TW);
    const int y = y0 + row;
    float s = 0.0f;
    if (x < W && y < H) {
      const float v = score[row + 1][col + 1];
      float m = v;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) m = fmaxf(m, score[row + a][col + b]);
      s = (v >= m) ? v : 0.0f;
      if (!CELLS) L.map[(long long)y * W + x] = s;
    }
    if (CELLS) {
      // The three steps of ops/fast.py rank_cells, in its order; pixels
      // outside the image rank 0 (the plain version's zero padding).
      const bool in_border = y >= rank.border && y < H - rank.border && x >= rank.border &&
                             x < W - rank.border;
      const float s1 = (in_border && s >= rank.min_threshold) ? s : 0.0f;
      float rk = (s1 >= rank.threshold) ? __fadd_rn(s1, 1e4f) : s1;
      rk = (s1 > 0.0f) ? rk : 0.0f;
      const unsigned idx = (unsigned)(row * CELL + col % CELL);
      const unsigned long long k2 = ((unsigned long long)__float_as_uint(rk) << 32) | (255u - idx);
      key = max(key, k2);
    }
  }
  if (CELLS) {
#pragma unroll
    for (int off = CELL / 2; off > 0; off >>= 1)
      key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
    if (col % CELL == 0) part_key[col / CELL][row0] = key;
    __syncthreads();
    if (tid < TW / CELL) {
      const int cx = tx * (TW / CELL) + tid;
      if (cx < L.cells_x) {
        unsigned long long best = part_key[tid][0];
#pragma unroll
        for (int p = 1; p < THREADS / TW; ++p) best = max(best, part_key[tid][p]);
        const long long o = (long long)L.first_cell + (long long)ty * L.cells_x + cx;
        cell_best[o] = __uint_as_float((unsigned)(best >> 32));
        cell_arg[o] = 255 - (long long)(best & 0xffffffffu);
      }
    }
  }
}

// Fills the level table from host arrays and launches one grid over all tiles.
template <bool CELLS>
int launch(const void* const* imgs, void* const* maps, const int* hs, const int* ws, int n_levels,
           Rank rank, int cell_stride, float* cell_best, long long* cell_arg, cudaStream_t stream) {
  if (n_levels <= 0) return 0;
  if (n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Pyramid pyr;
  pyr.n_levels = n_levels;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] <= 0 || ws[l] <= 0) return (int)cudaErrorInvalidValue;
    Level& L = pyr.lv[l];
    L.img = static_cast<const float*>(imgs[l]);
    L.map = maps ? static_cast<float*>(maps[l]) : nullptr;
    L.H = hs[l];
    L.W = ws[l];
    L.tiles_x = (ws[l] + TW - 1) / TW;
    L.first_tile = tiles;
    L.first_cell = l * cell_stride;
    L.cells_x = (ws[l] + CELL - 1) / CELL;
    tiles += L.tiles_x * ((hs[l] + TH - 1) / TH);
    if (CELLS && L.cells_x * ((hs[l] + CELL - 1) / CELL) > cell_stride)
      return (int)cudaErrorInvalidValue;
  }
  fast_kernel<CELLS><<<tiles, THREADS, 0, stream>>>(pyr, rank, cell_best, cell_arg);
  return (int)cudaGetLastError();
}

}  // namespace

// Map form. img, out: (H, W) float32, contiguous, on the device. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fast_score_nms(const float* img, float* out, int H, int W, cudaStream_t stream) {
  const void* imgs[1] = {img};
  void* maps[1] = {out};
  return launch<false>(imgs, maps, &H, &W, 1, Rank{0.0f, 0.0f, 0}, 0, nullptr, nullptr, stream);
}

// Cell form. imgs, hs, ws: host arrays of n_levels (<= 16) device pointers to
// contiguous (H, W) float32 levels and their sizes, read before the call
// returns. cell_best (float32) and cell_arg (int64) are (n_levels, cell_stride):
// row l holds the ceil(H/16) x ceil(W/16) cells of level l in row-major order,
// and the rest of the row is not written. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int fast_score_nms_cells(const void* const* imgs, const int* hs, const int* ws,
                                    int n_levels, float threshold, float min_threshold, int border,
                                    int cell_stride, float* cell_best, long long* cell_arg,
                                    cudaStream_t stream) {
  return launch<true>(imgs, nullptr, hs, ws, n_levels, Rank{threshold, min_threshold, border},
                      cell_stride, cell_best, cell_arg, stream);
}
