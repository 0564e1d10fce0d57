// Motion-only Levenberg-Marquardt of one camera pose (the tracker's
// Optimizer::PoseOptimization): every round and every iteration in one
// launch, the early exit decided on the device.
//
// Replaces no TPU kernel. The JAX package compiles this function into one
// `while_loop` per round (orb_slam2v2_1_tpu/ops/ba.py:132, pose_optimization);
// on the card, as plain PyTorch, each iteration was ~240 eager launches and
// one host read of the exit flag, twice a tracked frame, so the H100 profile
// of the tracker ranked it first. Plain version: `pose_optimization_plain` in
// ops/ba.py, which this kernel follows operation for operation in float32:
//   - rounds (Huber, Huber, plain, plain)[:rounds], each of at most `iters`
//     iterations from lam = 1e-3;
//   - per iteration: residuals, chi2, the IRLS weight inv_sigma2 x huber x
//     valid x inlier, cost0, the 18 Jacobian rows, H (6x6) and g as the sums
//     of the three residual rows; Hd = H + lam diag(H) + 1e-10 I; dx =
//     -solve(Hd, g) by LU with partial pivoting; T_new = se3_exp(dx) Tcw;
//     cost1; accept if cost1 < cost0; exit when accepted and cost0 - cost1 <
//     1e-3 cost0 + 1e-6; lam x 0.5 or x 4, clamped to [1e-8, 1e6];
//   - between rounds, inlier = chi2 <= delta2 & zc > 1e-6 & valid;
//   - first, the pose's rotation re-orthonormalized through a quaternion
//     (ops/lie.py orthonormalize), and se3_exp with ops/lie.py's small-angle
//     branches.
// The sums run in another order than the plain version's (per observation
// over the three rows, then a fixed tree over threads), so poses agree to
// float32 rounding, not bit for bit; two calls on the same inputs agree bit
// for bit (no atomics).
//
// What bounds it on an H100: the chain of dependent steps, not the SMs or
// memory. A call is at most 40 iterations of ~200 operations per
// observation: 8-16 M operations at 1000-2000 observations (0.2-0.5 us at
// 33.5 T/s), ~70 KB of inputs read once (0.02 us at 3.35 TB/s). Each
// iteration needs two block-wide sums and a 6x6 solve before the next can
// start, so one block on one SM does it all.
//
// Design. One block of 256 threads (grid of one). Each thread loads its
// observations once (point gathered through pt_idx, target, inv_sigma2,
// flags) and keeps them in registers for the whole call: 8 a thread, so at
// most 2048 observations (the main path has 1000 RGB-D or 2000 KITTI slots;
// the wrapper refuses more). An iteration is two passes. Pass A at T: per
// thread the 21 upper-triangle entries of H, the 6 of g and cost0; per
// quantity a warp shuffle tree, then warp 0 adds the 8 warps' partials in
// order; thread 0 solves (the LU in registers: the pivot row is swapped by
// constant indices), takes se3_exp and writes T_new to shared memory. Pass B
// at T_new: cost1, summed the same way; thread 0 decides accept, exit and
// lam and broadcasts them. Four barriers an iteration. The kernel reports
// the iterations each round ran (out_counts[1..4]).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (one call in a CUDA graph;
// three problems of `kernel_times.pose_inputs` a width; the iterations are
// the kernel's own): 1x1000 in 12-33 iterations 68.0-169.5 us, 5.1-5.7 us an
// iteration; 1x2000 in 7-20 iterations 59.3-144.2 us, 7.2-8.5 us an
// iteration (142 registers, no spills). On the same calls: the layout chosen
// by n (1, 2, 4, 8 or 16 a thread, the observations re-read each pass past
// 4096; six instantiations, two code paths) 10-11% faster at 1x1000 and
// equal at 1x2000; re-reading every pass for any n 21-26% slower at both;
// 16 a thread (216 registers) 29-33% slower at 1x1000, 9-13% at 1x2000.
// Earlier, on one problem a width (1x1000 / 1x2000 / 1x4000, the layout by
// n): 256 threads 80.1 / 231.5 / 111.4 us; 1024 threads (capped at 64
// registers, so 36-412 bytes of spills) 107.6 / 258.0 / 108.4 us; a
// transposed warp reduction (31 shuffles for the 28 quantities, not 5 each,
// but 32 values live and two selects a step) 98.9 / 283.1 / 128.5 at 256
// threads; 512 threads 91.6 / 291.0 / 118.6 and 128 threads 115.3 / 359.3 /
// 218.1 (both transposed); the solve as a call with its arrays in local
// memory, ~50 us more at 1024 threads. Near the optimum, whether a step
// lowers the cost is decided by rounding, so the kernel and the plain
// version stop at different iterations: on those nine problems the kernel
// ran 7-33 iterations a call and the plain version 7-31, up to 11 apart
// either way, a round that rejects every step running to the cap (the poses
// agree within 1e-4).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPT = 8;                  // observations a thread, in registers
constexpr int MAX_OBS = SPT * THREADS;  // 2048
constexpr int NH = 21;            // upper triangle of H
constexpr int NSUM = NH + 6 + 1;  // H, g, cost0
constexpr unsigned FULL = 0xffffffffu;
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr unsigned STEREO = 1u, VALID = 2u, INLIER = 4u;

struct Inputs {
  const float* Tcw0;
  const float* points;
  int P;
  const int* pt_idx;
  const float* target;
  const float* inv_sigma2;
  const unsigned char* is_stereo;
  const unsigned char* valid;
  int n;
  const float* K;
  float bf;
  int rounds;
  int iters;
  float* out_T;
  unsigned char* out_mask;
  int* out_counts;  // n_inliers, then the iterations each round ran
};

// One observation: the world point, the target (u, v, u_r), inv_sigma2 and
// the flags (stereo, valid, inlier of the current round).
struct Slot {
  float px, py, pz, t0, t1, t2, is2;
  unsigned flags;
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ Slot load_slot(const Inputs& in, int i) {
  Slot s;
  int p = in.pt_idx[i];
  p = p < 0 ? 0 : (p >= in.P ? in.P - 1 : p);  // in range on the plain path; never read outside
  s.px = in.points[3 * p];
  s.py = in.points[3 * p + 1];
  s.pz = in.points[3 * p + 2];
  s.t0 = in.target[3 * i];
  s.t1 = in.target[3 * i + 1];
  s.t2 = in.target[3 * i + 2];
  s.is2 = in.inv_sigma2[i];
  s.flags = (in.is_stereo[i] ? STEREO : 0u) | (in.valid[i] ? VALID | INLIER : 0u);
  return s;
}

// clamp(x, min=lo) as torch computes it: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float delta2(unsigned flags) {
  return (flags & STEREO) ? CHI2_STEREO : CHI2_MONO;
}

__device__ __forceinline__ float huber(float chi2, unsigned flags, bool robust) {
  if (!robust) return 1.f;
  const float d2 = delta2(flags);
  return chi2 <= d2 ? 1.f : sqrtf(d2 / clamp_min(chi2, 1e-12f));
}

// Camera-frame point, inverse depth, residuals and chi2 of one observation at
// the 3x4 pose T (row-major), as ops/ba.py's eval_planes.
struct Eval {
  float x, y, zc, iz, r0, r1, r2, chi2;
};

__device__ __forceinline__ Eval evaluate(const float* T, const Slot& s, const Cam& c) {
  Eval e;
  e.x = s.px * T[0] + s.py * T[1] + s.pz * T[2] + T[3];
  e.y = s.px * T[4] + s.py * T[5] + s.pz * T[6] + T[7];
  e.zc = s.px * T[8] + s.py * T[9] + s.pz * T[10] + T[11];
  e.iz = 1.f / clamp_min(e.zc, 1e-6f);
  const float u = c.fx * e.x * e.iz + c.cx;
  const float v = c.fy * e.y * e.iz + c.cy;
  const float ur = u - c.bf * e.iz;
  const float st = (s.flags & STEREO) ? 1.f : 0.f;
  e.r0 = u - s.t0;
  e.r1 = v - s.t1;
  e.r2 = (ur - s.t2) * st;
  e.chi2 = (e.r0 * e.r0 + e.r1 * e.r1 + e.r2 * e.r2) * s.is2;
  return e;
}

__device__ __forceinline__ float valid_f(unsigned f) { return (f & VALID) ? 1.f : 0.f; }
__device__ __forceinline__ float inlier_f(unsigned f) { return (f & INLIER) ? 1.f : 0.f; }

// cost term of one observation: chi2 x huber x valid x inlier.
__device__ __forceinline__ float cost_term(float chi2, unsigned flags, bool robust) {
  return chi2 * huber(chi2, flags, robust) * valid_f(flags) * inlier_f(flags);
}

// Adds w J^T J (upper triangle) and w J^T r of one residual row.
__device__ __forceinline__ void add_row(float (&acc)[NSUM], const float (&J)[6], float w, float r) {
  float Jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) Jw[i] = J[i] * w;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += Jw[i] * J[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[NH + i] += Jw[i] * r;
}

// Pass A for one observation: its share of H, g and cost0.
__device__ __forceinline__ void accumulate(float (&acc)[NSUM], const float* T, const Slot& s,
                                           const Cam& c, bool robust) {
  const Eval e = evaluate(T, s, c);
  const float h = huber(e.chi2, s.flags, robust);
  const float vi = valid_f(s.flags), in = inlier_f(s.flags);
  const float w = s.is2 * h * vi * in;
  acc[NSUM - 1] += e.chi2 * h * vi * in;
  const float iz2 = e.iz * e.iz;
  const float a00 = c.fx * e.iz;
  const float a02 = -c.fx * e.x * iz2;
  const float a11 = c.fy * e.iz;
  const float a12 = -c.fy * e.y * iz2;
  const float a22 = a02 + c.bf * iz2;
  const float st = (s.flags & STEREO) ? 1.f : 0.f;
  // Rows (b0, b1, b2) of the projection's derivative, then the rotation
  // columns (-b1 zc + b2 y, b0 zc - b2 x, -b0 y + b1 x).
  const float J0[6] = {a00, 0.f, a02, a02 * e.y, a00 * e.zc - a02 * e.x, -a00 * e.y};
  const float J1[6] = {0.f, a11, a12, -a11 * e.zc + a12 * e.y, -a12 * e.x, a11 * e.x};
  const float J2[6] = {a00 * st, 0.f, a22 * st, (a22 * e.y) * st, (a00 * e.zc - a22 * e.x) * st,
                       (-a00 * e.y) * st};
  add_row(acc, J0, w, e.r0);
  add_row(acc, J1, w, e.r1);
  add_row(acc, J2, w, e.r2);
}

// Sums over the block in a fixed order, so a call repeats bit for bit: per
// quantity a shuffle tree in each warp, then warp 0's lane q adds the warps'
// partials of quantity q in order. The totals land in `out` on warp 0, read
// by thread 0 after the closing __syncwarp.
__device__ __forceinline__ void block_sum_pass_a(float (&v)[NSUM], float (*part)[NSUM], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    float x = v[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
    if (lane == 0) part[warp][q] = x;
  }
  __syncthreads();
  if (warp == 0 && lane < NSUM) {
    float t = part[0][lane];
    for (int w = 1; w < WARPS; ++w) t += part[w][lane];
    out[lane] = t;
  }
  __syncwarp();
}

// One quantity, the same way; the total on thread 0.
template <class T>
__device__ __forceinline__ T block_sum1(T v, T* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  T t = part[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < WARPS; ++w) t += part[w];
  return t;
}

__device__ __forceinline__ float sgn(float x) { return x < 0.f ? -1.f : 1.f; }

// ops/lie.py orthonormalize on the 3x4 pose T: rot_to_quat, then quat_to_rot.
__device__ __forceinline__ void orthonormalize(float* T) {
  const float m00 = T[0], m01 = T[1], m02 = T[2];
  const float m10 = T[4], m11 = T[5], m12 = T[6];
  const float m20 = T[8], m21 = T[9], m22 = T[10];
  const float tr = m00 + m11 + m22;
  const float qw = sqrtf(fmaxf(1.f + tr, 0.f)) * 0.5f;
  const float qx = sqrtf(fmaxf(1.f + m00 - m11 - m22, 0.f)) * 0.5f;
  const float qy = sqrtf(fmaxf(1.f - m00 + m11 - m22, 0.f)) * 0.5f;
  const float qz = sqrtf(fmaxf(1.f - m00 - m11 + m22, 0.f)) * 0.5f;
  // argmax over (qw, qx, qy, qz), the first of equal values.
  int k = 0;
  float best = qw;
  if (qx > best) { k = 1; best = qx; }
  if (qy > best) { k = 2; best = qy; }
  if (qz > best) { k = 3; best = qz; }
  float q[4];
  if (k == 0) {
    q[0] = sgn(m21 - m12) * qx; q[1] = sgn(m02 - m20) * qy; q[2] = sgn(m10 - m01) * qz; q[3] = qw;
  } else if (k == 1) {
    q[0] = qx; q[1] = sgn(m01 + m10) * qy; q[2] = sgn(m02 + m20) * qz; q[3] = sgn(m21 - m12) * qw;
  } else if (k == 2) {
    q[0] = sgn(m01 + m10) * qx; q[1] = qy; q[2] = sgn(m12 + m21) * qz; q[3] = sgn(m02 - m20) * qw;
  } else {
    q[0] = sgn(m02 + m20) * qx; q[1] = sgn(m12 + m21) * qy; q[2] = qz; q[3] = sgn(m10 - m01) * qw;
  }
  float nrm = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-8f);
  const float flip = q[3] / nrm < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm * flip;
  nrm = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-8f);
  const float x = q[0] / nrm, y = q[1] / nrm, z = q[2] / nrm, w = q[3] / nrm;
  T[0] = 1.f - 2.f * (y * y + z * z); T[1] = 2.f * (x * y - z * w);       T[2] = 2.f * (x * z + y * w);
  T[4] = 2.f * (x * y + z * w);       T[5] = 1.f - 2.f * (x * x + z * z); T[6] = 2.f * (y * z - x * w);
  T[8] = 2.f * (x * z - y * w);       T[9] = 2.f * (y * z + x * w);       T[10] = 1.f - 2.f * (x * x + y * y);
}

// ops/lie.py se3_exp of [rho, phi] as a 3x4 row-major matrix.
__device__ __forceinline__ void se3_exp(const float* xi, float* E) {
  const float px = xi[3], py = xi[4], pz = xi[5];
  const float sq = px * px + py * py + pz * pz;
  const float th = sq < 1e-16f ? 0.f : sqrtf(sq);
  const bool small = fabsf(th) < 1e-4f;
  const float th2 = th * th;
  const float sinc = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float cosc = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  const float c3 = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th * th * th);
  const float W[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[4 * i + j] = id + sinc * W[3 * i + j] + cosc * W2[3 * i + j];
      t += (id + cosc * W[3 * i + j] + c3 * W2[3 * i + j]) * xi[j];
    }
    E[4 * i + 3] = t;
  }
}

// x = A^-1 b for a 6x6 A by LU with partial pivoting (the first of equal
// pivots), as LAPACK's getrf/getrs; a zero pivot gives inf or NaN, which the
// accept test rejects.
__device__ __forceinline__ void solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float m = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > m) { m = fabsf(A[i][k]); p = i; }
    // The swap with row p, by constant indices only, so that A stays in
    // registers.
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) { const float t = A[k][j]; A[k][j] = A[i][j]; A[i][j] = t; }
        const float t = b[k]; b[k] = b[i]; b[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
      A[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// Thread 0: from the totals (H upper triangle, g, cost0) and lam, the pose
// T_new = se3_exp(-solve(Hd, g)) T.
__device__ __forceinline__ void lm_step(const float* tot, float lam, const float* T, float* Tn) {
  float A[6][6], b[6], dx[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) { A[i][j] = tot[k]; A[j][i] = tot[k]; ++k; }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + lam * A[i][i] + 1e-10f;
    b[i] = tot[NH + i];
  }
  solve6(A, b, dx);
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = -dx[i];
  float E[12];
  se3_exp(dx, E);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j] + E[4 * i + 2] * T[8 + j];
    Tn[4 * i + 3] += E[4 * i + 3];
  }
}

// f(slot) for each of this thread's observations (slot k is observation
// threadIdx.x + k * THREADS); f may change the flags.
template <class F>
__device__ __forceinline__ void each(Slot (&slots)[SPT], int n, F&& f) {
#pragma unroll
  for (int k = 0; k < SPT; ++k)
    if (threadIdx.x + k * THREADS < n) f(slots[k]);
}

__global__ void __launch_bounds__(THREADS, 1) pose_lm_kernel(const Inputs in) {
  __shared__ float part[WARPS][NSUM];
  __shared__ float part1[WARPS];
  __shared__ int ipart[WARPS];
  __shared__ float tot[NSUM];
  __shared__ float sT[12], sTn[12];
  __shared__ int s_done;

  const Cam c = {in.K[0], in.K[1], in.K[2], in.K[3], in.bf};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 12; ++i) sT[i] = in.Tcw0[i];
    orthonormalize(sT);
    for (int r = 0; r < 4; ++r) in.out_counts[1 + r] = 0;
  }
  Slot slots[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < in.n) slots[k] = load_slot(in, i);
  }
  __syncthreads();

  const int rounds = in.rounds < 4 ? in.rounds : 4;
  for (int round = 0; round < rounds; ++round) {
    const bool robust = round < 2;
    float lam = 1e-3f, cost0 = 0.f;  // thread 0's
    int ran = 0;
    for (int it = 0; it < in.iters; ++it) {
      ++ran;
      float acc[NSUM];
#pragma unroll
      for (int q = 0; q < NSUM; ++q) acc[q] = 0.f;
      each(slots, in.n, [&](Slot& s) { accumulate(acc, sT, s, c, robust); });
      block_sum_pass_a(acc, part, tot);
      if (threadIdx.x == 0) {
        cost0 = tot[NSUM - 1];
        lm_step(tot, lam, sT, sTn);
      }
      __syncthreads();
      float c1 = 0.f;
      each(slots, in.n, [&](Slot& s) { c1 += cost_term(evaluate(sTn, s, c).chi2, s.flags, robust); });
      const float cost1 = block_sum1(c1, part1);
      if (threadIdx.x == 0) {
        const bool accept = cost1 < cost0;
        if (accept) {
#pragma unroll
          for (int i = 0; i < 12; ++i) sT[i] = sTn[i];
        }
        s_done = accept && (cost0 - cost1 < 1e-3f * cost0 + 1e-6f);
        lam = accept ? lam * 0.5f : lam * 4.f;
        lam = fminf(fmaxf(lam, 1e-8f), 1e6f);
      }
      __syncthreads();
      if (s_done) break;
    }
    if (threadIdx.x == 0) in.out_counts[1 + round] = ran;
    each(slots, in.n, [&](Slot& s) {
      const Eval e = evaluate(sT, s, c);
      const bool inl = e.chi2 <= delta2(s.flags) && e.zc > 1e-6f && (s.flags & VALID);
      s.flags = (s.flags & ~INLIER) | (inl ? INLIER : 0u);
    });
  }

  int count = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < in.n) {
      const unsigned char m = (slots[k].flags & INLIER) ? 1 : 0;
      in.out_mask[i] = m;
      count += m;
    }
  }
  count = block_sum1(count, ipart);
  if (threadIdx.x == 0) {
    in.out_counts[0] = count;
#pragma unroll
    for (int i = 0; i < 12; ++i) in.out_T[i] = sT[i];
    in.out_T[12] = 0.f; in.out_T[13] = 0.f; in.out_T[14] = 0.f; in.out_T[15] = 1.f;
  }
}

}  // namespace

// Tcw0 (4, 4), points (P, 3), target (n, 3), inv_sigma2 (n,), K (4,) float32;
// pt_idx (n,) int32, n <= 2048; is_stereo and valid (n,) uint8 (0 or 1). Writes out_T
// (4, 4) float32, out_mask (n,) uint8 and out_counts (5 int32: n_inliers,
// then the LM iterations each of the four rounds ran, 0 for a round not run).
// One launch.
extern "C" int pose_lm(const float* Tcw0, const float* points, int P, const int* pt_idx,
                       const float* target, const float* inv_sigma2,
                       const unsigned char* is_stereo, const unsigned char* valid, int n,
                       const float* K, float bf, int rounds, int iters, float* out_T,
                       unsigned char* out_mask, int* out_counts, cudaStream_t stream) {
  if (n < 0 || n > MAX_OBS || rounds < 0 || iters < 0 || (n > 0 && P <= 0)) return (int)cudaErrorInvalidValue;
  const Inputs in = {Tcw0, points, P, pt_idx, target, inv_sigma2, is_stereo, valid, n,
                     K, bf, rounds, iters, out_T, out_mask, out_counts};
  pose_lm_kernel<<<1, THREADS, 0, stream>>>(in);
  return (int)cudaGetLastError();
}
