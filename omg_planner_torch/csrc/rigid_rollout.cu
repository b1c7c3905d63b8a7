// The rigid-body rollout of the physics executor, for Hopper (sm_90a).
//
// Computes omg_planner_torch/physics/rigid.py::rollout_plain, the whole
// substep loop of one dynamic body against the kinematic robot, its finger
// pads and the static scene, for B rollouts at once.  It has no Pallas
// counterpart: the JAX package runs this loop as one lax.scan that XLA
// compiles for the host CPU (omg_planner_tpu/physics/rigid.py:857-922,
// executor.py:47-87).  In eager PyTorch the scan body is ~6,000 small
// operations a substep, so the loop lives inside one launch, as a scan on
// the hot path should.
//
// What bounds it: neither bytes nor flops (the roofline is ~1e-5 of its
// time; chip_smoke.py reports both) but the chain of dependent rounds of
// the solve: each Jacobi iteration needs the sums over all contact lanes
// of the previous one, twice (the pad pin, then the impulse), and every
// substep runs iters + iters / 4 such iterations.  Callers run one
// rollout at a time, so the design cuts the latency of one round.
//
// Layout: one block of 8 warps per rollout (B > 1: one block each, one
// launch).  Per substep:
//  1. scoring, all 8 warps: every candidate of the three pools (robot
//     spheres K = 480 at full width, pad samples 2 x Sp = 192, body surface
//     samples S = 96 against every static) is scored once; its contact
//     (point, normal, depth, and the robot sphere's velocity or the pad
//     sample's world position) goes to shared memory, and each active
//     candidate is appended to its pool's list (a shared atomic counter:
//     the list's order is free, the ranks below do not depend on it);
//  2. rank, all 8 warps: each listed candidate's exact rank among its
//     pool's listed ones (score descending, lower index first on ties:
//     jax.lax.top_k's order) puts its index in its lane;
//  3-5. the solve, warp 0 alone: thread l owns lanes l, l + 32, ...
//     (LPT = 4 lanes a thread at C <= 128, 8 at C <= 256).  Each lane
//     reads its winner's contact from shared memory (the bits that were
//     scored); only a pad lane's velocity is recomputed, since the pad's
//     next pose depends on the stall test over all pad samples.  Every
//     sum over lanes is a fixed-order add of the thread's own lanes and
//     then an xor butterfly (5 shuffles), so every thread holds the same
//     bits and runs the per-body updates (3 x 3 products, patch brakes)
//     itself.  The Jacobi and pseudo loops have no __syncthreads and no
//     shared-memory exchange; the other warps wait at the substep's last
//     barrier.  Three barriers a substep in all.
//
// Against the plain version the solve keeps its formulas, with these
// reassociations (each changes the last bits, none the method):
//  * omega / k_n, omega / k_1, omega / k_2 are hoisted per lane, so a lane
//    update is ln - vn * (omega / k_n), not ln - omega * vn / k_n (the
//    pseudo pass likewise);
//  * a lane's velocity along n is dot(n, v) + dot(rarm x n, w) - dot(n,
//    v_other), plain's Jacobian row, with rarm x n hoisted (t1, t2 alike);
//  * a pad lane is pinned as d * (tot / sum), one division per pad, not
//    tot * d / sum per lane;
//  * the patch linear brake uses plain's G = P K_inv P [I, -crossmat(rbar)]
//    with omega folded in, the angular brake omega * i_world, applied as
//    IW w + (IW HS) d_l to the linear brake's w + HS d_l;
//  * sums over lanes run in the order above, not torch's: a lane's terms
//    by fused multiply-adds, a thread's lanes by a pairwise tree;
//  * a lane's mass split sum_c (n . n_c)^2 over active lanes c is
//    n^T (sum_c n_c n_c^T) n, one 3 x 3 sum for all lanes.
// The IEEE divisions that stay inside the loop are the two pads' pin
// factors and the two brake clamps, whose divisors change every iteration.
// Branches that skip work are exact: the pad pin when no lane is a pinned
// pad lane, the brakes when no finger lane is active (plain skips them
// too), the pseudo pass when no lane has a positive bias.
//
// Arithmetic: fp32, no fast math; the 3 x 3 solves (A + 1e-8 I,
// i_inv + 1e-12 I, K_pat + 1e-8 I) by the adjugate; w_hand gated on
// W_pat > 1e-6 as the plain version does.
//
// -DOMG_ROLLOUT_CYCLES builds the profile library: Ptrs gains one output,
// cycles [B, kPhases] (long long), where thread 0 adds the clock64() span
// of each phase of every substep (the sums stay in shared memory, so the
// solve keeps its registers), and the entry point is
// omg_rigid_rollout_cycles.  The main path never loads that build.
// -DOMG_CUDA_EMU compiles the file with g++ against cuda_emu.h, a
// test-only emulation of the CUDA subset used here on host fibers
// (tests/test_torch_rollout_emu.py).

#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#define OMG_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem()
#else
#include <cuda_runtime.h>
#define OMG_DYNAMIC_SMEM(name) extern __shared__ float name[]
#endif
#include <math.h>

#include "sdf_point.cuh"

#ifdef OMG_ROLLOUT_CYCLES
#define OMG_ROLLOUT_ENTRY omg_rigid_rollout_cycles
#define PHASE_MARK(i)                   \
  do {                                  \
    if (tid == 0) {                     \
      const long long now_ = clock64(); \
      cyc[i] += now_ - t_mark;          \
      t_mark = now_;                    \
    }                                   \
  } while (0)
#else
#define OMG_ROLLOUT_ENTRY omg_rigid_rollout
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTrace = 19;  // x3 v3 q4 w3 jv2 impulse robot# world# pad_pen
// phases of a substep: scoring, rank, lane set-up (r1, r2v, r3), Jacobi,
// pseudo pass, pools and integration
constexpr int kPhases = 6;
// floats a candidate keeps in shared memory: point, normal, depth, and
// the robot sphere's velocity or the pad sample's world position
constexpr int kCandF = 10;
constexpr unsigned kFull = 0xffffffffu;

struct Ptrs {
  const float* sph;          // [B, T+1, K, 3]
  const float* is_finger;    // [K]
  const float* pad_track;    // [B, T+1, 2, 4, 4]
  const float* pad_samples;  // [2, Sp, 3]
  const float* pad_axis;     // [B, 2, 3]
  const float* jv_track;     // [B, T+1, 2]
  const float* jv_ref;       // [B, 2]
  const float* state0;       // [B, 13]: x, q (wxyz), v, w
  const float* params;       // [14]: PhysParams in field order
  const float* body;         // [15]: kind, half[3], round, inv_mass,
                             //       inv_inertia[9] (row-major)
  const float* surf;         // [S, 3]
  const float4* body_grid;   // [Nb, 4] (Nb = 0: analytic body)
  const float* body_lim;     // [10]
  const int* w_kinds;        // [O]
  const float* w_halfs;      // [O, 3]
  const float* w_rounds;     // [O]
  const float* w_inv;        // [O, 4, 4]
  const float* w_mask;       // [O]
  const float4* wg;          // [Og, Ng, 4]
  const float* wg_lim;       // [Og, 10]
  const float* wg_inv;       // [Og, 4, 4]
  float* out_state;          // [B, 13]
  float* out_trace;          // [B, T, kTrace]
#ifdef OMG_ROLLOUT_CYCLES
  long long* cycles;         // [B, kPhases]
#endif
};

struct Dims {
  int B, T, K, Sp, S, O, Og, Ng, Nb, kr, kp, kw, iters;
};

// 3 x 3 matrices, row-major
struct M3 {
  float m[9];
};
__device__ __forceinline__ V3 mv(const M3& a, V3 v) {
  return {a.m[0] * v.x + a.m[1] * v.y + a.m[2] * v.z,
          a.m[3] * v.x + a.m[4] * v.y + a.m[5] * v.z,
          a.m[6] * v.x + a.m[7] * v.y + a.m[8] * v.z};
}
__device__ __forceinline__ V3 mtv(const M3& a, V3 v) {  // a^T v
  return {a.m[0] * v.x + a.m[3] * v.y + a.m[6] * v.z,
          a.m[1] * v.x + a.m[4] * v.y + a.m[7] * v.z,
          a.m[2] * v.x + a.m[5] * v.y + a.m[8] * v.z};
}
__device__ __forceinline__ M3 mm(const M3& a, const M3& b) {
  M3 c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c.m[3 * i + j] = a.m[3 * i] * b.m[j] + a.m[3 * i + 1] * b.m[3 + j] +
                       a.m[3 * i + 2] * b.m[6 + j];
  return c;
}
__device__ __forceinline__ M3 transpose(const M3& a) {
  M3 t;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) t.m[3 * i + j] = a.m[3 * j + i];
  return t;
}
__device__ __forceinline__ M3 add_diag(M3 a, float s) {
  a.m[0] += s;
  a.m[4] += s;
  a.m[8] += s;
  return a;
}
__device__ __forceinline__ M3 scaled(float s, M3 a) {
#pragma unroll
  for (int i = 0; i < 9; ++i) a.m[i] *= s;
  return a;
}
// inverse by the adjugate (the matrices here are symmetric and regularised)
__device__ __forceinline__ M3 inv3(const M3& a) {
  const float* m = a.m;
  M3 c;
  c.m[0] = m[4] * m[8] - m[5] * m[7];
  c.m[1] = m[2] * m[7] - m[1] * m[8];
  c.m[2] = m[1] * m[5] - m[2] * m[4];
  c.m[3] = m[5] * m[6] - m[3] * m[8];
  c.m[4] = m[0] * m[8] - m[2] * m[6];
  c.m[5] = m[2] * m[3] - m[0] * m[5];
  c.m[6] = m[3] * m[7] - m[4] * m[6];
  c.m[7] = m[1] * m[6] - m[0] * m[7];
  c.m[8] = m[0] * m[4] - m[1] * m[3];
  const float det = m[0] * c.m[0] + m[1] * c.m[3] + m[2] * c.m[6];
  return scaled(1.f / det, c);
}
__device__ __forceinline__ M3 crossmat(V3 a) {  // crossmat(a) b = a x b
  M3 s;
  s.m[0] = 0.f, s.m[1] = -a.z, s.m[2] = a.y;
  s.m[3] = a.z, s.m[4] = 0.f, s.m[5] = -a.x;
  s.m[6] = -a.y, s.m[7] = a.x, s.m[8] = 0.f;
  return s;
}

// wxyz quaternion -> rotation (normalised with + 1e-12, as quat_to_mat)
__device__ __forceinline__ M3 quat_to_mat(const float* q4) {
  const float n =
      sqrtf(q4[0] * q4[0] + q4[1] * q4[1] + q4[2] * q4[2] + q4[3] * q4[3]) +
      1e-12f;
  const float w = q4[0] / n, x = q4[1] / n, y = q4[2] / n, z = q4[3] / n;
  M3 r;
  r.m[0] = 1 - 2 * (y * y + z * z);
  r.m[1] = 2 * (x * y - w * z);
  r.m[2] = 2 * (x * z + w * y);
  r.m[3] = 2 * (x * y + w * z);
  r.m[4] = 1 - 2 * (x * x + z * z);
  r.m[5] = 2 * (y * z - w * x);
  r.m[6] = 2 * (x * z - w * y);
  r.m[7] = 2 * (y * z + w * x);
  r.m[8] = 1 - 2 * (x * x + y * y);
  return r;
}

struct Body {
  int kind;
  V3 half;
  float round, inv_mass;
  M3 inv_inertia;
};

__device__ __forceinline__ SdfG body_sdf(const Ptrs& P, const Dims& D,
                                         const Body& bd, V3 rel) {
  if (D.Nb > 0) return grid_sdf_grad(P.body_grid, P.body_lim, rel);
  return analytic_sdf_grad(bd.kind, bd.half, 1.f, bd.round, rel);
}

// A pose as rotation + translation (row-major 4 x 4 in memory).
struct Pose {
  M3 r;
  V3 t;
};
__device__ __forceinline__ Pose load_pose(const float* m) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) p.r.m[3 * i + j] = m[4 * i + j];
  p.t = v3(m[3], m[7], m[11]);
  return p;
}

// a or b by value, so that an array of two poses never needs an address
__device__ __forceinline__ Pose pick(bool second, const Pose& a,
                                     const Pose& b) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 9; ++i) p.r.m[i] = second ? b.r.m[i] : a.r.m[i];
  p.t = second ? b.t : a.t;
  return p;
}

// Pad pose at joint offset dv: the tracked pose m translated by
// R (axis * dv) (rigid.py::_pad_pose).
__device__ __forceinline__ Pose pad_pose(const float* m, const float* axis,
                                         float dv) {
  Pose p = load_pose(m);
  const V3 ax = load3(axis);
  p.t = p.t + mv(p.r, v3(ax.x * dv, ax.y * dv, ax.z * dv));
  return p;
}

// One scored candidate.  Robot spheres and pad samples: the body's SDF at
// the point; world samples: the minimum over statics.  ``v`` is the robot
// sphere's velocity, the pad sample's world position (its velocity needs
// the pad's next pose, known after the stall test), or 0.
struct Cand {
  V3 p, n, v;
  float pen;
};

struct Frame {  // per-substep body frame
  V3 x;
  M3 r;
};

__device__ __forceinline__ Cand robot_cand(const Ptrs& P, const Dims& D,
                                           const Body& bd, const Frame& fr,
                                           float radius, float dt, int b,
                                           int t, int i) {
  const float* s0 =
      P.sph + ((static_cast<long long>(b) * (D.T + 1) + t) * D.K + i) * 3;
  const V3 s = load3(s0);
  const V3 s1 = load3(s0 + static_cast<long long>(D.K) * 3);
  const SdfG sd = body_sdf(P, D, bd, mtv(fr.r, s - fr.x));
  const V3 n_out = unit(mv(fr.r, sd.g));
  return {s - sd.d * n_out, -n_out,
          v3((s1.x - s.x) / dt, (s1.y - s.y) / dt, (s1.z - s.z) / dt),
          radius - sd.d};
}

__device__ __forceinline__ Cand pad_cand(const Ptrs& P, const Dims& D,
                                         const Body& bd, const Frame& fr,
                                         const Pose& pose, int f, int s) {
  const V3 ps = load3(P.pad_samples + (f * D.Sp + s) * 3);
  const V3 sp_w = mv(pose.r, ps) + pose.t;
  const SdfG sd = body_sdf(P, D, bd, mtv(fr.r, sp_w - fr.x));
  const V3 n_out = unit(mv(fr.r, sd.g));
  return {sp_w - sd.d * n_out, -n_out, sp_w, 1e-3f - sd.d};
}

__device__ __forceinline__ Cand world_cand(const Ptrs& P, const Dims& D,
                                           const Frame& fr, int s) {
  const V3 pw = fr.x + mv(fr.r, load3(P.surf + s * 3));
  float phi_min = INFINITY;
  V3 n_w = v3(0.f, 0.f, 0.f);
  for (int o = 0; o < D.O; ++o) {
    const Pose inv = load_pose(P.w_inv + o * 16);
    const SdfG sd = analytic_sdf_grad(P.w_kinds[o], load3(P.w_halfs + o * 3),
                                      1.f, P.w_rounds[o],
                                      mv(inv.r, pw) + inv.t);
    const float phi = P.w_mask[o] > 0.5f ? sd.d : INFINITY;
    // argmin, first index on ties (object 0 when every value is +inf)
    if (o == 0 || phi < phi_min) {
      phi_min = phi;
      n_w = mtv(inv.r, sd.g);
    }
  }
  if (D.Og > 0) {
    float phi_gm = 0.f;
    V3 n_g = v3(0.f, 0.f, 0.f);
    for (int o = 0; o < D.Og; ++o) {
      const Pose inv = load_pose(P.wg_inv + o * 16);
      const SdfG sd = grid_sdf_grad(P.wg + static_cast<long long>(o) * D.Ng,
                                    P.wg_lim + o * 10, mv(inv.r, pw) + inv.t);
      if (o == 0 || sd.d < phi_gm) {
        phi_gm = sd.d;
        n_g = mtv(inv.r, sd.g);
      }
    }
    if (phi_gm < phi_min) {
      phi_min = phi_gm;
      n_w = n_g;
    }
  }
  return {pw, unit(n_w), v3(0.f, 0.f, 0.f), -phi_min};
}

// Sums over the warp of N floats: every thread returns the same bits (an
// xor butterfly is commutative at each stage).
template <int N>
__device__ __forceinline__ void warp_sum(float (&a)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) a[k] += __shfl_xor_sync(kFull, a[k], off);
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

// Sums over a thread's lanes, as a pairwise tree: out[k] = sum_j p[j][k].
template <int L, int N>
__device__ __forceinline__ void lane_tree(float (&p)[L][N], float (&out)[N]) {
#pragma unroll
  for (int step = 1; step < L; step *= 2)
#pragma unroll
    for (int j = 0; j + step < L; j += 2 * step)
#pragma unroll
      for (int k = 0; k < N; ++k) p[j][k] += p[j + step][k];
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = p[0][k];
}

// r[0..2] += a * x + b * y + c * z, as three fused multiply-adds a row
__device__ __forceinline__ void acc3(float* r, float a, V3 x, float b, V3 y,
                                     float c, V3 z) {
  r[0] = fmaf(c, z.x, fmaf(b, y.x, fmaf(a, x.x, r[0])));
  r[1] = fmaf(c, z.y, fmaf(b, y.y, fmaf(a, x.y, r[1])));
  r[2] = fmaf(c, z.z, fmaf(b, y.z, fmaf(a, x.z, r[2])));
}

// r[0..2] += a * x + b * y
__device__ __forceinline__ void acc2(float* r, float a, V3 x, float b, V3 y) {
  r[0] = fmaf(b, y.x, fmaf(a, x.x, r[0]));
  r[1] = fmaf(b, y.y, fmaf(a, x.y, r[1]));
  r[2] = fmaf(b, y.z, fmaf(a, x.z, r[2]));
}

// Shared memory of one block, carved from the dynamic allocation.
template <int LPT>
struct Smem {
  long long* cyc;  // [kPhases]: the profile build's cycle sums
  float* pool;     // [3][NP]: warm ln, l1, l2 keyed by candidate index
  float* cand;     // [kCandF][NP]: each candidate's scored contact
  float* list_s;   // [NP]: active candidates' scores, in their pool's range
  int* list_i;     // [NP]: their candidate indices
  int* lane_src;   // [32 LPT]: each lane's candidate, or -1
  int* count;      // [4]: listed candidates of each pool
  float* pmax_w;   // [kWarps][2]: each warp's largest pad penetrations
  float* bc;       // [9]: the body's x, q and finger joints, for all warps
  float* ahead;    // [34]: the next boundary's pad poses and finger command

  __device__ Smem(float* base, int NP) {
    cyc = reinterpret_cast<long long*>(base);
    pool = base + 2 * kPhases;
    cand = pool + 3 * NP;
    list_s = cand + kCandF * NP;
    list_i = reinterpret_cast<int*>(list_s + NP);
    lane_src = list_i + NP;
    count = lane_src + 32 * LPT;
    pmax_w = reinterpret_cast<float*>(count + 4);
    bc = pmax_w + 2 * kWarps;
    ahead = bc + 9;
  }
  static size_t bytes(int NP) {
    return sizeof(float) * (2 * kPhases +
                            (3 + kCandF + 2) * NP + 32 * LPT + 4 +
                            2 * kWarps + 9 + 34);
  }
};

template <int LPT>
__global__ void __launch_bounds__(kThreads, 1)
    rigid_rollout_kernel(Ptrs P, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = D.K, Sp2 = 2 * D.Sp;
  const int NP = K + Sp2 + D.S;                   // candidates of the pools
  const int kr = D.kr, kp = D.kp, C = D.kr + D.kp + D.kw;
  const Smem<LPT> sm(smem, NP);

  // parameters and body, identical in every thread
  const float* pp = P.params;
  const float dt = pp[0], mu = pp[1], beta = pp[2], slop = pp[3],
              v_depen_max = pp[4], radius = pp[7], pinch = pp[8],
              stall_pen = pp[9], finger_rate = pp[10];
  const V3 gravity = v3(pp[11], pp[12], pp[13]);
  const float decay_l = expf(-pp[5] * dt), decay_a = expf(-pp[6] * dt);
  Body bd;
  bd.kind = static_cast<int>(P.body[0]);
  bd.half = load3(P.body + 1);
  bd.round = P.body[4];
  bd.inv_mass = P.body[5];
#pragma unroll
  for (int i = 0; i < 9; ++i) bd.inv_inertia.m[i] = P.body[6 + i];
  const float omega = 0.9f;

  const float* s0 = P.state0 + b * 13;
  V3 v = load3(s0 + 7), w = load3(s0 + 10);  // kept by warp 0
  const float* jvt = P.jv_track + static_cast<long long>(b) * (D.T + 1) * 2;
  const float jv_ref[2] = {P.jv_ref[b * 2], P.jv_ref[b * 2 + 1]};
  int prev_src[LPT];  // the lanes' candidates of the last substep
#pragma unroll
  for (int j = 0; j < LPT; ++j) prev_src[j] = -1;

  for (int i = tid; i < 3 * NP; i += kThreads) sm.pool[i] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) sm.bc[i] = s0[i];
    sm.bc[7] = jvt[0];
    sm.bc[8] = jvt[1];
    for (int i = 0; i < 4; ++i) sm.count[i] = 0;
  }
#ifdef OMG_ROLLOUT_CYCLES
  long long* cyc = sm.cyc;
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) cyc[i] = 0;
  long long t_mark = 0;
#endif
  __syncthreads();
#ifdef OMG_ROLLOUT_CYCLES
  t_mark = clock64();
#endif

  for (int t = 0; t < D.T; ++t) {
    Frame fr;
    fr.x = load3(sm.bc);
    float q[4] = {sm.bc[3], sm.bc[4], sm.bc[5], sm.bc[6]};
    const float jv[2] = {sm.bc[7], sm.bc[8]};
    fr.r = quat_to_mat(q);
    const float* track = P.pad_track +
                         (static_cast<long long>(b) * (D.T + 1) + t) * 32;
    Pose pad[2];
#pragma unroll
    for (int f = 0; f < 2; ++f)
      pad[f] = pad_pose(track + 16 * f, P.pad_axis + (b * 2 + f) * 3,
                        jv[f] - jv_ref[f]);
    // the last warp stages what the solve reads of the next boundary, so
    // its loads overlap the scoring
    if (warp == kWarps - 1) {
      sm.ahead[lane] = track[32 + lane];
      if (lane < 2) sm.ahead[32 + lane] = jvt[(t + 1) * 2 + lane];
    }

    // 1. score every candidate into shared memory; list the active ones;
    // each pad's largest penetration
    float pmax[2] = {-INFINITY, -INFINITY};
    for (int i = tid; i < NP; i += kThreads) {
      Cand c;
      bool act;
      int pool_id;
      if (i < K) {
        c = robot_cand(P, D, bd, fr, radius, dt, b, t, i);
        act = static_cast<float>(c.pen > 0.f) * (1.f - P.is_finger[i]) > 0.5f;
        pool_id = 0;
      } else if (i < K + Sp2) {
        const int j = i - K, f = j >= D.Sp ? 1 : 0;
        c = pad_cand(P, D, bd, fr, pick(f, pad[0], pad[1]), f, j - f * D.Sp);
        pmax[f] = fmaxf(pmax[f], c.pen);
        act = c.pen > 0.f;
        pool_id = 1;
      } else {
        c = world_cand(P, D, fr, i - K - Sp2);
        act = c.pen > 0.f;
        pool_id = 2;
      }
      const float f10[kCandF] = {c.p.x, c.p.y, c.p.z, c.n.x, c.n.y,
                                 c.n.z, c.pen, c.v.x, c.v.y, c.v.z};
#pragma unroll
      for (int k = 0; k < kCandF; ++k) sm.cand[k * NP + i] = f10[k];
      if (act) {
        const int lo = pool_id == 0 ? 0 : (pool_id == 1 ? K : K + Sp2);
        const int at = lo + atomicAdd(&sm.count[pool_id], 1);
        sm.list_s[at] = c.pen;
        sm.list_i[at] = i;
      }
    }
    if (tid < 32 * LPT) sm.lane_src[tid] = -1;
    pmax[0] = warp_max(pmax[0]);
    pmax[1] = warp_max(pmax[1]);
    if (lane == 0) {
      sm.pmax_w[2 * warp] = pmax[0];
      sm.pmax_w[2 * warp + 1] = pmax[1];
    }
    __syncthreads();
    PHASE_MARK(0);

    // 2. top-k of each pool by exact rank among its listed candidates
    {
      const int n0 = sm.count[0], n1 = sm.count[1], n2 = sm.count[2];
      for (int e = tid; e < n0 + n1 + n2; e += kThreads) {
        int lo, n, k, lane0, at;
        if (e < n0) {
          lo = 0, n = n0, k = kr, lane0 = 0, at = e;
        } else if (e < n0 + n1) {
          lo = K, n = n1, k = kp, lane0 = kr, at = K + e - n0;
        } else {
          lo = K + Sp2, n = n2, k = D.kw, lane0 = kr + kp;
          at = K + Sp2 + e - n0 - n1;
        }
        const float si = sm.list_s[at];
        const int ii = sm.list_i[at];
        auto above = [&](int f) {
          const float sf = sm.list_s[f];
          return static_cast<int>((sf > si) || (sf == si && sm.list_i[f] < ii));
        };
        // counting past k changes no outcome, so the exit test runs once
        // every 8 entries and their loads overlap
        int rank = 0, f = lo;
        for (; f + 8 <= lo + n && rank < k; f += 8) {
#pragma unroll
          for (int u = 0; u < 8; ++u) rank += above(f + u);
        }
        for (; f < lo + n && rank < k; ++f) rank += above(f);
        if (rank < k) sm.lane_src[lane0 + rank] = ii;
      }
    }
    __syncthreads();
    PHASE_MARK(1);

    if (warp == 0) {
      // finger motors: advance toward the command unless stalled
      float pm[2] = {sm.pmax_w[0], sm.pmax_w[1]};
      for (int wi = 1; wi < kWarps; ++wi) {
        pm[0] = fmaxf(pm[0], sm.pmax_w[2 * wi]);
        pm[1] = fmaxf(pm[1], sm.pmax_w[2 * wi + 1]);
      }
      const float* cmd = sm.ahead + 32;
      float jv_next[2];
      Pose pad_next[2];
      const float rate = finger_rate * dt;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float step = fminf(fmaxf(cmd[f] - jv[f], -rate), rate);
        const bool stalled = pm[f] >= stall_pen && step < 0.f;
        jv_next[f] = stalled ? jv[f] : jv[f] + step;
        pad_next[f] = pad_pose(sm.ahead + 16 * f, P.pad_axis + (b * 2 + f) * 3,
                               jv_next[f] - jv_ref[f]);
      }

      // 3. each lane's contact, read from its candidate
      int src[LPT];
      float act[LPT], pen[LPT], finger[LPT], wl[LPT][3];
      V3 n[LPT], p[LPT], vo[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int c = lane + 32 * j;
        src[j] = c < C ? sm.lane_src[c] : -1;
        const int s = src[j];
        act[j] = s >= 0 ? 1.f : 0.f;
        p[j] = n[j] = vo[j] = v3(0.f, 0.f, 0.f);
        pen[j] = finger[j] = wl[j][0] = wl[j][1] = wl[j][2] = 0.f;
        if (s >= 0) {
          const float* cd = sm.cand + s;
          p[j] = v3(cd[0], cd[NP], cd[2 * NP]);
          n[j] = v3(cd[3 * NP], cd[4 * NP], cd[5 * NP]);
          pen[j] = fmaxf(cd[6 * NP], 0.f);
          const V3 cv = v3(cd[7 * NP], cd[8 * NP], cd[9 * NP]);
          if (s < K) {
            vo[j] = cv;
          } else if (s < K + Sp2) {
            const int jj = s - K, f = jj >= D.Sp ? 1 : 0;
            const V3 ps = load3(P.pad_samples + jj * 3);
            const Pose pn = pick(f, pad_next[0], pad_next[1]);
            const V3 nx = mv(pn.r, ps) + pn.t;
            vo[j] = v3((nx.x - cv.x) / dt, (nx.y - cv.y) / dt,
                       (nx.z - cv.z) / dt);
            finger[j] = 1.f + static_cast<float>(f);
          }
#pragma unroll
          for (int i = 0; i < 3; ++i) wl[j][i] = sm.pool[i * NP + s];
        }
      }
      // gravity enters before the solve
      v = v + dt * gravity;
      const M3 i_inv = mm(mm(fr.r, bd.inv_inertia), transpose(fr.r));

      // per lane: tangent basis, Jacobian rows, patch weights; with the
      // patch sums, the active normals' second moment N = sum n n^T
      V3 t1[LPT], t2[LPT], rxn[LPT], rx1[LPT], rx2[LPT];
      float von[LPT], vo1[LPT], vo2[LPT], okn[LPT], ok1[LPT], ok2[LPT];
      float pw0[LPT], pw1[LPT];
      bool m0[LPT], m1[LPT], is_f[LPT];
      float r1[21] = {};
      bool any_f = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const V3 rarm = p[j] - fr.x;
        const V3 ref = fabsf(n[j].z) < 0.9f ? v3(0.f, 0.f, 1.f)
                                            : v3(1.f, 0.f, 0.f);
        t1[j] = unit(cross(n[j], ref));
        t2[j] = cross(n[j], t1[j]);
        rxn[j] = cross(rarm, n[j]);
        rx1[j] = cross(rarm, t1[j]);
        rx2[j] = cross(rarm, t2[j]);
        von[j] = dot(n[j], vo[j]);
        vo1[j] = dot(t1[j], vo[j]);
        vo2[j] = dot(t2[j], vo[j]);
        const float engage = fminf(fmaxf(pen[j] / stall_pen, 0.f), 1.f);
        is_f[j] = finger[j] > 0.5f;
        pw0[j] = (fabsf(finger[j] - 1.f) < 0.25f ? 1.f : 0.f) * act[j] *
                 engage;
        pw1[j] = (fabsf(finger[j] - 2.f) < 0.25f ? 1.f : 0.f) * act[j] *
                 engage;
        m0[j] = pw0[j] > 0.f;
        m1[j] = pw1[j] > 0.f;
        const float w_pat = pw0[j] + pw1[j];
        const V3 nn = n[j];  // 0 on inactive lanes
        const float add[21] = {pw0[j], pw1[j], w_pat,
                               w_pat * p[j].x, w_pat * p[j].y, w_pat * p[j].z,
                               w_pat * vo[j].x, w_pat * vo[j].y,
                               w_pat * vo[j].z,
                               pw0[j] * n[j].x, pw0[j] * n[j].y,
                               pw0[j] * n[j].z,
                               w_pat * rarm.x, w_pat * rarm.y, w_pat * rarm.z,
                               nn.x * nn.x, nn.y * nn.y, nn.z * nn.z,
                               nn.x * nn.y, nn.x * nn.z, nn.y * nn.z};
#pragma unroll
        for (int k = 0; k < 21; ++k) r1[k] += add[k];
        any_f = any_f || is_f[j];
      }
      warp_sum(r1);
      any_f = __any_sync(kFull, any_f);
      // mass splitting by the alignment-weighted count of active contacts,
      // sum_c (n . n_c)^2 = n^T N n; relaxation factors omega / k
      M3 Nn;
      Nn.m[0] = r1[15], Nn.m[4] = r1[16], Nn.m[8] = r1[17];
      Nn.m[1] = Nn.m[3] = r1[18];
      Nn.m[2] = Nn.m[6] = r1[19];
      Nn.m[5] = Nn.m[7] = r1[20];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const V3 rarm = p[j] - fr.x;
        auto eff_k = [&](V3 d) {
          return bd.inv_mass + dot(cross(mv(i_inv, cross(rarm, d)), rarm), d);
        };
        const float sp =
            act[j] > 0.f ? fmaxf(dot(n[j], mv(Nn, n[j])), 1.f) : 1.f;
        okn[j] = omega / (fmaxf(eff_k(n[j]), 1e-6f) * sp);
        ok1[j] = omega / (fmaxf(eff_k(t1[j]), 1e-6f) * sp);
        ok2[j] = omega / (fmaxf(eff_k(t2[j]), 1e-6f) * sp);
      }
      const float eng0 = fminf(r1[0], 1.f), eng1 = fminf(r1[1], 1.f);
      const float tot0 = pinch * dt * eng0 * eng1;
      const float tot1 = pinch * dt * eng1 * eng0;
      const float W_pat = r1[2];
      const float inv_w = 1.f / fmaxf(W_pat, 1e-9f);
      const V3 pbar = inv_w * v3(r1[3], r1[4], r1[5]);
      const V3 vbar = inv_w * v3(r1[6], r1[7], r1[8]);
      const V3 a_pinch = unit(v3(r1[9], r1[10], r1[11]));
      const V3 rbar = inv_w * v3(r1[12], r1[13], r1[14]);

      // the lanes' pads: pinned totals and engagement seeds; the patch's
      // least-squares twist; the warm start, pinned per pad
      float seed[LPT], ln[LPT], l1[LPT], l2[LPT], r2v[12] = {};
      bool any_pin = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const float tot_l = m0[j] ? tot0 : tot1;
        seed[j] = 1e-3f * tot_l * (m0[j] ? pw0[j] : pw1[j]);
        const float w_pat = pw0[j] + pw1[j];
        const V3 r_pat = p[j] - pbar;
        const float r2 = dot(r_pat, r_pat);
        const V3 bv = w_pat * cross(r_pat, vo[j] - vbar);
        ln[j] = fmaxf(wl[j][0], 0.f) * act[j];  // the clamped warm impulse
        const float d_w = (m0[j] || m1[j]) ? ln[j] + seed[j] : 0.f;
        const float add[12] = {w_pat * (r2 - r_pat.x * r_pat.x),
                               w_pat * (r2 - r_pat.y * r_pat.y),
                               w_pat * (r2 - r_pat.z * r_pat.z),
                               w_pat * (-r_pat.x * r_pat.y),
                               w_pat * (-r_pat.x * r_pat.z),
                               w_pat * (-r_pat.y * r_pat.z),
                               bv.x, bv.y, bv.z, w_pat * r2,
                               m0[j] ? d_w : 0.f, m1[j] ? d_w : 0.f};
#pragma unroll
        for (int k = 0; k < 12; ++k) r2v[k] += add[k];
        l1[j] = d_w;  // parked until the pad sums are known
        any_pin = any_pin || m0[j] || m1[j];
      }
      warp_sum(r2v);
      any_pin = __any_sync(kFull, any_pin);
      M3 A;
      A.m[0] = r2v[0], A.m[4] = r2v[1], A.m[8] = r2v[2];
      A.m[1] = A.m[3] = r2v[3];
      A.m[2] = A.m[6] = r2v[4];
      A.m[5] = A.m[7] = r2v[5];
      V3 w_hand = mv(inv3(add_diag(A, 1e-8f)), v3(r2v[6], r2v[7], r2v[8]));
      if (!(W_pat > 1e-6f)) w_hand = v3(0.f, 0.f, 0.f);
      const float r_patch = sqrtf(r2v[9] * inv_w);
      // the brakes: G = omega P K_inv P [I, -crossmat(rbar)] (v_pat's
      // tangential stick mode, as plain's g_lin), omega i_world
      const M3 Sx = crossmat(rbar);
      M3 K_pat = scaled(-1.f, mm(mm(Sx, i_inv), Sx));
      K_pat = add_diag(K_pat, bd.inv_mass);
      const M3 K_inv = inv3(add_diag(K_pat, 1e-8f));
      M3 Pa;
      const float av[3] = {a_pinch.x, a_pinch.y, a_pinch.z};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          Pa.m[3 * i + k] = (i == k ? 1.f : 0.f) - av[i] * av[k];
      const M3 G_v = scaled(omega, mm(mm(Pa, K_inv), Pa));
      const M3 G_w = scaled(-1.f, mm(G_v, Sx));
      const V3 g_off = mv(G_v, vbar);
      const M3 HS = mm(i_inv, Sx);  // w += i_inv (rbar x d_l)
      const M3 IW = scaled(omega, inv3(add_diag(i_inv, 1e-12f)));
      const M3 IWHS = mm(IW, HS);
      const V3 iw_wh = mv(IW, w_hand);

      // pin each pad's normal impulses at its total (simplex rescale by
      // the pad's factor tot / sum)
      auto pinned = [&](int j, float d, float q0, float q1, float other) {
        return m0[j] ? d * q0 : (m1[j] ? d * q1 : other);
      };
      {
        const float q0 = tot0 / fmaxf(r2v[10], 1e-12f),
                    q1 = tot1 / fmaxf(r2v[11], 1e-12f);
        float r3[6] = {};
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          ln[j] = pinned(j, l1[j], q0, q1, ln[j]);
          const float cap0 = mu * ln[j];
          l1[j] = fminf(fmaxf(wl[j][1], -cap0), cap0) * act[j];
          l2[j] = fminf(fmaxf(wl[j][2], -cap0), cap0) * act[j];
          const V3 imp = ln[j] * n[j] + l1[j] * t1[j] + l2[j] * t2[j];
          const V3 tq = ln[j] * rxn[j] + l1[j] * rx1[j] + l2[j] * rx2[j];
          const float add[6] = {imp.x, imp.y, imp.z, tq.x, tq.y, tq.z};
#pragma unroll
          for (int k = 0; k < 6; ++k) r3[k] += add[k];
        }
        warp_sum(r3);
        v = v + bd.inv_mass * v3(r3[0], r3[1], r3[2]);
        w = w + mv(i_inv, v3(r3[3], r3[4], r3[5]));
      }
      PHASE_MARK(2);

      // 4. projected Jacobi
      // a lane's velocity along d: plain's Jacobian row [d; rarm x d]
      // against (v, w), less the collider's
      auto rel = [&](V3 d, V3 rxd, float vod) {
        return fmaf(d.x, v.x, fmaf(d.y, v.y, fmaf(d.z, v.z, fmaf(
            rxd.x, w.x, fmaf(rxd.y, w.y, fmaf(rxd.z, w.z, -vod))))));
      };
      float fmask[LPT];  // 1 on finger lanes
#pragma unroll
      for (int j = 0; j < LPT; ++j) fmask[j] = is_f[j] ? 1.f : 0.f;
      V3 la = v3(0.f, 0.f, 0.f), ll = v3(0.f, 0.f, 0.f);
      for (int it = 0; it < D.iters; ++it) {
        // an inactive lane has n = rarm x n = v_other = ln = l1 = l2 = 0,
        // so every update below leaves it at exactly 0 with no mask
        float lt[LPT], d[LPT], prs[LPT][2], rs[2];
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          lt[j] = fmaxf(ln[j] - rel(n[j], rxn[j], von[j]) * okn[j], 0.f);
          d[j] = (m0[j] || m1[j]) ? lt[j] + seed[j] : 0.f;
          prs[j][0] = m0[j] ? d[j] : 0.f;
          prs[j][1] = m1[j] ? d[j] : 0.f;
        }
        lane_tree(prs, rs);
        float q0 = 0.f, q1 = 0.f;
        if (any_pin) {
          warp_sum(rs);
          q0 = tot0 / fmaxf(rs[0], 1e-12f);
          q1 = tot1 / fmaxf(rs[1], 1e-12f);
        }
        float p4[LPT][10], r4[10];
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          float* r = p4[j];
#pragma unroll
          for (int k = 0; k < 10; ++k) r[k] = 0.f;
          const float ln_new = pinned(j, d[j], q0, q1, lt[j]);
          const float cap = mu * ln_new;
          const float l1_new = fminf(
              fmaxf(l1[j] - rel(t1[j], rx1[j], vo1[j]) * ok1[j], -cap), cap);
          const float l2_new = fminf(
              fmaxf(l2[j] - rel(t2[j], rx2[j], vo2[j]) * ok2[j], -cap), cap);
          const float dn = ln_new - ln[j], d1 = l1_new - l1[j],
                      d2 = l2_new - l2[j];
          acc3(r, dn, n[j], d1, t1[j], d2, t2[j]);
          acc3(r + 3, dn, rxn[j], d1, rx1[j], d2, rx2[j]);
          const float f1 = l1_new * fmask[j], f2 = l2_new * fmask[j];
          r[6] = ln_new * fmask[j];
          acc2(r + 7, f1, t1[j], f2, t2[j]);
          ln[j] = ln_new, l1[j] = l1_new, l2[j] = l2_new;
        }
        lane_tree(p4, r4);
        if (any_f) {
          warp_sum(r4);
        } else {
          float r4v[6] = {r4[0], r4[1], r4[2], r4[3], r4[4], r4[5]};
          warp_sum(r4v);
#pragma unroll
          for (int k = 0; k < 6; ++k) r4[k] = r4v[k];
        }
        v = v + bd.inv_mass * v3(r4[0], r4[1], r4[2]);
        w = w + mv(i_inv, v3(r4[3], r4[4], r4[5]));
        if (!any_f) continue;  // the brakes' budgets are 0: exact no-ops
        const float ln_f_tot = r4[6];
        const V3 iw_w = mv(IW, w);
        // patch linear brake, inside the shared Coulomb budget
        V3 ll_new = ll - (mv(G_v, v) + mv(G_w, w) - g_off);
        V3 f_pt = v3(r4[7], r4[8], r4[9]);
        f_pt = f_pt - dot(a_pinch, f_pt) * a_pinch;
        const float cap_lin = fmaxf(mu * ln_f_tot - norm(f_pt), 0.f);
        ll_new = fminf(cap_lin / fmaxf(norm(ll_new), 1e-12f), 1.f) * ll_new;
        const V3 d_l = ll_new - ll;
        v = v + bd.inv_mass * d_l;
        // patch angular brake, clamped to the patch's torque budget; its
        // omega i_world w' splits as IW w + (IW HS) d_l around the linear
        // brake's w' = w + HS d_l, so half of it runs beside that brake
        const float cap_ang = mu * ln_f_tot * r_patch;
        V3 la_new = la - (iw_w + mv(IWHS, d_l) - iw_wh);
        w = w + mv(HS, d_l);
        la_new = fminf(cap_ang / fmaxf(norm(la_new), 1e-12f), 1.f) * la_new;
        w = w + mv(i_inv, la_new - la);
        la = la_new, ll = ll_new;
      }
      PHASE_MARK(3);

      // pseudo pass: split-impulse projection, finger contacts excluded
      float bias[LPT], pl[LPT];
      bool any_bias = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        bias[j] = fminf(beta / dt * fmaxf(pen[j] - slop, 0.f), v_depen_max) *
                  (1.f - fminf(fmaxf(finger[j], 0.f), 1.f));
        pl[j] = 0.f;
        any_bias = any_bias || bias[j] > 0.f;
      }
      V3 pv = v3(0.f, 0.f, 0.f), pwv = v3(0.f, 0.f, 0.f);
      if (__any_sync(kFull, any_bias)) {  // else every pass is a no-op
        const int p_iters = D.iters / 4 > 4 ? D.iters / 4 : 4;
        for (int it = 0; it < p_iters; ++it) {
          float r5[6] = {};
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            const float vn = dot(n[j], pv) + dot(rxn[j], pwv);
            const float pl_new = fmaxf(pl[j] + (bias[j] - vn) * okn[j], 0.f);
            const float dn = pl_new - pl[j];
            const float add[6] = {dn * n[j].x,   dn * n[j].y,
                                  dn * n[j].z,   dn * rxn[j].x,
                                  dn * rxn[j].y, dn * rxn[j].z};
#pragma unroll
            for (int k = 0; k < 6; ++k) r5[k] += add[k];
            pl[j] = pl_new;
          }
          warp_sum(r5);
          pv = pv + bd.inv_mass * v3(r5[0], r5[1], r5[2]);
          pwv = pwv + mv(i_inv, v3(r5[3], r5[4], r5[5]));
        }
      }
      PHASE_MARK(4);

      // 5. diagnostics, new warm pools, damping, integration
      float r6[3] = {};
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const bool hand = lane + 32 * j < kr + kp;
        r6[0] += hand ? ln[j] : 0.f;
        r6[1] += hand ? act[j] : 0.f;
        r6[2] += hand ? 0.f : act[j];
      }
      warp_sum(r6);
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (prev_src[j] >= 0)
          for (int i = 0; i < 3; ++i) sm.pool[i * NP + prev_src[j]] = 0.f;
      __syncwarp();  // every old entry cleared before any new one lands
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (src[j] >= 0) {
          sm.pool[src[j]] = ln[j];
          sm.pool[NP + src[j]] = l1[j];
          sm.pool[2 * NP + src[j]] = l2[j];
        }
        prev_src[j] = src[j];
      }
      v = decay_l * v;
      w = decay_a * w;
      const V3 x = fr.x + dt * (v + pv);
      {
        const V3 wq = w + pwv;
        const float dq[4] = {
            -wq.x * q[1] - wq.y * q[2] - wq.z * q[3],
            wq.x * q[0] + wq.y * q[3] - wq.z * q[2],
            -wq.x * q[3] + wq.y * q[0] + wq.z * q[1],
            wq.x * q[2] - wq.y * q[1] + wq.z * q[0]};
        float qn[4], s = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qn[i] = q[i] + 0.5f * dt * dq[i];
          s += qn[i] * qn[i];
        }
        const float nq = fmaxf(sqrtf(s), 1e-9f);
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = qn[i] / nq;
      }
      if (lane == 0) {
        sm.bc[0] = x.x, sm.bc[1] = x.y, sm.bc[2] = x.z;
#pragma unroll
        for (int i = 0; i < 4; ++i) sm.bc[3 + i] = q[i];
        sm.bc[7] = jv_next[0], sm.bc[8] = jv_next[1];
        for (int i = 0; i < 4; ++i) sm.count[i] = 0;
        float* o =
            P.out_trace + (static_cast<long long>(b) * D.T + t) * kTrace;
        o[0] = x.x, o[1] = x.y, o[2] = x.z;
        o[3] = v.x, o[4] = v.y, o[5] = v.z;
        o[6] = q[0], o[7] = q[1], o[8] = q[2], o[9] = q[3];
        o[10] = w.x, o[11] = w.y, o[12] = w.z;
        o[13] = jv_next[0], o[14] = jv_next[1];
        o[15] = r6[0], o[16] = r6[1], o[17] = r6[2];
        o[18] = fmaxf(fmaxf(pm[0], pm[1]), 0.f);
      }
    }
    __syncthreads();  // the body's new pose, the cleared lists
    PHASE_MARK(5);
  }
  if (tid == 0) {
    float* o = P.out_state + b * 13;
    for (int i = 0; i < 7; ++i) o[i] = sm.bc[i];
    o[7] = v.x, o[8] = v.y, o[9] = v.z;
    o[10] = w.x, o[11] = w.y, o[12] = w.z;
#ifdef OMG_ROLLOUT_CYCLES
    for (int i = 0; i < kPhases; ++i) P.cycles[b * kPhases + i] = cyc[i];
#endif
  }
}

template <int LPT>
int launch(const Ptrs& P, const Dims& D, cudaStream_t stream) {
  const size_t smem = Smem<LPT>::bytes(D.K + 2 * D.Sp + D.S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rigid_rollout_kernel<LPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
#ifdef OMG_CUDA_EMU
  emu::launch(rigid_rollout_kernel<LPT>, D.B, kThreads, smem, P, D);
#else
  rigid_rollout_kernel<LPT><<<D.B, kThreads, smem, stream>>>(P, D);
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: the 23 device pointers of Ptrs in order (24 in the profile
// build); dims: the 13 ints of Dims.  At most 256 contact lanes.
// Launches on `stream`; returns the first CUDA error of the set-up, or
// cudaGetLastError() after the launch.
extern "C" int OMG_ROLLOUT_ENTRY(void* const* ptrs, const int* dims,
                                 void* stream) {
  Ptrs P;
  void** dst = reinterpret_cast<void**>(&P);
  for (int i = 0; i < static_cast<int>(sizeof(Ptrs) / sizeof(void*)); ++i)
    dst[i] = ptrs[i];
  Dims D{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
         dims[7], dims[8], dims[9], dims[10], dims[11], dims[12]};
  if (D.B <= 0 || D.T <= 0) return static_cast<int>(cudaGetLastError());
  const int C = D.kr + D.kp + D.kw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 128) return launch<4>(P, D, s);
  if (C <= 256) return launch<8>(P, D, s);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}
