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
// Layout: one thread block per rollout; thread c owns contact lane c
// (C = k_robot + k_pad + k_world lanes, 48 + 32 + 48 = 128 at full width)
// through the solve and keeps its contact, tangent basis, effective masses
// and accumulated impulses in registers.  Per substep:
//  1. every candidate of the three pools (robot spheres K = 480 at full
//     width, pad samples 2 x Sp = 192, body surface samples S = 96 against
//     every static) is scored by strided loops into shared memory;
//  2. the top-k of each pool comes from each active candidate's exact rank
//     (score descending, lower index first on ties: jax.lax.top_k's
//     order);
//  3. each lane recomputes its contact from its candidate index (the same
//     non-inlined function as the scoring, so the same bits) and gathers
//     its warm start from the pools, which stay in shared memory for the
//     whole rollout and are keyed by candidate index;
//  4. the projected-Jacobi loop (iters) and the pseudo pass (iters / 4,
//     at least 4): each iteration's sums over lanes are warp butterflies
//     plus one shared-memory exchange, read in one fixed order by every
//     thread, so every thread holds the same body velocity and runs the
//     per-body updates (patch brakes, 3 x 3 products) redundantly, with no
//     second barrier;
//  5. new pools (zeros except the active lanes' candidates), damping,
//     integration, one trace row.
//
// Arithmetic: fp32, no fast math; the 3 x 3 solves (A + 1e-8 I,
// i_inv + 1e-12 I, K_pat + 1e-8 I) by the adjugate; w_hand gated on
// W_pat > 1e-6 as the plain version does.
//
// Bound: not bytes and not flops.  Per substep the block runs a chain of
// about 2 x iters + iters / 4 + 8 block barriers, each behind a warp
// butterfly and followed by the per-body update, so a rollout is a
// dependency chain of ~415 x (96 + 24) dependent iterations at full width.
// The roofline (track bytes over 3.35 TB/s, the counted flops over
// 67 TFLOP/s) is far below it; chip_smoke.py reports both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kRed = 16;  // most floats in one block reduction
constexpr int kTrace = 19;  // x3 v3 q4 w3 jv2 impulse robot# world# pad_pen

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
};

struct Dims {
  int B, T, K, Sp, S, O, Og, Ng, Nb, kr, kp, kw, iters;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return {x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 unit(V3 a) {
  return (1.f / fmaxf(norm(a), 1e-9f)) * a;
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

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
  const float r = 1.f / det;
#pragma unroll
  for (int i = 0; i < 9; ++i) c.m[i] *= r;
  return c;
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

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Penalised analytic SDF and its object-frame gradient at p
// (ops/sdf.py::_analytic_sdf_grad for one point).
__device__ __noinline__ float analytic_sdf_grad(int kind, V3 half, float penal,
                                                float round, V3 p, V3* g) {
  const float tiny = 1e-12f;
  const float rr = fminf(round, 0.45f * fminf(half.x, fminf(half.y, half.z)));
  const V3 hb = v3(half.x - rr, half.y - rr, half.z - rr);
  const V3 sp = v3(sgn(p.x), sgn(p.y), sgn(p.z));
  const V3 q = v3(fabsf(p.x) - hb.x, fabsf(p.y) - hb.y, fabsf(p.z) - hb.z);
  float d;
  V3 grad;
  if (kind == 0) {
    const V3 qp = v3(fmaxf(q.x, 0.f), fmaxf(q.y, 0.f), fmaxf(q.z, 0.f));
    const float l_out = sqrtf(qp.x * qp.x + qp.y * qp.y + qp.z * qp.z);
    const float qmax = fmaxf(q.x, fmaxf(q.y, q.z));
    d = l_out + fminf(qmax, 0.f);
    if (l_out > 0.f) {
      const float s = fmaxf(l_out, tiny);
      grad = v3(sp.x * qp.x / s, sp.y * qp.y / s, sp.z * qp.z / s);
    } else {
      const float mx = q.x == qmax ? 1.f : 0.f, my = q.y == qmax ? 1.f : 0.f,
                  mz = q.z == qmax ? 1.f : 0.f;
      const float cnt = fmaxf(mx + my + mz, 1.f);
      grad = v3(sp.x * (mx / cnt), sp.y * (my / cnt), sp.z * (mz / cnt));
    }
  } else if (kind == 1) {
    const float pn = sqrtf(p.x * p.x + p.y * p.y + p.z * p.z);
    d = pn - hb.x;
    const float s = fmaxf(pn, tiny);
    grad = v3(p.x / s, p.y / s, p.z / s);
  } else {
    const float rho = sqrtf(p.x * p.x + p.y * p.y);
    const float dr = rho - hb.x;
    const float a = fmaxf(dr, 0.f), b = fmaxf(q.z, 0.f);
    const float l = sqrtf(a * a + b * b);
    d = l + fminf(fmaxf(dr, q.z), 0.f);
    const float rs = fmaxf(rho, tiny);
    const float erx = p.x / rs, ery = p.y / rs;
    if (l > 0.f) {
      const float ls = fmaxf(l, tiny);
      const float al = a / ls;
      grad = v3(al * erx, al * ery, (b / ls) * sp.z);
    } else if (dr >= q.z) {
      grad = v3(erx, ery, 0.f);
    } else {
      grad = v3(0.f, 0.f, sp.z);
    }
  }
  d = d - rr;
  const float scale = d < 0.f ? penal : 1.f;
  *g = scale * grad;
  return d * scale;
}

// 4-channel trilinear read of a flat baked grid (value + gradient), out of
// volume (1, 0): ops/sdf.py::_query_one_object_baked of the JAX package.
__device__ __noinline__ float grid_sdf_grad(const float4* g4,
                                            const float* lim, V3 p, V3* g) {
  const int d0 = static_cast<int>(lim[6]), d1 = static_cast<int>(lim[7]),
            d2 = static_cast<int>(lim[8]);
  const float px = (p.x - lim[0]) / (lim[3] - lim[0]) * static_cast<float>(d0);
  const float py = (p.y - lim[1]) / (lim[4] - lim[1]) * static_cast<float>(d1);
  const float pz = (p.z - lim[2]) / (lim[5] - lim[2]) * static_cast<float>(d2);
  const float ax = px - 0.5f, ay = py - 0.5f, az = pz - 0.5f;
  const int x0 = static_cast<int>(truncf(ax)), y0 = static_cast<int>(truncf(ay)),
            z0 = static_cast<int>(truncf(az));
  const float fx = ax - static_cast<float>(x0),
              fy = ay - static_cast<float>(y0),
              fz = az - static_cast<float>(z0);
  const bool inb = x0 >= 0 && x0 + 1 < d0 && y0 >= 0 && y0 + 1 < d1 &&
                   z0 >= 0 && z0 + 1 < d2;
  if (!inb) {
    *g = v3(0.f, 0.f, 0.f);
    return 1.f;
  }
  const long long base =
      (static_cast<long long>(x0) * d1 + y0) * d2 + z0;
  auto val = [&](int dx, int dy, int dz) {
    return g4[base + (static_cast<long long>(dx) * d1 + dy) * d2 + dz];
  };
  auto lerp4 = [](float4 a, float4 b, float f) {
    return make_float4(a.x * (1 - f) + b.x * f, a.y * (1 - f) + b.y * f,
                       a.z * (1 - f) + b.z * f, a.w * (1 - f) + b.w * f);
  };
  const float4 dx00 = lerp4(val(0, 0, 0), val(1, 0, 0), fx);
  const float4 dx01 = lerp4(val(0, 0, 1), val(1, 0, 1), fx);
  const float4 dx10 = lerp4(val(0, 1, 0), val(1, 1, 0), fx);
  const float4 dx11 = lerp4(val(0, 1, 1), val(1, 1, 1), fx);
  const float4 dxy0 = lerp4(dx00, dx10, fy);
  const float4 dxy1 = lerp4(dx01, dx11, fy);
  const float4 out = lerp4(dxy0, dxy1, fz);
  *g = v3(out.y, out.z, out.w);
  return out.x;
}

struct Body {
  int kind;
  V3 half;
  float round, inv_mass;
  M3 inv_inertia;
};

__device__ __forceinline__ float body_sdf(const Ptrs& P, const Dims& D,
                                          const Body& bd, V3 rel, V3* g) {
  if (D.Nb > 0) return grid_sdf_grad(P.body_grid, P.body_lim, rel, g);
  return analytic_sdf_grad(bd.kind, bd.half, 1.f, bd.round, rel, g);
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

// Pad pose of finger f at joint offset dv: the tracked pose translated by
// R (axis * dv) (rigid.py::_pad_pose).
__device__ __forceinline__ Pose pad_pose(const Ptrs& P, const Dims& D, int b,
                                         int t, int f, float dv) {
  Pose p = load_pose(P.pad_track + ((static_cast<long long>(b) * (D.T + 1) +
                                     t) * 2 + f) * 16);
  const V3 ax = load3(P.pad_axis + (b * 2 + f) * 3);
  p.t = p.t + mv(p.r, v3(ax.x * dv, ax.y * dv, ax.z * dv));
  return p;
}

// One candidate contact.  Robot spheres and pad samples: the body's SDF
// at the point; world samples: the minimum over statics.
struct Cand {
  V3 p, n, v_other;
  float pen, finger;
};

struct Frame {  // per-substep body frame
  V3 x;
  M3 r;
};

__device__ __noinline__ Cand robot_cand(const Ptrs& P, const Dims& D,
                                        const Body& bd, const Frame& fr,
                                        float radius, float dt, int b, int t,
                                        int i) {
  const float* s0 =
      P.sph + ((static_cast<long long>(b) * (D.T + 1) + t) * D.K + i) * 3;
  const V3 s = load3(s0);
  const V3 rel = mtv(fr.r, s - fr.x);
  V3 g;
  const float phi = body_sdf(P, D, bd, rel, &g);
  const V3 n_out = unit(mv(fr.r, g));
  Cand c;
  c.pen = radius - phi;
  c.p = s - phi * n_out;
  c.n = -n_out;
  const V3 s1 = load3(s0 + static_cast<long long>(D.K) * 3);
  c.v_other = v3((s1.x - s.x) / dt, (s1.y - s.y) / dt, (s1.z - s.z) / dt);
  c.finger = 0.f;
  return c;
}

__device__ __noinline__ Cand pad_cand(const Ptrs& P, const Dims& D,
                                      const Body& bd, const Frame& fr,
                                      const Pose& pose, const Pose& next,
                                      float dt, int f, int s) {
  const V3 ps = load3(P.pad_samples + (f * D.Sp + s) * 3);
  const V3 sp_w = mv(pose.r, ps) + pose.t;
  const V3 nx = mv(next.r, ps) + next.t;
  const V3 rel = mtv(fr.r, sp_w - fr.x);
  V3 g;
  const float phi = body_sdf(P, D, bd, rel, &g);
  const V3 n_out = unit(mv(fr.r, g));
  Cand c;
  c.pen = 1e-3f - phi;
  c.p = sp_w - phi * n_out;
  c.n = -n_out;
  c.v_other = v3((nx.x - sp_w.x) / dt, (nx.y - sp_w.y) / dt,
                 (nx.z - sp_w.z) / dt);
  c.finger = 1.f + static_cast<float>(f);
  return c;
}

__device__ __noinline__ Cand world_cand(const Ptrs& P, const Dims& D,
                                        const Frame& fr, int s) {
  const V3 pw = fr.x + mv(fr.r, load3(P.surf + s * 3));
  float phi_min = INFINITY;
  V3 n_w = v3(0.f, 0.f, 0.f);
  bool first = true;
  for (int o = 0; o < D.O; ++o) {
    const Pose inv = load_pose(P.w_inv + o * 16);
    V3 g;
    float phi = analytic_sdf_grad(P.w_kinds[o], load3(P.w_halfs + o * 3), 1.f,
                                  P.w_rounds[o], mv(inv.r, pw) + inv.t, &g);
    if (!(P.w_mask[o] > 0.5f)) phi = INFINITY;
    // argmin, first index on ties (object 0 when every value is +inf)
    if (first || phi < phi_min) {
      phi_min = phi;
      n_w = mtv(inv.r, g);
      first = false;
    }
  }
  if (D.Og > 0) {
    float phi_gm = 0.f;
    V3 n_g = v3(0.f, 0.f, 0.f);
    for (int o = 0; o < D.Og; ++o) {
      const Pose inv = load_pose(P.wg_inv + o * 16);
      V3 g;
      const float phi =
          grid_sdf_grad(P.wg + static_cast<long long>(o) * D.Ng,
                        P.wg_lim + o * 10, mv(inv.r, pw) + inv.t, &g);
      if (o == 0 || phi < phi_gm) {
        phi_gm = phi;
        n_g = mtv(inv.r, g);
      }
    }
    if (phi_gm < phi_min) {
      phi_min = phi_gm;
      n_w = n_g;
    }
  }
  Cand c;
  c.p = pw;
  c.n = unit(n_w);
  c.pen = -phi_min;
  c.v_other = v3(0.f, 0.f, 0.f);
  c.finger = 0.f;
  return c;
}

// Block-wide sums (or maxima) of N floats.  Every thread returns the same
// bits: warp butterflies (commutative at each stage), then one fixed-order
// pass over the warps' partials.  Two buffers alternate, so one barrier a
// reduction is enough.
template <int N, bool kMax = false>
__device__ __forceinline__ void block_reduce(float (&a)[N],
                                             float (*red)[kMaxWarps][kRed],
                                             int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = a[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, s, off);
      s = kMax ? fmaxf(s, o) : s + o;
    }
    a[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[buf][warp][k] = a[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = red[buf][0][k];
    for (int w = 1; w < nw; ++w)
      s = kMax ? fmaxf(s, red[buf][w][k]) : s + red[buf][w][k];
    a[k] = s;
  }
  buf ^= 1;
}

__global__ void rigid_rollout_kernel(Ptrs P, Dims D) {
  extern __shared__ float smem[];
  __shared__ float red[2][kMaxWarps][kRed];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int K = D.K, Sp2 = 2 * D.Sp, S = D.S;
  const int NP = K + Sp2 + S;                     // candidates of the pools
  const int kr = D.kr, kp = D.kp, C = D.kr + D.kp + D.kw;
  float* pool = smem;                             // [3][NP]: ln, l1, l2
  float* score = smem + 3 * NP;                   // [NP]
  int* lane_src = reinterpret_cast<int*>(score + NP);         // [C]
  float* lane_n = reinterpret_cast<float*>(lane_src + C);      // [C][4]
  int buf = 0;

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
  V3 x = load3(s0), v = load3(s0 + 7), w = load3(s0 + 10);
  float q[4] = {s0[3], s0[4], s0[5], s0[6]};
  const float* jvt = P.jv_track + static_cast<long long>(b) * (D.T + 1) * 2;
  float jv[2] = {jvt[0], jvt[1]};
  const float jv_ref[2] = {P.jv_ref[b * 2], P.jv_ref[b * 2 + 1]};

  for (int i = tid; i < 3 * NP; i += nthr) pool[i] = 0.f;

  for (int t = 0; t < D.T; ++t) {
    Frame fr;
    fr.x = x;
    fr.r = quat_to_mat(q);
    Pose pad[2];
    for (int f = 0; f < 2; ++f)
      pad[f] = pad_pose(P, D, b, t, f, jv[f] - jv_ref[f]);

    // 1. score every candidate; each pad's largest penetration
    float pmax[2] = {-INFINITY, -INFINITY};
    for (int i = tid; i < NP; i += nthr) {
      float pen;
      bool act;
      if (i < K) {
        const Cand c = robot_cand(P, D, bd, fr, radius, dt, b, t, i);
        pen = c.pen;
        act = static_cast<float>(pen > 0.f) * (1.f - P.is_finger[i]) > 0.5f;
      } else if (i < K + Sp2) {
        const int j = i - K, f = j >= D.Sp ? 1 : 0;
        const Cand c = pad_cand(P, D, bd, fr, pad[f], pad[f], dt, f,
                                j - f * D.Sp);
        pen = c.pen;
        pmax[f] = fmaxf(pmax[f], pen);
        act = pen > 0.f;
      } else {
        pen = world_cand(P, D, fr, i - K - Sp2).pen;
        act = pen > 0.f;
      }
      score[i] = act ? pen : -INFINITY;
    }
    for (int c = tid; c < C; c += nthr) lane_src[c] = -1;
    block_reduce<2, true>(pmax, red, buf);  // also publishes the scores

    // finger motors: advance toward the command unless stalled
    const float* cmd = jvt + (t + 1) * 2;
    float jv_next[2];
    Pose pad_next[2];
    const float rate = finger_rate * dt;
    for (int f = 0; f < 2; ++f) {
      const float step = fminf(fmaxf(cmd[f] - jv[f], -rate), rate);
      const bool stalled = pmax[f] >= stall_pen && step < 0.f;
      jv_next[f] = stalled ? jv[f] : jv[f] + step;
      pad_next[f] = pad_pose(P, D, b, t + 1, f, jv_next[f] - jv_ref[f]);
    }

    // 2. top-k of each pool by exact rank
    for (int i = tid; i < NP; i += nthr) {
      const float si = score[i];
      if (si == -INFINITY) continue;
      int lo, hi, k, lane0;
      if (i < K) {
        lo = 0, hi = K, k = kr, lane0 = 0;
      } else if (i < K + Sp2) {
        lo = K, hi = K + Sp2, k = kp, lane0 = kr;
      } else {
        lo = K + Sp2, hi = NP, k = D.kw, lane0 = kr + kp;
      }
      int rank = 0;
      for (int j = lo; j < hi && rank < k; ++j) {
        const float sj = score[j];
        rank += (sj > si) || (sj == si && j < i);
      }
      if (rank < k) lane_src[lane0 + rank] = i;
    }
    __syncthreads();

    // 3. each lane's contact, recomputed from its candidate
    const int c = tid;
    const int src = c < C ? lane_src[c] : -1;
    const float act = src >= 0 ? 1.f : 0.f;
    Cand cd;
    cd.p = cd.n = cd.v_other = v3(0.f, 0.f, 0.f);
    cd.pen = 0.f;
    cd.finger = 0.f;
    float wl[3] = {0.f, 0.f, 0.f};
    if (src >= 0) {
      if (src < K) {
        cd = robot_cand(P, D, bd, fr, radius, dt, b, t, src);
      } else if (src < K + Sp2) {
        const int j = src - K, f = j >= D.Sp ? 1 : 0;
        cd = pad_cand(P, D, bd, fr, pad[f], pad_next[f], dt, f, j - f * D.Sp);
      } else {
        cd = world_cand(P, D, fr, src - K - Sp2);
      }
      cd.pen = fmaxf(cd.pen, 0.f);
      for (int i = 0; i < 3; ++i) wl[i] = pool[i * NP + src];
    }
    if (c < C) {
      lane_n[4 * c] = cd.n.x;
      lane_n[4 * c + 1] = cd.n.y;
      lane_n[4 * c + 2] = cd.n.z;
      lane_n[4 * c + 3] = act;
    }
    // gravity enters before the solve
    v = v + dt * gravity;
    const M3 i_inv = mm(mm(fr.r, bd.inv_inertia), transpose(fr.r));
    const V3 rarm = cd.p - x;
    const V3 ref = fabsf(cd.n.z) < 0.9f ? v3(0.f, 0.f, 1.f) : v3(1.f, 0.f, 0.f);
    const V3 t1 = unit(cross(cd.n, ref));
    const V3 t2 = cross(cd.n, t1);
    auto eff_k = [&](V3 d) {
      return bd.inv_mass + dot(cross(mv(i_inv, cross(rarm, d)), rarm), d);
    };
    __syncthreads();  // lane normals visible
    float split = 0.f;
    if (act > 0.f) {
      for (int j = 0; j < C; ++j) {
        const float nn = cd.n.x * lane_n[4 * j] + cd.n.y * lane_n[4 * j + 1] +
                         cd.n.z * lane_n[4 * j + 2];
        split += nn * nn * lane_n[4 * j + 3];
      }
    }
    split = fmaxf(split, 1.f);
    const float k_n = fmaxf(eff_k(cd.n), 1e-6f) * split;
    const float k_1 = fmaxf(eff_k(t1), 1e-6f) * split;
    const float k_2 = fmaxf(eff_k(t2), 1e-6f) * split;

    // finger motors and patch sums
    const float engage = fminf(fmaxf(cd.pen / stall_pen, 0.f), 1.f);
    const bool is_f = cd.finger > 0.5f;
    const float pw0 = (fabsf(cd.finger - 1.f) < 0.25f ? 1.f : 0.f) * act *
                      engage;
    const float pw1 = (fabsf(cd.finger - 2.f) < 0.25f ? 1.f : 0.f) * act *
                      engage;
    const float w_pat = pw0 + pw1;
    float r1[15] = {pw0, pw1, w_pat,
                    w_pat * cd.p.x, w_pat * cd.p.y, w_pat * cd.p.z,
                    w_pat * cd.v_other.x, w_pat * cd.v_other.y,
                    w_pat * cd.v_other.z,
                    pw0 * cd.n.x, pw0 * cd.n.y, pw0 * cd.n.z,
                    w_pat * rarm.x, w_pat * rarm.y, w_pat * rarm.z};
    block_reduce<15>(r1, red, buf);
    const float eng0 = fminf(r1[0], 1.f), eng1 = fminf(r1[1], 1.f);
    const float tot0 = pinch * dt * eng0 * eng1;
    const float tot1 = pinch * dt * eng1 * eng0;
    const float W_pat = r1[2];
    const float inv_w = 1.f / fmaxf(W_pat, 1e-9f);
    const V3 pbar = inv_w * v3(r1[3], r1[4], r1[5]);
    const V3 vbar = inv_w * v3(r1[6], r1[7], r1[8]);
    const V3 a_pinch = unit(v3(r1[9], r1[10], r1[11]));
    const V3 rbar = inv_w * v3(r1[12], r1[13], r1[14]);
    // the lane's pad: mask, pinned total and engagement seed
    const bool m0 = pw0 > 0.f, m1 = pw1 > 0.f;
    const float tot_l = m0 ? tot0 : tot1;
    const float seed = 1e-3f * tot_l * (m0 ? pw0 : pw1);

    const V3 r_pat = cd.p - pbar;
    const float r2 = dot(r_pat, r_pat);
    const V3 bv = w_pat * cross(r_pat, cd.v_other - vbar);
    // warm start: the clamped warm normal impulse, pinned per pad
    const float ln_w = fmaxf(wl[0], 0.f) * act;
    const float d_w = (m0 || m1) ? ln_w + seed : 0.f;
    float r2v[12] = {w_pat * (r2 - r_pat.x * r_pat.x),
                     w_pat * (r2 - r_pat.y * r_pat.y),
                     w_pat * (r2 - r_pat.z * r_pat.z),
                     w_pat * (-r_pat.x * r_pat.y),
                     w_pat * (-r_pat.x * r_pat.z),
                     w_pat * (-r_pat.y * r_pat.z),
                     bv.x, bv.y, bv.z, w_pat * r2,
                     m0 ? d_w : 0.f, m1 ? d_w : 0.f};
    block_reduce<12>(r2v, red, buf);
    M3 A;
    A.m[0] = r2v[0], A.m[4] = r2v[1], A.m[8] = r2v[2];
    A.m[1] = A.m[3] = r2v[3];
    A.m[2] = A.m[6] = r2v[4];
    A.m[5] = A.m[7] = r2v[5];
    V3 w_hand = mv(inv3(add_diag(A, 1e-8f)), v3(r2v[6], r2v[7], r2v[8]));
    if (!(W_pat > 1e-6f)) w_hand = v3(0.f, 0.f, 0.f);
    const float r_patch = sqrtf(r2v[9] * inv_w);
    const M3 i_world = inv3(add_diag(i_inv, 1e-12f));
    // K_pat = m^-1 I - S i_inv S with S = crossmat(rbar)
    M3 Sx;
    Sx.m[0] = 0.f, Sx.m[1] = -rbar.z, Sx.m[2] = rbar.y;
    Sx.m[3] = rbar.z, Sx.m[4] = 0.f, Sx.m[5] = -rbar.x;
    Sx.m[6] = -rbar.y, Sx.m[7] = rbar.x, Sx.m[8] = 0.f;
    M3 K_pat = mm(mm(Sx, i_inv), Sx);
#pragma unroll
    for (int i = 0; i < 9; ++i) K_pat.m[i] = -K_pat.m[i];
    K_pat = add_diag(K_pat, bd.inv_mass);
    const M3 K_inv = inv3(add_diag(K_pat, 1e-8f));

    // pin each pad's normal impulses at its total (simplex rescale)
    auto pinned = [&](float d, float s0_, float s1_, float other) {
      if (m0) return tot0 * d / fmaxf(s0_, 1e-12f);
      if (m1) return tot1 * d / fmaxf(s1_, 1e-12f);
      return other;
    };
    float ln = pinned(d_w, r2v[10], r2v[11], ln_w);
    const float cap0 = mu * ln;
    float l1 = fminf(fmaxf(wl[1], -cap0), cap0) * act;
    float l2 = fminf(fmaxf(wl[2], -cap0), cap0) * act;
    {
      const V3 imp = ln * cd.n + l1 * t1 + l2 * t2;
      const V3 tq = cross(rarm, imp);
      float r3[6] = {imp.x, imp.y, imp.z, tq.x, tq.y, tq.z};
      block_reduce<6>(r3, red, buf);
      v = v + bd.inv_mass * v3(r3[0], r3[1], r3[2]);
      w = w + mv(i_inv, v3(r3[3], r3[4], r3[5]));
    }

    // 4. projected Jacobi
    V3 la = v3(0.f, 0.f, 0.f), ll = v3(0.f, 0.f, 0.f);
    for (int it = 0; it < D.iters; ++it) {
      const V3 vr = v + cross(w, rarm) - cd.v_other;
      const float vn = dot(cd.n, vr);
      const float lt = fmaxf(ln - omega * vn / k_n, 0.f) * act;
      const float d = (m0 || m1) ? lt + seed : 0.f;
      float rs[2] = {m0 ? d : 0.f, m1 ? d : 0.f};
      block_reduce<2>(rs, red, buf);
      const float ln_new = pinned(d, rs[0], rs[1], lt);
      const float d_n = ln_new - ln;
      const float v1 = dot(t1, vr), v2 = dot(t2, vr);
      const float cap = mu * ln_new;
      const float l1_new = fminf(fmaxf(l1 - omega * v1 / k_1, -cap), cap) * act;
      const float l2_new = fminf(fmaxf(l2 - omega * v2 / k_2, -cap), cap) * act;
      const V3 imp = d_n * cd.n + (l1_new - l1) * t1 + (l2_new - l2) * t2;
      const V3 tq = cross(rarm, imp);
      const V3 fp = is_f ? l1_new * t1 + l2_new * t2 : v3(0.f, 0.f, 0.f);
      float r4[10] = {imp.x, imp.y, imp.z, tq.x, tq.y, tq.z,
                      is_f ? ln_new : 0.f, fp.x, fp.y, fp.z};
      block_reduce<10>(r4, red, buf);
      v = v + bd.inv_mass * v3(r4[0], r4[1], r4[2]);
      w = w + mv(i_inv, v3(r4[3], r4[4], r4[5]));
      const float ln_f_tot = r4[6];
      // patch linear brake, inside the shared Coulomb budget
      const V3 v_pat = v + cross(w, rbar) - vbar;
      const V3 v_t = v_pat - dot(a_pinch, v_pat) * a_pinch;
      V3 ll_new = ll - omega * mv(K_inv, v_t);
      ll_new = ll_new - dot(a_pinch, ll_new) * a_pinch;
      V3 f_pt = v3(r4[7], r4[8], r4[9]);
      f_pt = f_pt - dot(a_pinch, f_pt) * a_pinch;
      const float cap_lin = fmaxf(mu * ln_f_tot - norm(f_pt), 0.f);
      ll_new = fminf(cap_lin / fmaxf(norm(ll_new), 1e-12f), 1.f) * ll_new;
      const V3 d_l = ll_new - ll;
      v = v + bd.inv_mass * d_l;
      w = w + mv(i_inv, cross(rbar, d_l));
      // patch angular brake, clamped to the patch's torque budget
      const float cap_ang = mu * ln_f_tot * r_patch;
      V3 la_new = la - omega * mv(i_world, w - w_hand);
      la_new = fminf(cap_ang / fmaxf(norm(la_new), 1e-12f), 1.f) * la_new;
      w = w + mv(i_inv, la_new - la);
      ln = ln_new, l1 = l1_new, l2 = l2_new, la = la_new, ll = ll_new;
    }

    // pseudo pass: split-impulse projection, finger contacts excluded
    const float bias = fminf(beta / dt * fmaxf(cd.pen - slop, 0.f),
                             v_depen_max) *
                       (1.f - fminf(fmaxf(cd.finger, 0.f), 1.f));
    V3 pv = v3(0.f, 0.f, 0.f), pwv = v3(0.f, 0.f, 0.f);
    float pl = 0.f;
    const int p_iters = D.iters / 4 > 4 ? D.iters / 4 : 4;
    for (int it = 0; it < p_iters; ++it) {
      const V3 vrel = pv + cross(pwv, rarm);
      const float vn = dot(cd.n, vrel);
      const float pl_new = fmaxf(pl + omega * (bias - vn) / k_n, 0.f) * act;
      const V3 dd = (pl_new - pl) * cd.n;
      const V3 tq = cross(rarm, dd);
      float r5[6] = {dd.x, dd.y, dd.z, tq.x, tq.y, tq.z};
      block_reduce<6>(r5, red, buf);
      pv = pv + bd.inv_mass * v3(r5[0], r5[1], r5[2]);
      pwv = pwv + mv(i_inv, v3(r5[3], r5[4], r5[5]));
      pl = pl_new;
    }

    // 5. diagnostics, new warm pools, damping, integration
    const bool hand = c < kr + kp;
    float r6[3] = {hand ? ln : 0.f, hand ? act : 0.f, hand ? 0.f : act};
    block_reduce<3>(r6, red, buf);  // after it no thread reads the pools
    for (int i = tid; i < 3 * NP; i += nthr) pool[i] = 0.f;
    __syncthreads();
    if (src >= 0) {
      pool[src] = ln;
      pool[NP + src] = l1;
      pool[2 * NP + src] = l2;
    }
    v = decay_l * v;
    w = decay_a * w;
    x = x + dt * (v + pv);
    {
      const V3 wq = w + pwv;
      const float dq[4] = {
          -wq.x * q[1] - wq.y * q[2] - wq.z * q[3],
          wq.x * q[0] + wq.y * q[3] - wq.z * q[2],
          -wq.x * q[3] + wq.y * q[0] + wq.z * q[1],
          wq.x * q[2] - wq.y * q[1] + wq.z * q[0]};
      float qn[4], s = 0.f;
      for (int i = 0; i < 4; ++i) {
        qn[i] = q[i] + 0.5f * dt * dq[i];
        s += qn[i] * qn[i];
      }
      const float nq = fmaxf(sqrtf(s), 1e-9f);
      for (int i = 0; i < 4; ++i) q[i] = qn[i] / nq;
    }
    jv[0] = jv_next[0];
    jv[1] = jv_next[1];
    if (tid == 0) {
      float* o = P.out_trace + (static_cast<long long>(b) * D.T + t) * kTrace;
      o[0] = x.x, o[1] = x.y, o[2] = x.z;
      o[3] = v.x, o[4] = v.y, o[5] = v.z;
      o[6] = q[0], o[7] = q[1], o[8] = q[2], o[9] = q[3];
      o[10] = w.x, o[11] = w.y, o[12] = w.z;
      o[13] = jv[0], o[14] = jv[1];
      o[15] = r6[0], o[16] = r6[1], o[17] = r6[2];
      o[18] = fmaxf(fmaxf(pmax[0], pmax[1]), 0.f);
    }
    // the next substep's first barrier orders these pool writes before
    // its reads
  }
  if (tid == 0) {
    float* o = P.out_state + b * 13;
    o[0] = x.x, o[1] = x.y, o[2] = x.z;
    o[3] = q[0], o[4] = q[1], o[5] = q[2], o[6] = q[3];
    o[7] = v.x, o[8] = v.y, o[9] = v.z;
    o[10] = w.x, o[11] = w.y, o[12] = w.z;
  }
}

size_t smem_bytes(const Dims& D) {
  const int NP = D.K + 2 * D.Sp + D.S, C = D.kr + D.kp + D.kw;
  return sizeof(float) * (4 * static_cast<size_t>(NP) + 5 * C);
}

}  // namespace

// ptrs: the 23 device pointers of Ptrs in order; dims: the 13 ints of
// Dims.  Launches on `stream`; returns the first CUDA error of the set-up,
// or cudaGetLastError() after the launch.
extern "C" int omg_rigid_rollout(void* const* ptrs, const int* dims,
                                 void* stream) {
  Ptrs P;
  void** dst = reinterpret_cast<void**>(&P);
  for (int i = 0; i < static_cast<int>(sizeof(Ptrs) / sizeof(void*)); ++i)
    dst[i] = ptrs[i];
  Dims D{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
         dims[7], dims[8], dims[9], dims[10], dims[11], dims[12]};
  if (D.B <= 0 || D.T <= 0) return static_cast<int>(cudaGetLastError());
  // threads: a multiple of 32 covering the C lanes, at least 64
  const int C = D.kr + D.kp + D.kw;
  const int threads = ((C > 64 ? C : 64) + 31) / 32 * 32;
  if (threads > 32 * kMaxWarps)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rigid_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rigid_rollout_kernel<<<D.B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(P, D);
  return static_cast<int>(cudaGetLastError());
}
