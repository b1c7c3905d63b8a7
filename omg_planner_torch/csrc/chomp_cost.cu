// The CHOMP plan step after FK and the collision query, for Hopper (sm_90a):
// two kernels, one block a scene row each.
//
// chomp_obstacle computes ops/kernels.py::chomp_obstacle_plain: from the
// body points x [T, L, P, 3] of a trajectory, its joints' world origins and
// axes [T, J, 3], the body points at the start and the end [L, P, 3] and
// the query's potentials, world gradients and collisions [T, L, P] it
// forms, at every point, the finger softening, the endpoint-corrected
// velocity v and acceleration a (the banded difference matrices of the
// horizon, get_derivative's boundary terms), the cost pot |v| and the
// direction |v| P g - pot P a / (|v|^2 + 1e-8) with P = I - v^ v^T; selects
// the points whose potential is at least the exact k-th largest of the T L
// P potentials (the finger links dropped unless consider_finger); and sums
// the selected costs per (t, link) and J^T direction per (t, dof), J the
// point's linear Jacobian formed on the fly from the joint frames (never
// written).  Under ref_topk_quirks: one gradient point per (t, link), the
// selected point of largest potential (the first among equal ones), and
// the per-link cost summed over t and broadcast.  It replaces the JAX
// package's XLA code of omg_planner_tpu/ops/chomp.py:148-262
// (forward_kinematics_obstacle after the query, _functional_grad_terms,
// compute_collision_loss) and utils/diff.py::get_derivative; it has no
// Pallas counterpart.
//
// chomp_step computes ops/kernels.py::chomp_step_plain: smoothness (the
// velocity norms of d1 xi with its boundary rows, A xi + d1^T ed), the
// weighted and clipped total gradient, the cost and its diagnostics, the
// termination flags and the joint-limit check, and the projected CHOMP
// update with the gripper clamp (omg_planner_tpu/ops/chomp.py:89-113,
// :269-360, :394-402 as planner/plan.py:96-131 composes them).
//
// What bounds them: neither bytes (a row of chomp_obstacle needs 157 KB of
// points, gradients and potentials at T = 30, L = 10, P = 15; chomp_step
// 9.8 KB) nor the card's operations (~1 M flops a row).  A row of
// chomp_obstacle runs on one SM: its 4,500 points, each some thousand
// instructions (IEEE divisions and roots, the dof loop, the band's
// loads), go through that SM's four schedulers, so S = 1 and S = 8 take
// the same time (PERF.md, rows 9-10); chomp_step is a chain of block
// phases and the launch.  In eager PyTorch the same work is ~140 kernels a step
// and a full sort of the potentials.
//
// chomp_obstacle's layout: one block a row, one warp a timestep (t = warp,
// warp + warps, ...; at most 32 warps).  The softened potentials sit in
// shared memory (4 B a point); the k-th largest is found by a block-wide
// radix select over order-preserving 32-bit keys (-0.0 as +0.0, every NaN
// above +inf as torch.sort(descending=True) orders it): four passes of an
// 8-bit histogram over the keys that match the digits chosen so far, and
// warp 0 scans the 256 bins from the top for the bin that holds the k-th
// key.  The selection compares the float potential with the float of that
// key, so the mask is the plain version's.  Then each lane of a
// timestep's warp takes points q = lane, lane + 32, ... of the L P points:
// the velocity and acceleration from the band of the difference matrices
// (j in [t - h, t + h - 1], h the rule's half-length: every other entry of
// the matrices is zero), the direction, and its dof partial sums J^T w in
// registers; the selected cost goes to shared memory.  The warp then sums its 32 lanes'
// partials by a butterfly and lanes sum the links' costs over p in order:
// no atomics on floats, so a row's result is the same bit for bit from run
// to run and in any batch.
//
// chomp_step's layout: one block a row, one thread a (t, d) element (a
// thread takes several where (T + 1) D exceeds the block), the matrices
// read from device memory (L1), d1 and A only on their bands (P dense),
// the row's state in shared memory; warp 0 reduces the scalars and forms
// the flags.
//
// Arithmetic: fp32, no fast math.  The finger softening is rounded as the
// plain version rounds it (__fmul_rn, __fadd_rn), so the potentials and
// hence the k-th value and the mask are the plain version's bits; the rest
// contracts and orders its sums freely and is held to a tolerance against
// the plain version in float64.
//
#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#define OMG_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem()
#else
#include <cuda_runtime.h>
#define OMG_DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDof = 16;  // a lane's dof partial sums, in registers
constexpr int kBins = 256;

// chomp_obstacle's flags
constexpr int kSoften = 1;          // uncheck_finger_collision == -1
constexpr int kConsiderFinger = 2;  // the finger links stay selectable
constexpr int kQuirks = 4;          // ref_topk_quirks

struct ObsPtrs {
  const float* x;        // [S, T, L, P, 3]
  const float* origins;  // [S, T, J, 3]
  const float* axes;     // [S, T, J, 3]
  const float* x_start;  // [S, L, P, 3]
  const float* x_end;    // [S, L, P, 3]
  const float* pot;      // [S, T, L, P]
  const float* grad;     // [S, T, L, P, 3]
  const float* collide;  // [S, T, L, P]
  const float* dmats;    // [>= 2, T + 1, T] difference matrices
  const float* tables;   // [D] joint row of each dof, [D] prismatic,
                         // [L, D] affect, [L] finger links
  float* obs_cost;       // [S, T, L]
  float* obs_grad;       // [S, T, D]
  float* collide_sum;    // [S]
  float* kth;            // [S] the k-th largest potential (NaN: every
                         // point takes part), or null
  float* selection;      // [S, T, L, P] the selection mask, or null
};
constexpr int kObsPtrs = 15;

struct ObsDims {
  int S, T, L, P, J, D, k, half, flags;
};

// the boundary terms' coefficients, rule / dt^order rounded once (as the
// difference matrices' entries): of the start (row 0) and the end (row
// T - 1), for the velocity and the acceleration
struct ObsConsts {
  float v_start, v_end, a_start, a_end;
};

// the order-preserving key of f: larger float, larger key; -0.0 as +0.0;
// every NaN the largest key (torch.sort(descending=True) puts NaN first)
__device__ __forceinline__ unsigned order_key(float f) {
  if (f != f) return 0xffffffffu;
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  if (key == 0xffffffffu) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The k-th largest of v[0, n) (1 <= k <= n), as the value at index k - 1 of
// v sorted in descending order; every thread of the block calls it and
// gets it.  hist: 256 ints; state: 2 words (the key's digits so far, the
// rank left within them).
__device__ float kth_largest(const float* v, int n, int k, int* hist,
                             unsigned* state) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    state[0] = 0u;
    state[1] = static_cast<unsigned>(k);
  }
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = tid; b < kBins; b += nt) hist[b] = 0;
    __syncthreads();  // the bins cleared, the state published
    const unsigned prefix = state[0];
    const unsigned high = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    for (int i = tid; i < n; i += nt) {
      const unsigned key = order_key(v[i]);
      if ((key & high) == prefix) atomicAdd(hist + ((key >> shift) & 255u), 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l ... 248 - 8 l, from the top
      int c[8], local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        local += c[j];
      }
      int incl = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      const int excl = incl - local;
      const int kr = static_cast<int>(state[1]);
      const unsigned hit = __ballot_sync(kFull, excl < kr && kr <= incl);
      if (lane == __ffs(hit) - 1) {
        int r = kr - excl, bin = 255 - 8 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (r <= c[j]) {
            bin = 255 - 8 * lane - j;
            break;
          }
          r -= c[j];
        }
        state[0] = prefix | (static_cast<unsigned>(bin) << shift);
        state[1] = static_cast<unsigned>(r);
      }
    }
    __syncthreads();
  }
  return key_value(state[0]);
}

// one scene row of chomp_obstacle, as the block sees it
struct ObsRow {
  const float *x, *xs, *xe, *grad, *d1, *d2;
  const float *spot, *jt, *aff, *pri, *fin;
  int T, L, P, LP, D, half;
  bool soften;
  ObsConsts C;

  // the cost pot |v| of point q (= l P + p) at t, and its direction w
  __device__ __forceinline__ void terms(int t, int q, int l, float& cost,
                                        float w[3]) const {
    float v[3] = {0.f, 0.f, 0.f}, a[3] = {0.f, 0.f, 0.f};
    const int j0 = t - half > 0 ? t - half : 0;
    const int j1 = t + half - 1 < T - 1 ? t + half - 1 : T - 1;
    for (int j = j0; j <= j1; ++j) {
      const float c1 = d1[t * T + j], c2 = d2[t * T + j];
      const float* xj = x + (static_cast<size_t>(j) * LP + q) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = __fmaf_rn(c1, xj[c], v[c]);
        a[c] = __fmaf_rn(c2, xj[c], a[c]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = __fmaf_rn(C.v_start, xs[q * 3 + c], v[c]);
        a[c] = __fmaf_rn(C.a_start, xs[q * 3 + c], a[c]);
      }
    }
    if (t == T - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = __fmaf_rn(C.v_end, xe[q * 3 + c], v[c]);
        a[c] = __fmaf_rn(C.a_end, xe[q * 3 + c], a[c]);
      }
    }
    const size_t i = static_cast<size_t>(t) * LP + q;
    const float pot = spot[i];
    const float scale =
        soften ? __fadd_rn(1.f, -__fmul_rn(0.9f, fin[l])) : 1.f;
    float g[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = grad[i * 3 + c] * scale;
    const float vn = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    cost = pot * vn;
    const float inv = vn + 1e-8f;
    float h[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) h[c] = v[c] / inv;
    const float ha = h[0] * a[0] + h[1] * a[1] + h[2] * a[2];
    const float hg = h[0] * g[0] + h[1] * g[1] + h[2] * g[2];
    const float den = vn * vn + 1e-8f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[c] = vn * (g[c] - h[c] * hg) - pot * (a[c] - h[c] * ha) / den;
  }

  // acc[d] += affect[l, d] (J_d . w), J_d the point's Jacobian column of
  // dof d at t: axis x (x - origin), or the axis of a prismatic dof
  __device__ __forceinline__ void jtw(int t, int q, int l, const float w[3],
                                      float acc[kMaxDof]) const {
    const float* xp = x + (static_cast<size_t>(t) * LP + q) * 3;
    const float p0 = xp[0], p1 = xp[1], p2 = xp[2];
#pragma unroll
    for (int d = 0; d < kMaxDof; ++d) {
      if (d < D) {
        const float* o = jt + (t * D + d) * 6;
        const float* ax = o + 3;
        float dot;
        if (pri[d] != 0.f) {
          dot = ax[0] * w[0] + ax[1] * w[1] + ax[2] * w[2];
        } else {
          const float r0 = p0 - o[0], r1 = p1 - o[1], r2 = p2 - o[2];
          dot = (ax[1] * r2 - ax[2] * r1) * w[0] +
                (ax[2] * r0 - ax[0] * r2) * w[1] +
                (ax[0] * r1 - ax[1] * r0) * w[2];
        }
        acc[d] += aff[l * D + d] * dot;
      }
    }
  }
};

// at most 64 registers a thread, so that a block of 32 warps fits an SM
__global__ void __launch_bounds__(kMaxThreads)
    chomp_obstacle_kernel(ObsPtrs A, ObsDims Dm, ObsConsts C) {
  OMG_DYNAMIC_SMEM(smem);
  const int T = Dm.T, L = Dm.L, P = Dm.P, J = Dm.J, D = Dm.D;
  const int LP = L * P, n = T * LP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const bool soften = Dm.flags & kSoften;
  const bool topk = Dm.k > 0 && Dm.k < n;
  const bool drop_fingers = !(Dm.flags & kConsiderFinger) && Dm.k > 0;
  const bool quirks = (Dm.flags & kQuirks) && Dm.k > 0;

  float* spot = smem;              // [n] softened potentials
  float* scost = spot + n;         // [n] selected costs
  float* jt = scost + n;           // [T, D, 6] each dof's origin and axis
  float* aff = jt + 6 * T * D;     // [L, D]
  float* pri = aff + L * D;        // [D]
  float* fin = pri + D;            // [L]
  float* lsum = fin + L;           // [T, L] (quirks)
  float* red = lsum + T * L;       // [32] the warps' partial sums
  int* hist = reinterpret_cast<int*>(red + kMaxWarps);           // [256]
  unsigned* state = reinterpret_cast<unsigned*>(hist + kBins);   // [2]

  const float* tab = A.tables;
  const float* og = A.origins + row * T * J * 3;
  const float* ax = A.axes + row * T * J * 3;
  for (int i = tid; i < D; i += nt) pri[i] = tab[D + i];
  for (int i = tid; i < L * D; i += nt) aff[i] = tab[2 * D + i];
  for (int i = tid; i < L; i += nt) fin[i] = tab[2 * D + L * D + i];
  for (int i = tid; i < T * D; i += nt) {
    const int t = i / D, d = i - t * D;
    const int r = static_cast<int>(tab[d]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      jt[i * 6 + c] = og[(t * J + r) * 3 + c];
      jt[i * 6 + 3 + c] = ax[(t * J + r) * 3 + c];
    }
  }
  __syncthreads();

  // the softened potentials, and the softened collisions' sum
  const float* pot = A.pot + row * n;
  const float* col = A.collide + row * n;
  float csum = 0.f;
  for (int i = tid; i < n; i += nt) {
    float p = pot[i], c = col[i];
    if (soften) {
      const float f = fin[(i / P) % L];
      p = __fmul_rn(p, __fadd_rn(1.f, -__fmul_rn(0.9f, f)));
      c = __fmul_rn(c, __fadd_rn(1.f, -f));
    }
    spot[i] = p;
    csum += c;
  }
  csum = warp_sum(csum);
  if (lane == 0) red[warp] = csum;
  __syncthreads();
  if (tid == 0) {
    float s = red[0];
    for (int w = 1; w < nw; ++w) s += red[w];
    A.collide_sum[row] = s;
  }
  const float kth = topk ? kth_largest(spot, n, Dm.k, hist, state) : 0.f;
  if (A.kth != nullptr && tid == 0)
    A.kth[row] = topk ? kth : __uint_as_float(0x7fc00000u);

  ObsRow R;
  R.x = A.x + row * n * 3;
  R.xs = A.x_start + row * LP * 3;
  R.xe = A.x_end + row * LP * 3;
  R.grad = A.grad + row * n * 3;
  R.d1 = A.dmats;
  R.d2 = A.dmats + (T + 1) * T;
  R.spot = spot;
  R.jt = jt;
  R.aff = aff;
  R.pri = pri;
  R.fin = fin;
  R.T = T;
  R.L = L;
  R.P = P;
  R.LP = LP;
  R.D = D;
  R.half = Dm.half;
  R.soften = soften;
  R.C = C;
  // the selection of point i (link l): 1 or 0, as the plain version's mask
  auto sel = [&](int i, int l) -> float {
    float s = (!topk || spot[i] >= kth) ? 1.f : 0.f;
    if (drop_fingers) s *= 1.f - fin[l];
    return s;
  };

  for (int t = warp; t < T; t += nw) {
    float acc[kMaxDof];
#pragma unroll
    for (int d = 0; d < kMaxDof; ++d) acc[d] = 0.f;
    for (int q = lane; q < LP; q += 32) {
      const int l = q / P, i = t * LP + q;
      const float s = sel(i, l);
      if (A.selection != nullptr) A.selection[row * n + i] = s;
      float cost, w[3];
      R.terms(t, q, l, cost, w);
      scost[i] = cost * s;
      if (!quirks) {
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c] *= s;
        R.jtw(t, q, l, w, acc);
      }
    }
    __syncwarp();
    for (int l = lane; l < L; l += 32) {
      const int i0 = t * LP + l * P;
      float sum = 0.f;
      for (int p = 0; p < P; ++p) sum += scost[i0 + p];
      if (!quirks) {
        A.obs_cost[(row * T + t) * L + l] = sum;
        continue;
      }
      // the selected point of largest potential, the first of equal ones
      // (torch.argmax: NaN above all); none selected: no gradient point
      lsum[t * L + l] = sum;
      int best = 0;
      float top = -INFINITY;
      bool any = false;
      for (int p = 0; p < P; ++p) {
        const bool on = sel(i0 + p, l) > 0.f;
        const float score = on ? spot[i0 + p] : -INFINITY;
        any |= on;
        if (top == top && (score != score || score > top)) {
          top = score;
          best = p;
        }
      }
      if (any) {
        float cost, w[3];
        R.terms(t, l * P + best, l, cost, w);
        R.jtw(t, l * P + best, l, w, acc);
      }
    }
#pragma unroll
    for (int d = 0; d < kMaxDof; ++d) {
      if (d < D) {
        const float s = warp_sum(acc[d]);
        if (lane == 0) A.obs_grad[(row * T + t) * D + d] = s;
      }
    }
  }
  if (quirks) {
    __syncthreads();
    for (int l = tid; l < L; l += nt) {
      float s = lsum[l];
      for (int t = 1; t < T; ++t) s += lsum[t * L + l];
      for (int t = 0; t < T; ++t) A.obs_cost[(row * T + t) * L + l] = s;
    }
  }
}

// -- chomp_step ---------------------------------------------------------------

constexpr int kGoalSetProj = 1;
constexpr int kPreTerminate = 2;
constexpr int kStepConsiderFinger = 4;
// the packed floats of a row: CostInfo's 10 scalars, then cost_traj [T]
constexpr int kInfoScalars = 10;
constexpr int kFlags = 4;  // terminate, failure, execute, violate_limit

struct StepPtrs {
  const float* xi;        // [S, T, D]
  const float* start;     // [S, D]
  const float* goal;      // [S, D]
  const float* tail;      // [S, K, D]
  const float* obs_cost;  // [S, T, L]
  const float* obs_grad;  // [S, T, D]
  const float* collide;   // [S]
  const float* ow;        // [S] obstacle weight, or null: StepConsts::w
  const float* sw;        // [S] smoothness weight (null with ow)
  const float* eta;       // [S] step size (null with ow)
  const float* lower;     // [S, D]
  const float* upper;     // [S, D]
  const float* d1;        // [T + 1, T]
  const float* A;         // [T, T]
  const float* pmat;      // [T, T]: P_k, or Ainv
  const float* mmat;      // [T, K] M_k (K = 0: none)
  const float* masks;     // [2, D]: arm dofs, clamped gripper dofs
  float* xi_out;          // [S, T, D]
  float* info;            // [S, 10 + T]
  unsigned char* flags;   // [S, 4] bool
};
constexpr int kStepPtrs = 20;

// half: the difference rule's half-length h; row i of d1 is zero outside
// columns [i - h, i + h - 1], so row t of A = d1^T d1 outside [t - 2h + 1,
// t + 2h - 1]
struct StepDims {
  int S, T, D, L, K, half, flags;
};

// v_first and v_last: the boundary rows' coefficients, rule / dt rounded
// once (as d1's entries)
struct StepConsts {
  float v_first, v_last, clip, allow, allow10, tsl, tsl25;
  float w[3];  // the weights when StepPtrs::ow is null
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);  // NaN stays NaN
}

__global__ void chomp_step_kernel(StepPtrs A, StepDims Dm, StepConsts C) {
  OMG_DYNAMIC_SMEM(smem);
  const int T = Dm.T, D = Dm.D, L = Dm.L, K = Dm.K, n = T * D;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t row = blockIdx.x;
  const bool proj = Dm.flags & kGoalSetProj;

  float* sx = smem;               // [T, D]
  float* grad = sx + n;           // [T, D] the total gradient
  float* sg = grad + n;           // [T, D] the weighted smoothness gradient
  float* og = sg + n;             // [T, D] the clipped obstacle gradient
  float* vel = og + n;            // [T + 1, D] velocity + boundary rows
  float* loss = vel + n + D;      // [T + 1]
  float* orow = loss + T + 1;     // [T] the obstacle cost of each t
  float* ed = orow + T;           // [2, D] boundary rows 0 and T

  const float* xi = A.xi + row * n;
  const float* goal = A.goal + row * D;
  float ow, sw, eta;
  if (A.ow != nullptr) {
    ow = A.ow[row];
    sw = A.sw[row];
    eta = A.eta[row];
  } else {
    ow = C.w[0];
    sw = C.w[1];
    eta = C.w[2];
  }
  for (int e = tid; e < n; e += nt) sx[e] = xi[e];
  for (int d = tid; d < D; d += nt) {
    ed[d] = C.v_first * A.start[row * D + d];
    ed[D + d] = proj ? 0.f : C.v_last * goal[d];
  }
  for (int t = tid; t < T; t += nt) {
    const float* oc = A.obs_cost + (row * T + t) * L;
    float s = oc[0];
    for (int l = 1; l < L; ++l) s += oc[l];
    orow[t] = s;
  }
  __syncthreads();

  // the velocity rows (d1 xi + ed), the smoothness gradient A xi + d1^T ed,
  // the weighted terms and the total gradient, each over its matrix's band
  const int h = Dm.half, ha = 2 * h - 1;
  for (int e = tid; e < n + D; e += nt) {
    const int i = e / D, d = e - i * D;
    const int j1 = i + h - 1 < T - 1 ? i + h - 1 : T - 1;
    float s = 0.f;
    for (int j = i - h > 0 ? i - h : 0; j <= j1; ++j)
      s += A.d1[i * T + j] * sx[j * D + d];
    if (i == 0) s += ed[d];
    if (i == T) s += ed[D + d];
    vel[e] = s;
  }
  for (int e = tid; e < n; e += nt) {
    const int t = e / D, d = e - t * D;
    const int j1 = t + ha < T - 1 ? t + ha : T - 1;
    float s = 0.f;
    for (int j = t - ha > 0 ? t - ha : 0; j <= j1; ++j)
      s += A.A[t * T + j] * sx[j * D + d];
    s += A.d1[t] * ed[d] + A.d1[T * T + t] * ed[D + d];
    const float wsg = sw * s;
    const float wog = clampf(ow * A.obs_grad[row * n + e], -C.clip, C.clip);
    sg[e] = wsg;
    og[e] = wog;
    grad[e] = wog + wsg;
  }
  __syncthreads();

  for (int i = tid; i <= T; i += nt) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += vel[i * D + d] * vel[i * D + d];
    const float vn = sqrtf(s);
    loss[i] = 0.5f * (vn * vn);
  }
  // the update: -eta P grad - M (xi[T - K:] - tail), arm dofs only unless
  // consider_finger, the gripper dofs clamped to [0, 0.04]
  const float* arm = A.masks;
  const float* clamp = A.masks + D;
  const float* tail = A.tail + row * K * D;
  for (int e = tid; e < n; e += nt) {
    const int t = e / D, d = e - t * D;
    float pg = 0.f;
#pragma unroll 6
    for (int j = 0; j < T; ++j) pg += A.pmat[t * T + j] * grad[j * D + d];
    float u = -eta * pg;
    if (proj && K > 0) {
      float mb = 0.f;
      for (int m = 0; m < K; ++m)
        mb += A.mmat[t * K + m] * (sx[(T - K + m) * D + d] - tail[m * D + d]);
      u -= mb;
    }
    float v = (Dm.flags & kStepConsiderFinger) ? sx[e] + u : sx[e] + u * arm[d];
    if (clamp[d] != 0.f) v = clampf(v, 0.f, 0.04f);
    A.xi_out[row * n + e] = v;
  }
  __syncthreads();

  if (tid >= 32) return;
  // warp 0: the scalars, the flags and the cost of each t
  float s_sum = 0.f, o_sum = 0.f, gn = 0.f, sgn = 0.f, ogn = 0.f, reach = 0.f;
  int low = 0, high = 0;
  for (int i = lane; i <= T; i += 32) s_sum += loss[i];
  for (int i = lane; i < T; i += 32) o_sum += orow[i];
  for (int e = lane; e < n; e += 32) {
    gn += grad[e] * grad[e];
    sgn += sg[e] * sg[e];
    ogn += og[e] * og[e];
    const int d = e % D;
    low |= sx[e] < A.lower[row * D + d] - 5e-3f;
    high |= sx[e] > A.upper[row * D + d] + 5e-3f;
  }
  if (proj) {
    for (int d = lane; d < D; d += 32) {
      const float r = sx[(T - 1) * D + d] - goal[d];
      reach += r * r;
    }
  }
  s_sum = warp_sum(s_sum);
  o_sum = warp_sum(o_sum);
  gn = warp_sum(gn);
  sgn = warp_sum(sgn);
  ogn = warp_sum(ogn);
  reach = warp_sum(reach);
  const bool over = __any_sync(kFull, low) && __any_sync(kFull, high);
  float* info = A.info + row * (kInfoScalars + T);
  for (int t = lane; t < T; t += 32) info[kInfoScalars + t] =
      ow * orow[t] + sw * loss[t];
  if (lane == 0) {
    const float collide = A.collide[row];
    const float goal_dist = sqrtf(reach);
    const float w_obs = ow * o_sum, w_smooth = sw * s_sum;
    info[0] = w_obs + w_smooth;
    info[1] = o_sum;
    info[2] = s_sum;
    info[3] = w_obs;
    info[4] = w_smooth;
    info[5] = sqrtf(gn);
    info[6] = sqrtf(sgn);
    info[7] = sqrtf(ogn);
    info[8] = collide;
    info[9] = goal_dist;
    const bool terminate = (Dm.flags & kPreTerminate) && collide <= C.allow &&
                           goal_dist < 0.01f && s_sum < C.tsl;
    unsigned char* f = A.flags + row * kFlags;
    f[0] = terminate && !over;
    f[1] = collide >= C.allow10 || s_sum >= C.tsl25;
    f[2] = collide <= C.allow && s_sum < C.tsl;
    f[3] = over;
  }
}

}  // namespace

// Threads a block of chomp_obstacle takes: one warp a timestep, at most 32.
static int chomp_obstacle_threads(int T) {
  return 32 * (T < kMaxWarps ? T : kMaxWarps);
}

// Shared memory a block of chomp_obstacle needs, in bytes.
static size_t chomp_obstacle_smem(int T, int L, int P, int D) {
  const size_t n = static_cast<size_t>(T) * L * P;
  return sizeof(float) * (2 * n + 6 * static_cast<size_t>(T) * D +
                          static_cast<size_t>(L) * D + D + L +
                          static_cast<size_t>(T) * L + kMaxWarps + kBins + 2);
}

// ptrs: the 15 pointers of ObsPtrs in order; dims: S, T, L, P, J, D, k,
// half, flags; consts: the 4 floats of ObsConsts.  Returns the CUDA error
// of the launch (0 on success).
extern "C" int omg_chomp_obstacle(void* const* ptrs, const int* dims,
                                  const float* consts, void* stream) {
  ObsPtrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kObsPtrs; ++i) dst[i] = ptrs[i];
  const ObsDims D{dims[0], dims[1], dims[2], dims[3], dims[4],
                  dims[5], dims[6], dims[7], dims[8]};
  const ObsConsts C{consts[0], consts[1], consts[2], consts[3]};
  if (D.S <= 0 || D.T <= 0) return 0;
  if (D.D > kMaxDof) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = chomp_obstacle_smem(D.T, D.L, D.P, D.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chomp_obstacle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = chomp_obstacle_threads(D.T);
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(chomp_obstacle_kernel, D.S, threads, smem, A, D, C);
#else
  chomp_obstacle_kernel<<<D.S, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(A, D, C);
#endif
  return static_cast<int>(cudaGetLastError());
}

// Threads a block of chomp_step takes: one a velocity element ((T + 1) D),
// in whole warps, at most 1,024.
static int chomp_step_threads(int T, int D) {
  const int n = (T + 1) * D, t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Shared memory a block of chomp_step needs, in bytes.
static size_t chomp_step_smem(int T, int D) {
  const size_t n = static_cast<size_t>(T) * D;
  return sizeof(float) * (5 * n + 3 * D + 2 * T + 1);
}

// ptrs: the 20 pointers of StepPtrs in order; dims: S, T, D, L, K, half,
// flags;
// consts: the 10 floats of StepConsts.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int omg_chomp_step(void* const* ptrs, const int* dims,
                              const float* consts, void* stream) {
  StepPtrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kStepPtrs; ++i) dst[i] = ptrs[i];
  const StepDims D{dims[0], dims[1], dims[2], dims[3],
                   dims[4], dims[5], dims[6]};
  StepConsts C;
  float* c = reinterpret_cast<float*>(&C);
  for (int i = 0; i < 10; ++i) c[i] = consts[i];
  if (D.S <= 0 || D.T * D.D <= 0) return 0;
  const size_t smem = chomp_step_smem(D.T, D.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chomp_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = chomp_step_threads(D.T, D.D);
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(chomp_step_kernel, D.S, threads, smem, A, D, C);
#else
  chomp_step_kernel<<<D.S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, D, C);
#endif
  return static_cast<int>(cudaGetLastError());
}

