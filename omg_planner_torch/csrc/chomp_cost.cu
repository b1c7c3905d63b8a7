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
// chomp_obstacle runs on one SM, and its time is the instructions that SM
// issues: a point's terms are some thousand (IEEE divisions and roots, the
// dof loop, the band), and of the 4,500 points of a suite row only those
// of the top k = 1,000 count (463-595 on suite scene 1's plan calls, the
// finger links dropped); the rest are multiplied by zero.  So the kernel works on the selected points alone
// (and of those, on the points whose potential or gradient is not zero).
// chomp_step is a chain of block phases behind the loads of its row.  In
// eager PyTorch the same work is ~140 kernels a step and a full sort of
// the potentials.
//
// chomp_obstacle's layout: one block a row, 1,024 threads (fewer for a row
// of fewer points).  The block first starts copying the row's positions
// and gradients into shared memory (cp.async, where they fit beside the
// rest: 106 KB more at T = 30, L = 10, P = 15), to land while the select
// runs.  The softened potentials sit in shared memory (4 B a point).  The
// k-th largest is found by a block-wide radix select over
// order-preserving 32-bit keys (-0.0 as +0.0, every NaN above +inf as
// torch.sort(descending=True) orders it): four passes of an 8-bit
// histogram over the keys that match the digits chosen so far (the +0.0
// key, most of a row, counted in registers and added once a warp), and
// warp 0 scans the 256 bins from the top for the bin that holds the k-th
// key.  The selection compares the float potential with the float of that
// key, so the mask is the plain version's.  Then each thread takes a run
// of consecutive points: it checks that their inputs are finite and lists
// those selected, less those whose potential and gradient are both zero
// (a cost of exactly 0 and a direction of +-0: nothing to add), in (t, l,
// p) order by one block scan, with each timestep's first entry.  One
// thread a listed point forms its velocity and acceleration (the
// difference matrices' non-zero band entries, staged in shared memory),
// its cost and direction, and its D contributions affect[l, d] (J_d . w)
// to shared memory; one thread a (t, d) then sums its timestep's
// contributions in list order.  A list longer than the block goes in
// rounds of one block.  Lanes sum the links' costs over p in order from a
// zero-filled array.  A row with a non-finite input lists every point
// and takes the whole rows of the matrices, so a NaN or inf spreads as
// the plain version's masked products spread it.  No atomics on floats:
// a row's result is the same bit for bit from run to run and in any
// batch.
//
// chomp_step's layout: one block a row, one thread a (t, d) element (a
// thread takes several where (T + 1) D exceeds the block).  The block
// first copies its whole row into shared memory as one wave of
// asynchronous loads (cp.async): the trajectory, start, goal and tail, the
// obstacle terms, the limits, the bands of d1 and A, P, M and the masks.
// Every product then reads shared memory, each element's sum in the same
// order as before; each warp reduces its share of the six scalars and the
// limit check, and thread 0 combines the warps' partials in order.
//
// Arithmetic: fp32, no fast math.  The finger softening is rounded as the
// plain version rounds it (__fmul_rn, __fadd_rn), so the potentials and
// hence the k-th value and the mask are the plain version's bits; the rest
// contracts and orders its sums freely and is held to a tolerance against
// the plain version in float64.
//
// The phase probe (scripts/chomp_phase_clock.py) builds this source with
// -DOMG_CHOMP_CLOCK and its own OMG_STAMP, which writes clock64() at each
// OMG_STAMP(kernel, slot); every other build leaves the stamps empty.
//
#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#define OMG_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem()
#else
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#define OMG_DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif
#include <math.h>
#include <stdint.h>

#ifndef OMG_CHOMP_CLOCK
#define OMG_STAMP(kernel, slot) \
  do {                          \
  } while (0)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDof = 16;   // the dofs a point's contributions cover
constexpr int kMaxBand = 8;   // band entries of a difference matrix's row
constexpr int kBins = 256;
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory
constexpr unsigned kZeroKey = 0x80000000u;  // order_key of +0.0 and -0.0

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
// rank left within them).  The +0.0 key, which a suite row holds at most
// of its points, is counted in a register and goes to its bin by one
// reduction and one atomic a warp after the loop; every other key by its
// own atomic.
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
    const bool zeros = (kZeroKey & high) == prefix;  // uniform
    unsigned zc = 0u;  // this thread's +0.0 keys
    for (int i = tid; i < n; i += nt) {
      const unsigned key = order_key(v[i]);
      if (zeros && key == kZeroKey)
        ++zc;
      else if ((key & high) == prefix)
        atomicAdd(hist + ((key >> shift) & 255u), 1);
    }
    if (zeros) {
      zc = __reduce_add_sync(kFull, zc);
      if (lane == 0 && zc != 0u)
        atomicAdd(hist + ((kZeroKey >> shift) & 255u), static_cast<int>(zc));
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
    OMG_STAMP(0, 3 + pass);
  }
  return key_value(state[0]);
}

// one scene row of chomp_obstacle, as the block sees it
struct ObsRow {
  const float *x, *xs, *xe, *grad, *d1, *d2;
  const float *spot, *jt, *aff, *pri, *band;
  int T, LP, D, half;
  bool full;  // a non-finite input: the matrices' whole rows
  ObsConsts C;

  // the cost pot |v| of point q (= l P + p) at t, and its direction w;
  // scale: the finger softening of the point's gradient
  __device__ __forceinline__ void terms(int t, int q, float scale,
                                        float& cost, float w[3]) const {
    float v[3] = {0.f, 0.f, 0.f}, a[3] = {0.f, 0.f, 0.f};
    if (full) {
      // every column, as the plain version's product: 0 x NaN is NaN
      for (int j = 0; j < T; ++j) {
        const float c1 = d1[t * T + j], c2 = d2[t * T + j];
        const float* xj = x + (static_cast<size_t>(j) * LP + q) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] = __fmaf_rn(c1, xj[c], v[c]);
          a[c] = __fmaf_rn(c2, xj[c], a[c]);
        }
      }
    } else {
      // the band, columns t - h ... t + h - 1 (a column outside [0, T)
      // has coefficients 0 and reads column t: it adds +-0 to a sum that
      // started at +0, as every zero entry does)
      for (int e = 0; e < 2 * half; ++e) {
        const int j0 = t - half + e, j = j0 >= 0 && j0 < T ? j0 : t;
        const float c1 = band[(t * kMaxBand + e) * 2];
        const float c2 = band[(t * kMaxBand + e) * 2 + 1];
        const float* xj = x + (static_cast<size_t>(j) * LP + q) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] = __fmaf_rn(c1, xj[c], v[c]);
          a[c] = __fmaf_rn(c2, xj[c], a[c]);
        }
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

  // out[d] = affect[l, d] (J_d . w) for d < D (add: out[d] += it), J_d the
  // point's Jacobian column of dof d at t: axis x (x - origin), or the
  // axis of a prismatic dof
  __device__ __forceinline__ void jtw(int t, int q, int l, const float w[3],
                                      float* out, bool add) const {
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
        const float c = aff[l * D + d] * dot;
        out[d] = add ? out[d] + c : c;
      }
    }
  }
};

// at most 64 registers a thread, so that a block of 32 warps fits an SM.
// stage: x and grad are copied into shared memory (they fit beside the
// rest: 6 T L P words more)
__global__ void __launch_bounds__(kMaxThreads)
    chomp_obstacle_kernel(ObsPtrs A, ObsDims Dm, ObsConsts C, bool stage) {
  OMG_DYNAMIC_SMEM(smem);
  OMG_STAMP(0, 0);
  const int T = Dm.T, L = Dm.L, P = Dm.P, J = Dm.J, D = Dm.D;
  const int LP = L * P, n = T * LP, half = Dm.half;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const bool soften = Dm.flags & kSoften;
  const bool topk = Dm.k > 0 && Dm.k < n;
  const bool drop_fingers = !(Dm.flags & kConsiderFinger) && Dm.k > 0;
  const bool quirks = (Dm.flags & kQuirks) && Dm.k > 0;
  const int nc = nt > T * L ? nt : T * L;  // rows of the contributions

  float* xg = smem;                 // [2, T, L, P, 3] x and grad (stage)
  float* spot = smem + (stage ? 6 * n : 0);  // [n] softened potentials
  float* scost = spot + n;          // [n] listed costs (zero elsewhere)
  int* list = reinterpret_cast<int*>(scost + n);  // [n] listed points
  float* cbuf = reinterpret_cast<float*>(list + n);  // [nc, D]
  float* gacc = cbuf + nc * D;      // [T, D] the gradient's sums
  float* jt = gacc + T * D;         // [T, D, 6] each dof's origin and axis
  float* aff = jt + 6 * T * D;      // [L, D]
  float* pri = aff + L * D;         // [D]
  float* fin = pri + D;             // [L]
  float* lsum = fin + L;            // [T, L] (quirks)
  float* red = lsum + T * L;        // [32] the warps' partial sums
  float* band = red + kMaxWarps;    // [T, kMaxBand, 2] d1's and d2's
  int* seg = reinterpret_cast<int*>(band + 2 * T * kMaxBand);  // [T + 1]
                                    // each t's first list entry
  int* wcnt = seg + T + 1;          // [32] the warps' listed points
  int* hist = wcnt + kMaxWarps;     // [256]
  unsigned* state = reinterpret_cast<unsigned*>(hist + kBins);  // [2]
  int* bad = reinterpret_cast<int*>(state + 2);  // a non-finite input

  const float* xr = A.x + row * n * 3;
  const float* gr = A.grad + row * n * 3;
  const float* tab = A.tables;
  const float* og = A.origins + row * T * J * 3;
  const float* ax = A.axes + row * T * J * 3;
  const float* d1 = A.dmats;
  const float* d2 = A.dmats + (T + 1) * T;
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
    gacc[i] = 0.f;
  }
  // row t of d1 and d2 is zero outside columns [t - h, t + h - 1]: that
  // window, 0 where it leaves [0, T)
  for (int i = tid; i < T * 2 * half; i += nt) {
    const int t = i / (2 * half), e = i - t * 2 * half, j = t - half + e;
    const bool in = j >= 0 && j < T;
    band[(t * kMaxBand + e) * 2] = in ? d1[t * T + j] : 0.f;
    band[(t * kMaxBand + e) * 2 + 1] = in ? d2[t * T + j] : 0.f;
  }
  if (tid == 0) *bad = 0;
  __syncthreads();
  OMG_STAMP(0, 1);

  // the softened potentials and collisions' sum; probe: x 0 is NaN for
  // inf and NaN, +-0 otherwise, so it turns NaN on a non-finite input
  const float* pot = A.pot + row * n;
  const float* col = A.collide + row * n;
  const float* xs = A.x_start + row * LP * 3;
  const float* xe = A.x_end + row * LP * 3;
  float csum = 0.f, probe = 0.f;
  for (int i = tid; i < n; i += nt) {
    float p = pot[i], c = col[i];
    if (soften) {
      const float f = fin[(i / P) % L];
      p = __fmul_rn(p, __fadd_rn(1.f, -__fmul_rn(0.9f, f)));
      c = __fmul_rn(c, __fadd_rn(1.f, -f));
    }
    spot[i] = p;
    scost[i] = 0.f;
    csum += c;
    probe = __fmaf_rn(p, 0.f, probe);
  }
  for (int i = tid; i < 3 * LP; i += nt)
    probe = __fmaf_rn(xs[i], 0.f, __fmaf_rn(xe[i], 0.f, probe));
  for (int i = tid; i < 6 * T * D; i += nt)
    probe = __fmaf_rn(jt[i], 0.f, probe);
  csum = warp_sum(csum);
  if (lane == 0) red[warp] = csum;
  __syncthreads();
  if (tid == 0) {
    float s = red[0];
    for (int w = 1; w < nw; ++w) s += red[w];
    A.collide_sum[row] = s;
  }
  OMG_STAMP(0, 2);
  // x and grad of the row into shared memory while the select runs (16
  // bytes a copy where the addresses allow it; issued after the loads
  // above, which it would otherwise hold up)
  if (stage) {
    const int n3 = 3 * n;
    if (((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(gr)) &
         15u) == 0 && n3 % 4 == 0) {
      for (int i = tid; i < n3 / 4; i += nt) {
        __pipeline_memcpy_async(xg + 4 * i, xr + 4 * i, 16);
        __pipeline_memcpy_async(xg + n3 + 4 * i, gr + 4 * i, 16);
      }
    } else {
      for (int i = tid; i < n3; i += nt) {
        __pipeline_memcpy_async(xg + i, xr + i, sizeof(float));
        __pipeline_memcpy_async(xg + n3 + i, gr + i, sizeof(float));
      }
    }
    __pipeline_commit();
  }

  const float kth = topk ? kth_largest(spot, n, Dm.k, hist, state) : 0.f;
  if (A.kth != nullptr && tid == 0)
    A.kth[row] = topk ? kth : __uint_as_float(0x7fc00000u);
  if (stage) {
    __pipeline_wait_prior(0);
    __syncthreads();  // every thread's copies landed
  }
  OMG_STAMP(0, 7);
  const float* X = stage ? xg : xr;
  const float* G = stage ? xg + 3 * n : gr;

  // the selection of point i (link l): 1 or 0, as the plain version's mask
  auto sel = [&](int i, int l) -> float {
    float s = (!topk || spot[i] >= kth) ? 1.f : 0.f;
    if (drop_fingers) s *= 1.f - fin[l];
    return s;
  };
  // the list: the selected points in index order, less those of zero
  // potential and gradient (a cost of exactly 0, a direction of +-0); in
  // a row with a non-finite input every point.  Thread tid takes the run
  // [i0, i1) (at most 32 points: bit i - i0 of `on`), reads its points'
  // positions and gradients for the probe, and places the listed ones
  // after one block scan.
  const int per = (n + nt - 1) / nt;
  const int i0 = tid * per < n ? tid * per : n;
  const int i1 = i0 + per < n ? i0 + per : n;
  unsigned on = 0u;
  {
    int l = (i0 % LP) / P, p = i0 % P;
    for (int i = i0; i < i1; ++i) {
      const float s = sel(i, l);
      if (A.selection != nullptr) A.selection[row * n + i] = s;
      const float g0 = G[i * 3], g1 = G[i * 3 + 1], g2 = G[i * 3 + 2];
      probe = __fmaf_rn(g0, 0.f, __fmaf_rn(g1, 0.f, __fmaf_rn(g2, 0.f, probe)));
      probe = __fmaf_rn(X[i * 3], 0.f, __fmaf_rn(X[i * 3 + 1], 0.f,
                                                 __fmaf_rn(X[i * 3 + 2], 0.f,
                                                           probe)));
      const bool nil = spot[i] == 0.f && g0 == 0.f && g1 == 0.f && g2 == 0.f;
      if (s != 0.f && !nil) on |= 1u << (i - i0);
      if (++p == P) {
        p = 0;
        if (++l == L) l = 0;
      }
    }
  }
  if (probe != probe) *bad = 1;
  const int cnt = __popc(on);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) wcnt[warp] = incl;
  __syncthreads();
  const bool full = *bad != 0;
  // the warps before this one: lane w holds warp w's count, scanned
  int before = lane < nw ? wcnt[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, before, o);
    if (lane >= o) before += up;
  }
  before = __shfl_sync(kFull, before, warp) - wcnt[warp];
  int pos = i0;  // a full row lists every point
  if (full)
    on = i1 > i0 ? 0xffffffffu >> (32 - (i1 - i0)) : 0u;
  else
    pos = before + incl - cnt;
  // the timesteps whose first point lies in the run: their first entry
  for (int t = (i0 + LP - 1) / LP; t * LP < i1; ++t)
    seg[t] = pos + __popc(on & ((1u << (t * LP - i0)) - 1u));
  for (unsigned m = on; m != 0u; m &= m - 1u) list[pos++] = i0 + __ffs(m) - 1;
  if (tid == nt - 1) seg[T] = pos;  // the last run ends the list
  __syncthreads();
  const int total = seg[T];
  OMG_STAMP(0, 8);

  ObsRow R;
  R.x = X;
  R.xs = xs;
  R.xe = xe;
  R.grad = G;
  R.d1 = d1;
  R.d2 = d2;
  R.spot = spot;
  R.jt = jt;
  R.aff = aff;
  R.pri = pri;
  R.band = band;
  R.T = T;
  R.half = half;
  R.LP = LP;
  R.D = D;
  R.full = full;
  R.C = C;
  auto scale = [&](int l) -> float {
    return soften ? __fadd_rn(1.f, -__fmul_rn(0.9f, fin[l])) : 1.f;
  };

  // the listed points in rounds of one block: a thread a point, then a
  // thread a (t, d) sums the round's contributions of t in list order
  for (int r0 = 0; r0 < total; r0 += nt) {
    if (r0 + tid < total) {
      const int i = list[r0 + tid], t = i / LP, q = i - t * LP, l = q / P;
      const float s = sel(i, l);
      float cost, w[3];
      R.terms(t, q, scale(l), cost, w);
      scost[i] = cost * s;
      if (!quirks) {
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c] *= s;
        R.jtw(t, q, l, w, cbuf + tid * D, false);
      }
    }
    __syncthreads();
    if (r0 == 0) OMG_STAMP(0, 9);
    if (!quirks) {
      const int r1 = r0 + nt < total ? r0 + nt : total;
      for (int e = tid; e < T * D; e += nt) {
        const int t = e / D, d = e - t * D;
        const int lo = seg[t] > r0 ? seg[t] : r0;
        const int hi = seg[t + 1] < r1 ? seg[t + 1] : r1;
        float g = gacc[e];
        for (int j = lo; j < hi; ++j) g += cbuf[(j - r0) * D + d];
        gacc[e] = g;
      }
      __syncthreads();  // the contributions read before the next round
    }
    if (r0 == 0) OMG_STAMP(0, 10);
  }
  OMG_STAMP(0, 11);

  // each (t, link)'s cost over p in order; under the quirks also its
  // gradient point: the selected point of largest potential, the first of
  // equal ones (torch.argmax: NaN above all); none selected: none.  A
  // non-finite row takes every point's direction, the others' times 0.
  for (int e = tid; e < T * L; e += nt) {
    const int t = e / L, l = e - t * L, i0 = t * LP + l * P;
    float sum = 0.f;
    for (int p = 0; p < P; ++p) sum += scost[i0 + p];
    if (!quirks) {
      A.obs_cost[(row * T + t) * L + l] = sum;
      continue;
    }
    lsum[e] = sum;
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
    float* out = cbuf + e * D;
    for (int d = 0; d < D; ++d) out[d] = 0.f;
    for (int p = full ? 0 : best; p < (full ? P : best + 1); ++p) {
      const float m = any && p == best ? 1.f : 0.f;
      if (m == 0.f && !full) continue;
      float cost, w[3];
      R.terms(t, l * P + p, scale(l), cost, w);
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c] *= m;
      R.jtw(t, l * P + p, l, w, out, true);
    }
  }
  if (quirks) {
    __syncthreads();
    // each (t, d): its links' contributions in link order; each link: its
    // cost summed over t, broadcast
    for (int e = tid; e < T * D; e += nt) {
      const int t = e / D, d = e - t * D;
      float g = 0.f;
      for (int l = 0; l < L; ++l) g += cbuf[(t * L + l) * D + d];
      gacc[e] = g;
    }
    for (int l = tid; l < L; l += nt) {
      float s = lsum[l];
      for (int t = 1; t < T; ++t) s += lsum[t * L + l];
      for (int t = 0; t < T; ++t) A.obs_cost[(row * T + t) * L + l] = s;
    }
  }
  OMG_STAMP(0, 12);
  // each thread writes the (t, d) sums it formed
  for (int e = tid; e < T * D; e += nt) A.obs_grad[row * T * D + e] = gacc[e];
#ifdef OMG_CHOMP_CLOCK
  __syncthreads();
  OMG_STAMP(0, 13);
#endif
}

// -- chomp_step ---------------------------------------------------------------

constexpr int kGoalSetProj = 1;
constexpr int kPreTerminate = 2;
constexpr int kStepConsiderFinger = 4;
// the packed floats of a row: CostInfo's 10 scalars, then cost_traj [T]
constexpr int kInfoScalars = 10;
constexpr int kFlags = 4;  // terminate, failure, execute, violate_limit
constexpr int kSums = 6;   // the scalars the warps reduce

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

// count floats from src to dst by the threads of the block, 4 bytes a
// copy (cp.async: issued now, waited for once)
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
}

__global__ void chomp_step_kernel(StepPtrs A, StepDims Dm, StepConsts C) {
  OMG_DYNAMIC_SMEM(smem);
  OMG_STAMP(1, 0);
  const int T = Dm.T, D = Dm.D, L = Dm.L, K = Dm.K, n = T * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const bool proj = Dm.flags & kGoalSetProj;
  const int h = Dm.half, ha = 2 * h - 1, wb = 2 * h, wa = 2 * ha + 1;

  // the row's inputs, as staged
  float* sx = smem;               // [T, D]
  float* ograd = sx + n;          // [T, D] the obstacle gradient
  float* ocost = ograd + n;       // [T, L]
  float* start = ocost + T * L;   // [D]
  float* goal = start + D;        // [D]
  float* lower = goal + D;        // [D]
  float* upper = lower + D;       // [D]
  float* masks = upper + D;       // [2, D]
  float* tail = masks + 2 * D;    // [K, D]
  float* pm = tail + K * D;       // [T, T]
  float* mm = pm + T * T;         // [T, K]
  float* d1b = mm + T * K;        // [T + 1, 2h] d1's band, row i from
                                  // column i - h
  float* d1e = d1b + (T + 1) * wb;  // [2, T] d1's rows 0 and T
  float* ab = d1e + 2 * T;        // [T, 4h - 1] A's band, from t - 2h + 1
  // what the block forms
  float* grad = ab + T * wa;      // [T, D] the total gradient
  float* sg = grad + n;           // [T, D] the weighted smoothness gradient
  float* og = sg + n;             // [T, D] the clipped obstacle gradient
  float* vel = og + n;            // [T + 1, D] velocity + boundary rows
  float* loss = vel + n + D;      // [T + 1]
  float* orow = loss + T + 1;     // [T] the obstacle cost of each t
  float* red = orow + T;          // [32, 6] the warps' partial sums
  int* over = reinterpret_cast<int*>(red + kMaxWarps * kSums);  // [32, 2]

  stage(sx, A.xi + row * n, n);
  stage(ograd, A.obs_grad + row * n, n);
  stage(ocost, A.obs_cost + row * T * L, T * L);
  stage(start, A.start + row * D, D);
  stage(goal, A.goal + row * D, D);
  stage(lower, A.lower + row * D, D);
  stage(upper, A.upper + row * D, D);
  stage(masks, A.masks, 2 * D);
  stage(tail, A.tail + row * K * D, K * D);
  stage(pm, A.pmat, T * T);
  if (K > 0) stage(mm, A.mmat, T * K);
  stage(d1e, A.d1, T);
  stage(d1e + T, A.d1 + T * T, T);
  for (int e = tid; e < (T + 1) * wb; e += nt) {
    const int i = e / wb, j = i - h + (e - i * wb);
    if (j >= 0 && j < T)
      __pipeline_memcpy_async(d1b + e, A.d1 + i * T + j, sizeof(float));
    else
      d1b[e] = 0.f;
  }
  for (int e = tid; e < T * wa; e += nt) {
    const int t = e / wa, j = t - ha + (e - t * wa);
    if (j >= 0 && j < T)
      __pipeline_memcpy_async(ab + e, A.A + t * T + j, sizeof(float));
    else
      ab[e] = 0.f;
  }
  __pipeline_commit();
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
  const float collide = A.collide[row];
  __pipeline_wait_prior(0);
  __syncthreads();
  OMG_STAMP(1, 1);

  // the boundary rows ed: row 0 v_first start, row T v_last goal (zero
  // under the goal-set projection), each product rounded on its own
  auto ed0 = [&](int d) { return __fmul_rn(C.v_first, start[d]); };
  auto edT = [&](int d) {
    return proj ? 0.f : __fmul_rn(C.v_last, goal[d]);
  };
  // the velocity rows (d1 xi + ed), the smoothness gradient A xi + d1^T ed,
  // the weighted terms and the total gradient, each over its matrix's band
  for (int e = tid; e < n + D; e += nt) {
    const int i = e / D, d = e - i * D;
    const int j1 = i + h - 1 < T - 1 ? i + h - 1 : T - 1;
    float s = 0.f;
    for (int j = i - h > 0 ? i - h : 0; j <= j1; ++j)
      s += d1b[i * wb + j - (i - h)] * sx[j * D + d];
    if (i == 0) s += ed0(d);
    if (i == T) s += edT(d);
    vel[e] = s;
  }
  for (int e = tid; e < n; e += nt) {
    const int t = e / D, d = e - t * D;
    const int j1 = t + ha < T - 1 ? t + ha : T - 1;
    float s = 0.f;
    for (int j = t - ha > 0 ? t - ha : 0; j <= j1; ++j)
      s += ab[t * wa + j - (t - ha)] * sx[j * D + d];
    s += d1e[t] * ed0(d) + d1e[T + t] * edT(d);
    const float wsg = sw * s;
    const float wog = clampf(ow * ograd[e], -C.clip, C.clip);
    sg[e] = wsg;
    og[e] = wog;
    grad[e] = wog + wsg;
  }
  for (int t = tid; t < T; t += nt) {
    const float* oc = ocost + t * L;
    float s = oc[0];
    for (int l = 1; l < L; ++l) s += oc[l];
    orow[t] = s;
  }
  __syncthreads();
  OMG_STAMP(1, 2);

  // each thread's share of the six sums: the smoothness and obstacle
  // costs, the three gradients' squared norms, the goal distance's square
  float part[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int low = 0, high = 0;
  float* info = A.info + row * (kInfoScalars + T);
  for (int i = tid; i <= T; i += nt) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += vel[i * D + d] * vel[i * D + d];
    const float vn = sqrtf(s);
    const float li = 0.5f * (vn * vn);
    loss[i] = li;
    part[0] += li;
    if (i < T) {
      part[1] += orow[i];
      info[kInfoScalars + i] = ow * orow[i] + sw * li;
    }
  }
  // the update: -eta P grad - M (xi[T - K:] - tail), arm dofs only unless
  // consider_finger, the gripper dofs clamped to [0, 0.04]
  const float* arm = masks;
  const float* clamp = masks + D;
  for (int e = tid; e < n; e += nt) {
    const int t = e / D, d = e - t * D;
    float pg = 0.f;
#pragma unroll 6
    for (int j = 0; j < T; ++j) pg += pm[t * T + j] * grad[j * D + d];
    float u = -eta * pg;
    if (proj && K > 0) {
      float mb = 0.f;
      for (int m = 0; m < K; ++m)
        mb += mm[t * K + m] * (sx[(T - K + m) * D + d] - tail[m * D + d]);
      u -= mb;
    }
    float v = (Dm.flags & kStepConsiderFinger) ? sx[e] + u : sx[e] + u * arm[d];
    if (clamp[d] != 0.f) v = clampf(v, 0.f, 0.04f);
    A.xi_out[row * n + e] = v;
    part[2] += grad[e] * grad[e];
    part[3] += sg[e] * sg[e];
    part[4] += og[e] * og[e];
    low |= sx[e] < lower[d] - 5e-3f;
    high |= sx[e] > upper[d] + 5e-3f;
  }
  if (proj) {
    for (int d = tid; d < D; d += nt) {
      const float r = sx[(T - 1) * D + d] - goal[d];
      part[5] += r * r;
    }
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) part[k] = warp_sum(part[k]);
  low = __any_sync(kFull, low);
  high = __any_sync(kFull, high);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[warp * kSums + k] = part[k];
    over[warp * 2] = low;
    over[warp * 2 + 1] = high;
  }
  __syncthreads();
  OMG_STAMP(1, 3);
  if (tid != 0) return;
  // thread 0: the warps' partials in warp order, the scalars and the flags
  float sum[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int any_low = 0, any_high = 0;
  for (int w = 0; w < nw; ++w) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) sum[k] += red[w * kSums + k];
    any_low |= over[w * 2];
    any_high |= over[w * 2 + 1];
  }
  const float s_sum = sum[0], o_sum = sum[1];
  const bool violate = any_low && any_high;
  const float goal_dist = sqrtf(sum[5]);
  const float w_obs = ow * o_sum, w_smooth = sw * s_sum;
  info[0] = w_obs + w_smooth;
  info[1] = o_sum;
  info[2] = s_sum;
  info[3] = w_obs;
  info[4] = w_smooth;
  info[5] = sqrtf(sum[2]);
  info[6] = sqrtf(sum[3]);
  info[7] = sqrtf(sum[4]);
  info[8] = collide;
  info[9] = goal_dist;
  const bool terminate = (Dm.flags & kPreTerminate) && collide <= C.allow &&
                         goal_dist < 0.01f && s_sum < C.tsl;
  unsigned char* f = A.flags + row * kFlags;
  f[0] = terminate && !violate;
  f[1] = collide >= C.allow10 || s_sum >= C.tsl25;
  f[2] = collide <= C.allow && s_sum < C.tsl;
  f[3] = violate;
  OMG_STAMP(1, 4);
}

}  // namespace

// Threads a block of chomp_obstacle takes: 1,024, or the row's T L P
// points in whole warps where they are fewer.
static int chomp_obstacle_threads(int T, int L, int P) {
  const long n = static_cast<long>(T) * L * P, t = (n + 31) / 32 * 32;
  return static_cast<int>(t < kMaxThreads ? t : kMaxThreads);
}

// Shared memory a block of chomp_obstacle needs, in bytes (without the
// copy of x and grad, which it adds where the whole fits kMaxSmem).
static size_t chomp_obstacle_smem(int T, int L, int P, int D) {
  const size_t n = static_cast<size_t>(T) * L * P, t = T, l = L, d = D;
  const size_t nt = chomp_obstacle_threads(T, L, P);
  const size_t nc = nt > t * l ? nt : t * l;
  return 4 * (3 * n + nc * d + t * d + 6 * t * d + l * d + d + l + t * l +
              kMaxWarps + 2 * t * kMaxBand + (t + 1) + kMaxWarps + kBins +
              2 + 1);
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
  const int threads = chomp_obstacle_threads(D.T, D.L, D.P);
  const size_t n = static_cast<size_t>(D.T) * D.L * D.P;
  if (D.D > kMaxDof || 2 * D.half > kMaxBand ||
      (n + threads - 1) / threads > 32)  // a thread's run is 32 bits
    return static_cast<int>(cudaErrorInvalidConfiguration);
  size_t smem = chomp_obstacle_smem(D.T, D.L, D.P, D.D);
  const bool stage = smem + 24 * n <= kMaxSmem;
  if (stage) smem += 24 * n;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chomp_obstacle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(chomp_obstacle_kernel, D.S, threads, smem, A, D, C, stage);
#else
  chomp_obstacle_kernel<<<D.S, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(A, D, C,
                                                               stage);
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
static size_t chomp_step_smem(int T, int D, int L, int K, int half) {
  const size_t n = static_cast<size_t>(T) * D, t = T, d = D;
  const size_t staged = 2 * n + t * L + 6 * d + K * d + t * t + t * K +
                        (t + 1) * 2 * half + 2 * t + t * (4 * half - 1);
  return 4 * (staged + 4 * n + d + 2 * t + 1 + kMaxWarps * (kSums + 2));
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
  const size_t smem = chomp_step_smem(D.T, D.D, D.L, D.K, D.half);
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
