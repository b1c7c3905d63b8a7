// The online learner's Mirror Descent (MD) expert update, for Hopper
// (sm_90a).
//
// Computes ops/kernels.py::md_update_plain: the MD branch of
// ops/learner.py::update_goal_dist for S rows (scenes) at once.  Each of
// the 5 experts' distributions over G goals is projected onto the shifted
// simplex (learner.py::bregman_projection with w = 1: a fixed-point loop
// of at most max_iters passes that stops on its own convergence at tol,
// the inner root in closed form by logsumexp), then each expert's cost,
// the order-dependent q recurrence over the experts and the mixture p.  It
// has no Pallas counterpart: the JAX package leaves the update to XLA,
// which keeps the loop on the device (omg_planner_tpu/ops/learner.py
// bregman_projection's lax.while_loop and update_goal_dist's fori_loop).
// In eager PyTorch the same update is ~145 small operations a plan step
// and one host read a pass of the loop.
//
// What bounds it: neither bytes (a row reads and writes ~5 KB at G = 100)
// nor operations (~20 K flops a pass): the latency of the loop's chain of
// warp reductions, and of the launch.  The design keeps the whole update
// in one launch with no host read.
//
// Layout: one block a row, one warp an expert (5 warps).
//  0. the block stages the row's cv, mask and the experts' distributions
//     in shared memory;
//  1. each warp runs its expert's projection on its own: lane l holds
//     goals l, l + 32, ..., the sums, the maxima and the logsumexp are
//     butterfly reductions (every lane gets the same bits), and the loop
//     condition (diff > tol) & (it < max_iters) is the plain version's,
//     so an expert freezes when its own alpha converges, as each row does
//     in the JAX package's vmapped while_loop.  A row whose live flag is
//     false runs no pass, then the final solve, as the plain version does;
//  2. each warp writes its projection and its cost; after a barrier one
//     thread runs the q recurrence in the plain version's order (at step
//     i, fresh costs for experts 0..i, the last step's for the rest);
//  3. after another, warp 0 forms the mixture p.
//
// Arithmetic: fp32, no fast math; every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an FMA), the clamps are
// the plain version's and NaN-propagating as torch's.  A row's result
// depends on nothing but its own inputs, so the rows of a launch of S
// rows are bit-equal to launches of one row.
//
// -DOMG_CUDA_EMU compiles the file with g++ against cuda_emu.h
// (tests/test_torch_learner_kernels_emu.py).

#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#define OMG_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem()
#else
#include <cuda_runtime.h>
#define OMG_DYNAMIC_SMEM(name) extern __shared__ float name[]
#endif
#include <math.h>

namespace {

constexpr int kExperts = 5;
constexpr int kThreads = 32 * kExperts;
constexpr unsigned kFull = 0xffffffffu;

struct Ptrs {
  const float* experts_p;     // [S, 5, G]
  const float* cv;            // [S, G] the finalised cost vector
  const unsigned char* mask;  // [S, G] bool
  const float* costs;         // [S, 5] the experts' last costs
  const float* q;             // [S, 5] the expert mixture
  const unsigned char* live;  // [S] bool, or null: every row live
  float* p;                   // [S, G]
  float* experts_p_out;       // [S, 5, G]
  float* costs_out;           // [S, 5]
  float* q_out;               // [S, 5]
};
constexpr int kPtrs = 10;

struct Dims {
  int S, G, optim_steps, max_iters;
  float tol;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fadd_rn(a, -b);
}
// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the eta multiplier 2^k of expert e (ops/learner.py _ETA_POWERS)
__device__ __forceinline__ float eta_scale(int e) {
  return e == 0 ? 0.25f : e == 1 ? 0.5f : e == 2 ? 1.f : e == 3 ? 4.f : 16.f;
}

// One expert's view of its row: the goal-wise terms of the projection,
// recomputed from the staged inputs where they are needed (the same bits
// every time).
struct Expert {
  const float* x;   // [G] the expert's distribution
  const float* cv;  // [G]
  const float* m;   // [G] the mask as 0 / 1
  float* alpha;     // [G] the fixed point's state
  int G, lane;
  float eta, denom, log_target, upper;

  __device__ float delta(int g) const { return m[g] / denom; }
  __device__ float shiftx(int g) const {
    return mul(add(x[g], delta(g)), m[g]);
  }
  __device__ float v(int g) const { return mul(eta, cv[g]); }

  // el = clip(log target - logsumexp(log shiftx + alpha - v), 0, upper)
  __device__ float solve_el() const {
    float mx = -INFINITY;
    for (int g = lane; g < G; g += 32) {
      if (m[g] > 0.f) {
        mx = tmax(mx, add(logf(clamp_min(shiftx(g), 1e-30f)),
                          sub(alpha[g], v(g))));
      }
    }
    mx = warp_max(mx);
    const float shift = fabsf(mx) == INFINITY ? 0.f : mx;
    float s = 0.f;
    for (int g = lane; g < G; g += 32) {
      const float logs =
          m[g] > 0.f ? add(logf(clamp_min(shiftx(g), 1e-30f)),
                           sub(alpha[g], v(g)))
                     : -INFINITY;
      s = add(s, expf(sub(logs, shift)));
    }
    const float lse = add(logf(warp_sum(s)), shift);
    return tmin(tmax(sub(log_target, lse), 0.f), upper);
  }
};

__global__ void md_update_kernel(Ptrs A, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int G = D.G;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int e = tid >> 5;
  const int lane = tid & 31;
  float* cv = smem;                          // [G]
  float* m = cv + G;                         // [G]
  float* x = m + G;                          // [5, G]
  float* alpha = x + kExperts * G;           // [5, G]
  float* pnew = alpha + kExperts * G;        // [5, G]
  float* c_new = pnew + kExperts * G;        // [5]
  float* q_new = c_new + kExperts;           // [5]

  const size_t row = static_cast<size_t>(r);
  for (int g = tid; g < G; g += kThreads) {
    cv[g] = A.cv[row * G + g];
    m[g] = A.mask[row * G + g] ? 1.f : 0.f;
  }
  for (int k = tid; k < kExperts * G; k += kThreads) {
    x[k] = A.experts_p[row * kExperts * G + k];
    alpha[k] = 0.f;
  }
  __syncthreads();

  // the row's constants, computed by every warp alike (the count of valid
  // goals is exact in any order)
  float n = 0.f, dsum = 0.f;
  for (int g = lane; g < G; g += 32) n = add(n, m[g]);
  const float n_valid = clamp_min(warp_sum(n), 1.f);
  const float eta =
      sqrtf(logf(add(n_valid, 1.f)) / static_cast<float>(D.optim_steps));
  Expert ex{x + e * G, cv, m, alpha + e * G, G, lane,
            mul(eta, eta_scale(e)), add(mul(4.f, n_valid), 1.f), 0.f,
            -INFINITY};
  float up = -INFINITY;
  for (int g = lane; g < G; g += 32) {
    dsum = add(dsum, mul(ex.delta(g), m[g]));
    if (m[g] > 0.f) up = tmax(up, add(1.f, ex.v(g)));
  }
  ex.log_target = logf(add(1.f, warp_sum(dsum)));
  ex.upper = warp_max(up);

  // the fixed point: alpha' = max(v - el + log(delta / shiftx), 0) * m
  const bool live = A.live == nullptr || A.live[r];
  float diff = live ? INFINITY : 0.f;
  for (int it = 0; diff > D.tol && it < D.max_iters; ++it) {
    const float el = ex.solve_el();
    float acc = 0.f;
    for (int g = lane; g < G; g += 32) {
      const float sx = ex.shiftx(g);
      const float log_ratio = logf(ex.delta(g) / clamp_min(sx, 1e-20f));
      const float ap =
          mul(clamp_min(add(sub(ex.v(g), el), log_ratio), 0.f), m[g]);
      const float d = sub(ap, ex.alpha[g]);
      acc = add(acc, mul(d, d));
      ex.alpha[g] = ap;
    }
    diff = sqrtf(warp_sum(acc));
  }

  // the projection y, normalised, and the expert's cost
  const float el = ex.solve_el();
  float ysum = 0.f;
  float* out = pnew + e * G;
  for (int g = lane; g < G; g += 32) {
    const float ex_arg = clamp(sub(add(el, ex.alpha[g]), ex.v(g)), -60.f, 60.f);
    const float y = sub(mul(ex.shiftx(g), expf(ex_arg)), ex.delta(g));
    out[g] = clamp_min(mul(y, m[g]), 0.f);
    ysum = add(ysum, out[g]);
  }
  const float norm = clamp_min(warp_sum(ysum), 1e-12f);
  float c1 = 0.f, c2 = 0.f;
  for (int g = lane; g < G; g += 32) {
    const float pg = out[g] / norm;
    out[g] = pg;
    A.experts_p_out[(row * kExperts + e) * G + g] = pg;
    c1 = add(c1, mul(mul(cv[g], m[g]), pg));
    c2 = add(c2, mul(m[g], fabsf(sub(pg, ex.x[g]))));
  }
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0) {
    c_new[e] = add(c1, c2);
    A.costs_out[row * kExperts + e] = c_new[e];
  }
  __syncthreads();

  // the q recurrence, in the plain version's order
  if (tid == 0) {
    float qv[kExperts];
    for (int k = 0; k < kExperts; ++k) qv[k] = A.q[row * kExperts + k];
    for (int i = 0; i < kExperts; ++i) {
      for (int k = 0; k < kExperts; ++k) {
        const float ck = k <= i ? c_new[k] : A.costs[row * kExperts + k];
        qv[k] = mul(qv[k], expf(-ck));
      }
      float s = qv[0];
      for (int k = 1; k < kExperts; ++k) s = add(s, qv[k]);
      s = clamp_min(s, 1e-12f);
      for (int k = 0; k < kExperts; ++k) qv[k] = qv[k] / s;
    }
    for (int k = 0; k < kExperts; ++k) {
      q_new[k] = qv[k];
      A.q_out[row * kExperts + k] = qv[k];
    }
  }
  __syncthreads();

  // the mixture p = normalise(q @ p_new) * mask
  if (e != 0) return;
  float psum = 0.f;
  for (int g = lane; g < G; g += 32) {
    float pg = mul(q_new[0], pnew[g]);
    for (int k = 1; k < kExperts; ++k)
      pg = add(pg, mul(q_new[k], pnew[k * G + g]));
    psum = add(psum, pg);
  }
  const float pn = clamp_min(warp_sum(psum), 1e-12f);
  for (int g = lane; g < G; g += 32) {
    float pg = mul(q_new[0], pnew[g]);
    for (int k = 1; k < kExperts; ++k)
      pg = add(pg, mul(q_new[k], pnew[k * G + g]));
    A.p[row * G + g] = mul(pg / pn, m[g]);
  }
}

}  // namespace

// Shared memory a block needs for G goals, in bytes.
static size_t md_update_smem(int G) {
  return sizeof(float) * (static_cast<size_t>(2 + 3 * kExperts) * G +
                          2 * kExperts);
}

// ptrs: the 10 pointers of Ptrs in order; dims: S, G, optim_steps,
// max_iters; tol.  Returns the CUDA error of the launch (0 on success).
extern "C" int omg_md_update(void* const* ptrs, const int* dims, float tol,
                             void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kPtrs; ++i) dst[i] = ptrs[i];
  const Dims D{dims[0], dims[1], dims[2], dims[3], tol};
  if (D.S <= 0) return 0;
  const size_t smem = md_update_smem(D.G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        md_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(md_update_kernel, D.S, kThreads, smem, A, D);
#else
  md_update_kernel<<<D.S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}
