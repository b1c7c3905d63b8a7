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
// in one launch with no host read, and takes everything that does not
// change from pass to pass out of the loop.
//
// Layout: one block a row, one warp an expert (5 warps); lane l owns goals
// l, l + 32, ...
//  1. each warp computes its expert's loop invariants once: for each of
//     its lane's goals the mask m, delta = m / (4 n + 1), shiftx = (x +
//     delta) m, v = eta cv, log max(shiftx, 1e-30) and the log ratio
//     log(delta / max(shiftx, 1e-20)).  Up to 128 goals (4 a lane) they
//     stay in registers (the kernel is instantiated for 1 to 4 goals a
//     lane); above, the block stages cv and the mask in shared memory and
//     each warp keeps its logs and its state there (v is one product of
//     the staged cv);
//  2. each warp runs its expert's projection on its own: a pass is one
//     exponential and a few sums a goal and three butterfly reductions
//     (every lane gets the same bits), under the plain version's
//     condition (diff > tol) & (it < max_iters), so an expert freezes when
//     its own alpha converges, as each row does in the JAX package's
//     vmapped while_loop.  A row whose live flag is false runs no pass,
//     then the final solve, as the plain version does;
//  3. each warp writes its projection and its cost; after a barrier lanes
//     0-4 of every warp run the q recurrence (lane k expert k, the sum
//     gathered in the order 0..4: five dependent steps of a product, a sum
//     and a division; the exponentials of the old and new costs are taken
//     before the chain, the old costs and the mixture read at the start);
//  4. all 160 threads form the mixture q @ p_new, one goal a thread; after
//     a barrier every warp sums it in lane order (the order of one warp's
//     sweep over the goals) and the block writes p.
//
// Arithmetic: fp32, no fast math; every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an FMA), each sum is
// taken in the same order in both layouts, the clamps are the plain
// version's and NaN-propagating as torch's.  A row's result depends on
// nothing but its own inputs, so the rows of a launch of S rows are
// bit-equal to launches of one row.
//
// omg_empty_launch launches an empty kernel at a given grid, the floor
// under any launch of these short kernels.
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
constexpr int kRegGoals = 4;  // goals a lane holds in registers at most
constexpr unsigned kFull = 0xffffffffu;

struct Ptrs {
  const float* experts_p;     // [S, 5, G]
  const float* cv;            // [S, G] the finalised cost vector
  const unsigned char* mask;  // [S, G] bool
  const float* costs;         // [S, 5] the experts' last costs
  const float* q;             // [S, 5] the expert mixture
  const unsigned char* live;  // [S] bool, or null: every row live
  float* out;  // p [S, G], experts_p [S, 5, G], costs [S, 5], q [S, 5]
};
constexpr int kPtrs = 7;

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

// One row, as a thread sees it, with what the end of the kernel reads
// loaded at its start.
struct Row {
  size_t r;
  int G, e, lane, tid;
  const float* x;             // [G] this warp's expert's distribution
  const float* cv;            // [G]
  const unsigned char* mask;  // [G]
  // expert k = lane's exp(-last cost) and mixture (lanes < 5)
  float e_old_k, q_k;
  float m_tid;        // the mask at goal tid (0 past G)
};

// A lane's goals lane + 32 j, j < K, with their loop invariants and the
// fixed point's state alpha in registers (G <= 32 K).
template <int K>
struct RegGoals {
  int G, lane;
  float m_[K], x_[K], cv_[K], delta_[K], shiftx_[K], v_[K], lsx_[K],
      lr_[K], alpha_[K];

  __device__ RegGoals(const Row& R) : G(R.G), lane(R.lane) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int g = lane + 32 * j;
      m_[j] = g < G && R.mask[g] ? 1.f : 0.f;
      x_[j] = g < G ? R.x[g] : 0.f;
      cv_[j] = g < G ? R.cv[g] : 0.f;
    }
  }
  __device__ int slots() const { return K; }
  __device__ bool has(int j) const { return lane + 32 * j < G; }
  __device__ int goal(int j) const { return lane + 32 * j; }
  __device__ float m(int j) const { return m_[j]; }
  __device__ float x(int j) const { return x_[j]; }
  __device__ float cv(int j) const { return cv_[j]; }
  __device__ float delta(int j) const { return delta_[j]; }
  __device__ float shiftx(int j) const { return shiftx_[j]; }
  __device__ float v(int j) const { return v_[j]; }
  __device__ float lsx(int j) const { return lsx_[j]; }
  __device__ float lr(int j) const { return lr_[j]; }
  __device__ float& alpha(int j) { return alpha_[j]; }
  // the projection, once the loop has ended (in the log ratio's place)
  __device__ float& y(int j) { return lr_[j]; }
  __device__ void init(int j, float eta, float denom) {
    delta_[j] = m_[j] / denom;
    shiftx_[j] = mul(add(x_[j], delta_[j]), m_[j]);
    v_[j] = mul(eta, cv_[j]);
    lsx_[j] = logf(clamp_min(shiftx_[j], 1e-30f));
    lr_[j] = logf(delta_[j] / clamp_min(shiftx_[j], 1e-20f));
    alpha_[j] = 0.f;
  }
};

// The same goals above 128: cv and the mask staged by the block, this
// expert's logs, log ratios and alpha in its own rows of shared memory
// (written and read by the owning lane alone); v, delta and shiftx are
// formed where they are needed (v each pass: one product).
struct SmemGoals {
  int G, lane;
  float eta, denom;
  const float* x_;   // [G] global
  const float* cv_;  // [G] staged
  const float* m_;   // [G] staged, 0 / 1
  float* lsx_;       // [G]
  float* lr_;        // [G]; the projection once the loop has ended
  float* alpha_;     // [G]

  __device__ int slots() const { return lane < G ? (G - lane + 31) / 32 : 0; }
  __device__ bool has(int) const { return true; }
  __device__ int goal(int j) const { return lane + 32 * j; }
  __device__ float m(int j) const { return m_[goal(j)]; }
  __device__ float x(int j) const { return x_[goal(j)]; }
  __device__ float cv(int j) const { return cv_[goal(j)]; }
  __device__ float delta(int j) const { return m(j) / denom; }
  __device__ float shiftx(int j) const {
    return mul(add(x(j), delta(j)), m(j));
  }
  __device__ float v(int j) const { return mul(eta, cv(j)); }
  __device__ float lsx(int j) const { return lsx_[goal(j)]; }
  __device__ float lr(int j) const { return lr_[goal(j)]; }
  __device__ float& alpha(int j) { return alpha_[goal(j)]; }
  __device__ float& y(int j) { return lr_[goal(j)]; }
  __device__ void init(int j, float eta_e, float denom_) {
    eta = eta_e;
    denom = denom_;
    const float sx = shiftx(j);
    lsx_[goal(j)] = logf(clamp_min(sx, 1e-30f));
    lr_[goal(j)] = logf(delta(j) / clamp_min(sx, 1e-20f));
    alpha_[goal(j)] = 0.f;
  }
};

// el = clip(log target - logsumexp(log shiftx + alpha - v), 0, upper)
template <class Goals>
__device__ float solve_el(Goals& gs, float log_target, float upper) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j) {
    if (gs.has(j) && gs.m(j) > 0.f)
      mx = tmax(mx, add(gs.lsx(j), sub(gs.alpha(j), gs.v(j))));
  }
  mx = warp_max(mx);
  const float shift = fabsf(mx) == INFINITY ? 0.f : mx;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j) {
    if (!gs.has(j)) continue;
    const float logs = gs.m(j) > 0.f
                           ? add(gs.lsx(j), sub(gs.alpha(j), gs.v(j)))
                           : -INFINITY;
    s = add(s, expf(sub(logs, shift)));
  }
  const float lse = add(logf(warp_sum(s)), shift);
  return tmin(tmax(sub(log_target, lse), 0.f), upper);
}

// One expert's update on its warp: its invariants, its projection's loop,
// the final solve; writes the normalised projection to pnew [G] and the
// output, returns the expert's cost (every lane).
template <class Goals>
__device__ float project(Goals& gs, const Row& R, const Dims& D, bool live,
                         float* pnew, float* ep_out) {
  // the row's constants, computed by every warp alike (the count of valid
  // goals is exact in any order)
  float n = 0.f;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j)
    if (gs.has(j)) n = add(n, gs.m(j));
  const float n_valid = clamp_min(warp_sum(n), 1.f);
  const float eta =
      sqrtf(logf(add(n_valid, 1.f)) / static_cast<float>(D.optim_steps));
  const float eta_e = mul(eta, eta_scale(R.e));
  const float denom = add(mul(4.f, n_valid), 1.f);
  float dsum = 0.f, up = -INFINITY;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j) {
    if (!gs.has(j)) continue;
    gs.init(j, eta_e, denom);
    dsum = add(dsum, mul(gs.delta(j), gs.m(j)));
    if (gs.m(j) > 0.f) up = tmax(up, add(1.f, gs.v(j)));
  }
  const float log_target = logf(add(1.f, warp_sum(dsum)));
  const float upper = warp_max(up);

  // the fixed point: alpha' = max(v - el + log(delta / shiftx), 0) * m
  float diff = live ? INFINITY : 0.f;
  for (int it = 0; diff > D.tol && it < D.max_iters; ++it) {
    const float el = solve_el(gs, log_target, upper);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < gs.slots(); ++j) {
      if (!gs.has(j)) continue;
      const float ap =
          mul(clamp_min(add(sub(gs.v(j), el), gs.lr(j)), 0.f), gs.m(j));
      const float d = sub(ap, gs.alpha(j));
      acc = add(acc, mul(d, d));
      gs.alpha(j) = ap;
    }
    diff = sqrtf(warp_sum(acc));
  }

  // the projection y, normalised, and the expert's cost
  const float el = solve_el(gs, log_target, upper);
  float ysum = 0.f;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j) {
    if (!gs.has(j)) continue;
    const float ex_arg =
        clamp(sub(add(el, gs.alpha(j)), gs.v(j)), -60.f, 60.f);
    const float y = sub(mul(gs.shiftx(j), expf(ex_arg)), gs.delta(j));
    gs.y(j) = clamp_min(mul(y, gs.m(j)), 0.f);
    ysum = add(ysum, gs.y(j));
  }
  const float norm = clamp_min(warp_sum(ysum), 1e-12f);
  float c1 = 0.f, c2 = 0.f;
#pragma unroll
  for (int j = 0; j < gs.slots(); ++j) {
    if (!gs.has(j)) continue;
    const float pg = gs.y(j) / norm;
    pnew[gs.goal(j)] = pg;
    ep_out[gs.goal(j)] = pg;
    c1 = add(c1, mul(mul(gs.cv(j), gs.m(j)), pg));
    c2 = add(c2, mul(gs.m(j), fabsf(sub(pg, gs.x(j)))));
  }
  return add(warp_sum(c1), warp_sum(c2));
}

// The experts' projections pnew [5, G] and costs c_new [5] are in shared
// memory (after a barrier): the q recurrence and the mixture.  pm [G] is
// scratch.
__device__ void mix(const Ptrs& A, const Dims& D, const Row& R,
                    const float* pnew, const float* c_new, float* pm) {
  const int G = R.G;
  float* p_out = A.out;
  float* q_out = A.out + static_cast<size_t>(D.S) * (kExperts + 1) * G +
                 static_cast<size_t>(D.S) * kExperts;
  // the q recurrence on lanes 0-4 of every warp, in the plain version's
  // order: at step i, fresh costs for experts 0..i, the last step's for
  // the rest; the sum gathered in the order 0..4
  const int k = R.lane < kExperts ? R.lane : 0;
  const float e_new = expf(-c_new[k]);
  float qk = R.q_k;
#pragma unroll
  for (int i = 0; i < kExperts; ++i) {
    qk = mul(qk, k <= i ? e_new : R.e_old_k);
    float s = __shfl_sync(kFull, qk, 0);
#pragma unroll
    for (int j = 1; j < kExperts; ++j) s = add(s, __shfl_sync(kFull, qk, j));
    qk = qk / clamp_min(s, 1e-12f);
  }
  if (R.e == 0 && R.lane < kExperts) q_out[R.r * kExperts + R.lane] = qk;
  float q[kExperts];
#pragma unroll
  for (int j = 0; j < kExperts; ++j) q[j] = __shfl_sync(kFull, qk, j);

  // the mixture p = normalise(q @ p_new) * mask: one goal a thread, then
  // every warp sums it in one warp's sweep order
  for (int g = R.tid; g < G; g += kThreads) {
    float pg = mul(q[0], pnew[g]);
#pragma unroll
    for (int j = 1; j < kExperts; ++j)
      pg = add(pg, mul(q[j], pnew[j * G + g]));
    pm[g] = pg;
  }
  __syncthreads();
  float psum = 0.f;
  for (int g = R.lane; g < G; g += 32) psum = add(psum, pm[g]);
  const float pn = clamp_min(warp_sum(psum), 1e-12f);
  for (int g = R.tid; g < G; g += kThreads)
    p_out[R.r * G + g] =
        mul(pm[g] / pn, g == R.tid ? R.m_tid : (R.mask[g] ? 1.f : 0.f));
}

// K > 0: K goals a lane in registers (G <= 32 K); K = 0: shared memory.
template <int K>
__global__ void __launch_bounds__(kThreads)
    md_update_kernel(Ptrs A, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int G = D.G, tid = threadIdx.x;
  Row R;
  R.r = blockIdx.x;
  R.G = G;
  R.tid = tid;
  R.e = tid >> 5;
  R.lane = tid & 31;
  R.x = A.experts_p + (R.r * kExperts + R.e) * G;
  R.cv = A.cv + R.r * G;
  R.mask = A.mask + R.r * G;
  const int k = R.lane < kExperts ? R.lane : 0;
  R.e_old_k = expf(-A.costs[R.r * kExperts + k]);
  R.q_k = A.q[R.r * kExperts + k];
  R.m_tid = tid < G && R.mask[tid] ? 1.f : 0.f;
  float* ep_out = A.out + static_cast<size_t>(D.S) * G +
                  (R.r * kExperts + R.e) * G;
  float* c_out = A.out + static_cast<size_t>(D.S) * (kExperts + 1) * G;
  const bool live = A.live == nullptr || A.live[R.r];
  float cost;
  float *pnew, *pm, *c_new;
  if constexpr (K > 0) {
    pnew = smem;                  // [5, G]
    pm = pnew + kExperts * G;     // [G]
    c_new = pm + G;               // [5]
    RegGoals<K> gs(R);
    cost = project(gs, R, D, live, pnew + R.e * G, ep_out);
  } else {
    float* cv = smem;                     // [G]
    float* m = cv + G;                    // [G]
    float* alpha = m + G;                 // [5, G]
    float* lsx = alpha + kExperts * G;    // [5, G]; pm once the loop ends
    float* lr = lsx + kExperts * G;       // [5, G]; pnew once it ends
    c_new = lr + kExperts * G;            // [5]
    pnew = lr;
    pm = lsx;
    for (int g = tid; g < G; g += kThreads) {
      cv[g] = R.cv[g];
      m[g] = R.mask[g] ? 1.f : 0.f;
    }
    __syncthreads();
    SmemGoals gs{G, R.lane, 0.f, 1.f, R.x, cv, m, lsx + R.e * G,
                 lr + R.e * G, alpha + R.e * G};
    cost = project(gs, R, D, live, pnew + R.e * G, ep_out);
  }
  if (R.lane == 0) {
    c_new[R.e] = cost;
    c_out[R.r * kExperts + R.e] = cost;
  }
  __syncthreads();
  mix(A, D, R, pnew, c_new, pm);
}

__global__ void empty_kernel() {}

}  // namespace

// Shared memory a block needs for G goals, in bytes.
static size_t md_update_smem(int G) {
  const size_t per_goal = G <= 32 * kRegGoals ? kExperts + 1
                                              : 2 + 3 * kExperts;
  return sizeof(float) * (per_goal * G + kExperts);
}

template <int K>
static int launch_md(const Ptrs& A, const Dims& D, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        md_update_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(md_update_kernel<K>, D.S, kThreads, smem, A, D);
#else
  md_update_kernel<K><<<D.S, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}

// ptrs: the 7 pointers of Ptrs in order (out: one buffer of S (6 G + 10)
// floats, p, experts_p, costs and q one after another); dims: S, G,
// optim_steps, max_iters; tol.  Returns the CUDA error of the launch (0
// on success).
extern "C" int omg_md_update(void* const* ptrs, const int* dims, float tol,
                             void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kPtrs; ++i) dst[i] = ptrs[i];
  const Dims D{dims[0], dims[1], dims[2], dims[3], tol};
  if (D.S <= 0) return 0;
  const size_t smem = md_update_smem(D.G);
  switch ((D.G + 31) / 32) {
    case 1: return launch_md<1>(A, D, smem, stream);
    case 2: return launch_md<2>(A, D, smem, stream);
    case 3: return launch_md<3>(A, D, smem, stream);
    case 4: return launch_md<4>(A, D, smem, stream);
    default: return launch_md<0>(A, D, smem, stream);
  }
}

// An empty kernel of ``blocks`` blocks of ``threads`` threads: what any
// launch costs.  Returns the CUDA error of the launch.
extern "C" int omg_empty_launch(int blocks, int threads, void* stream) {
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(empty_kernel, blocks, threads, 0);
#else
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
#endif
  return static_cast<int>(cudaGetLastError());
}
