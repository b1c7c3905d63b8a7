// The planner's collision query, for Hopper (sm_90a): CHOMP hinge
// potentials, world-frame gradients and collision counts of world points
// against every object of a scene, for B scenes at once.
//
// Computes ops/sdf.py::sdf_potentials_analytic_plain (box, sphere and
// cylinder primitives, edge-rounded, with the inside penalty) and
// ops/sdf.py::sdf_potentials_baked_plain (a 4-channel trilinear read of
// each object's baked grid, (1, 0) outside its volume): two
// instantiations of one kernel.  It has no Pallas counterpart: the JAX
// package leaves the query to XLA (omg_planner_tpu/ops/sdf.py
// _analytic_sdf_grad, sdf_potentials_analytic, _trilinear,
// _query_one_object_baked, _hinge_and_reduce, sdf_potentials_baked),
// because Mosaic could not express the reference's one thread per (point,
// object) gather (layers/sdf_matching_loss_kernel.cu of the reference).
// In eager PyTorch a query is ~150 small operations; the planner runs one
// on every CHOMP step (P = 4,500 points at full width), every learner sweep
// (72,000 to 225,000), the goal-set prune, the validator and the bakes of
// the learner's world potential.
//
// What bounds it: operations, on paper (~100 flops a (point, object) pair
// against 12 bytes in and 20 out a point), and the launch at the step's
// small P.
//
// Two layouts of one per-pair arithmetic (pair_terms), picked by the
// number of 32-point tiles, B ceil(P / 32):
// * spread, below kSpreadTiles: the (point, object) pairs spread over the
//   card.  A block takes 32 points of one scene row and min(O, kMaxWarps)
//   warps; warp w evaluates object w (then w + warps, ... when O is
//   larger) for the 32 points, one a lane, so every lane of a warp has the
//   same primitive kind and reads the same object data (one broadcast load
//   a value).  It writes the object's masked terms (pv keep, keep R^T go,
//   hit keep) to shared memory; after one barrier each point's five sums
//   take the terms in object order, one (sum, point) a thread.  The step's
//   P = 4,500 and O = 10 spread over 141 blocks of 320 threads (one thread
//   a point: 18 blocks);
// * loop, from kSpreadTiles on (the learner sweeps, 72,000 points and
//   more): a thread a point walks the objects in order with its sums in
//   registers.  There the points alone fill the card, and the loop, with
//   no barrier and no shared memory, measured faster than the spread
//   layout (scripts/sdf_query_layouts.py times both at the plan's shapes).
// Each pair's terms are computed by the same code in both, and both sum
// them in object order: no atomics (the reference adds with one atomicAdd
// a (point, object) pair, in an order that changes from run to run), so a
// point's result never depends on B, on P, on the layout or on where it
// sits in the batch.  The pair's work: the point moved into the object's
// frame, the penalised SDF and its gradient there (sdf_point.cuh, shared
// with rigid_rollout.cu), the hinge, the gradient rotated back with R^T.
//
// Every input has a leading scene axis whose stride the caller gives (0:
// one row shared by every scene), so the scene tensors of an unbatched
// scene are never copied B times.  fp32, no fast math.
//
// -DOMG_CUDA_EMU compiles the file with g++ against cuda_emu.h
// (tests/test_torch_plan_kernels_emu.py).

#include "sdf_point.cuh"

namespace {

constexpr int kMaxWarps = 16;  // warps a block, one an object
constexpr int kSums = 5;       // potential, gradient (3), collisions

struct Ptrs {
  const float* points;   // [B, P, 3] world points
  const float* inv;      // [B, O, 4, 4] world -> object
  const float* eps;      // [B, O]
  const float* pad;      // [B, O] padding scales
  const float* clr;      // [B, O] clearances
  const float* dis;      // [B, O] disables (> 0 drops the object)
  const int* kinds;      // analytic: [B, O] 0 box, 1 sphere, 2 cylinder
  const float* halfs;    // analytic: [B, O, 3]
  const float* penals;   // analytic: [B, O]
  const float* rounds;   // analytic: [B, O]
  const float4* grid;    // baked: [B, O, V] (value, gradient)
  const float* limits;   // baked: [B, O, 10]
  float* pot;            // [B, P]
  float* grad;           // [B, P, 3]
  float* collide;        // [B, P]
};
constexpr int kPtrs = 15;

// sizes, then the scene-axis stride of every input in Ptrs' order (in
// elements of its type; 0 = shared)
struct Dims {
  long long B, P, O, V;
  long long s_points, s_inv, s_eps, s_pad, s_clr, s_dis, s_kinds, s_halfs,
      s_penals, s_rounds, s_grid, s_limits;
};
constexpr int kDims = 16;

constexpr int kLoopThreads = 256;
#ifndef OMG_SDF_SPREAD_TILES  // a measurement build may move the switch
#define OMG_SDF_SPREAD_TILES 2048
#endif
// tiles of 32 points from which the loop layout takes over (65,536 points)
constexpr long long kSpreadTiles = OMG_SDF_SPREAD_TILES;

// Object o's terms at world point x of scene row b, ``stride`` apart in
// t: the masked potential, world gradient and collision count.
template <bool kBaked>
__device__ __forceinline__ void pair_terms(const Ptrs& A, const Dims& D,
                                           long long b, int o, V3 x,
                                           float* t, int stride) {
  const float* m = A.inv + b * D.s_inv + o * 16;
  const V3 po = v3(m[0] * x.x + m[1] * x.y + m[2] * x.z + m[3],
                   m[4] * x.x + m[5] * x.y + m[6] * x.z + m[7],
                   m[8] * x.x + m[9] * x.y + m[10] * x.z + m[11]);
  SdfG s;
  if (kBaked) {
    s = grid_sdf_grad(A.grid + b * D.s_grid + o * D.V,
                      A.limits + b * D.s_limits + o * 10, po);
  } else {
    s = analytic_sdf_grad(A.kinds[b * D.s_kinds + o],
                          load3(A.halfs + b * D.s_halfs + o * 3),
                          A.penals[b * D.s_penals + o],
                          A.rounds[b * D.s_rounds + o], po);
  }
  // the hinge (ops/sdf.py::_hinge)
  const float e = A.eps[b * D.s_eps + o], pd = A.pad[b * D.s_pad + o];
  float pv = 0.f, gs = 0.f;
  if (s.d <= 0.f) {
    pv = -s.d + 0.5f * e;
    gs = -1.f;
  } else if (s.d <= e) {
    const float u = s.d - e;
    pv = u * u / (2.f * e) * pd;
    gs = u / e * pd;
  }
  const V3 go = gs * s.g;
  const V3 gw = v3(m[0] * go.x + m[4] * go.y + m[8] * go.z,  // R^T go
                   m[1] * go.x + m[5] * go.y + m[9] * go.z,
                   m[2] * go.x + m[6] * go.y + m[10] * go.z);
  const float keep = A.dis[b * D.s_dis + o] <= 0.f ? 1.f : 0.f;
  const float hit = s.d < A.clr[b * D.s_clr + o] ? 1.f : 0.f;
  t[0] = pv * keep;
  t[stride] = keep * gw.x;
  t[2 * stride] = keep * gw.y;
  t[3 * stride] = keep * gw.z;
  t[4 * stride] = hit * keep;
}

// Point g's five sums into the outputs.
__device__ __forceinline__ void store_sum(const Ptrs& A, long long g, int sum,
                                          float v) {
  if (sum == 0)
    A.pot[g] = v;
  else if (sum < 4)
    A.grad[g * 3 + sum - 1] = v;
  else
    A.collide[g] = v;
}

// The spread layout.  Grid: B x tiles blocks (scene row major), 32 x
// min(O, kMaxWarps) threads.
template <bool kBaked>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sdf_spread_kernel(Ptrs A, Dims D, unsigned tiles) {
  __shared__ float terms[kMaxWarps * kSums * 32];  // [warp, sum, point]
  __shared__ float acc[kSums * 32];                // [sum, point]
  const int warps = blockDim.x / 32, w = threadIdx.x / 32,
            lane = threadIdx.x % 32, nt = blockDim.x;
  const unsigned row = blockIdx.x / tiles;
  const long long b = row;
  const long long p0 = static_cast<long long>(blockIdx.x - row * tiles) * 32;
  const int n_here = D.P - p0 < 32 ? static_cast<int>(D.P - p0) : 32;
  // a ragged tile's spare lanes repeat its first point and store nothing
  const V3 x = load3(A.points + b * D.s_points +
                     (p0 + (lane < n_here ? lane : 0)) * 3);
  // each (sum, point) has one owner thread, the same on every pass
  for (int i = threadIdx.x; i < kSums * 32; i += nt) acc[i] = 0.f;
  for (int o0 = 0; o0 < D.O; o0 += warps) {
    if (o0 + w < D.O)
      pair_terms<kBaked>(A, D, b, o0 + w, x, terms + w * kSums * 32 + lane,
                         32);
    __syncthreads();
    const int n_obj = D.O - o0 < warps ? static_cast<int>(D.O - o0) : warps;
    for (int i = threadIdx.x; i < kSums * 32; i += nt) {
      float a = acc[i];
      for (int r = 0; r < n_obj; ++r) a += terms[r * kSums * 32 + i];
      acc[i] = a;
    }
    __syncthreads();  // the terms are read before the next objects' land
  }
  for (int i = threadIdx.x; i < kSums * 32; i += nt)
    if (i % 32 < n_here) store_sum(A, b * D.P + p0 + i % 32, i / 32, acc[i]);
}

// The loop layout: a thread a (scene row, point).
template <bool kBaked>
__global__ void __launch_bounds__(kLoopThreads)
    sdf_loop_kernel(Ptrs A, Dims D) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kLoopThreads + threadIdx.x;
  if (i >= D.B * D.P) return;
  const long long b = i / D.P, p = i % D.P;
  const V3 x = load3(A.points + b * D.s_points + p * 3);
  float acc[kSums], t[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int o = 0; o < D.O; ++o) {
    pair_terms<kBaked>(A, D, b, o, x, t, 1);
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] += t[k];
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) store_sum(A, i, k, acc[k]);
}

template <bool kBaked>
int launch(void* const* ptrs, const long long* dims, void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int k = 0; k < kPtrs; ++k) dst[k] = ptrs[k];
  Dims D;
  long long* d = reinterpret_cast<long long*>(&D);
  for (int k = 0; k < kDims; ++k) d[k] = dims[k];
  const long long n = D.B * D.P;
  if (n <= 0) return 0;
  const long long tiles = (D.P + 31) / 32;
  const bool spread = D.B * tiles < kSpreadTiles;
  const long long blocks =
      spread ? D.B * tiles : (n + kLoopThreads - 1) / kLoopThreads;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int warps = D.O < 1 ? 1 : (D.O < kMaxWarps ? static_cast<int>(D.O)
                                                   : kMaxWarps);
#ifdef OMG_CUDA_EMU
  (void)stream;
  if (spread)
    emu::launch(sdf_spread_kernel<kBaked>, static_cast<int>(blocks),
                32 * warps, 0, A, D, static_cast<unsigned>(tiles));
  else
    emu::launch(sdf_loop_kernel<kBaked>, static_cast<int>(blocks),
                kLoopThreads, 0, A, D);
#else
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (spread)
    sdf_spread_kernel<kBaked><<<static_cast<unsigned>(blocks), 32 * warps, 0,
                                s>>>(A, D, static_cast<unsigned>(tiles));
  else
    sdf_loop_kernel<kBaked><<<static_cast<unsigned>(blocks), kLoopThreads, 0,
                              s>>>(A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: the 15 pointers of Ptrs in order (the other variant's inputs may
// be null); dims: the 16 values of Dims.  Each returns the CUDA error of
// the launch (0 on success).
extern "C" int omg_sdf_query_analytic(void* const* ptrs,
                                      const long long* dims, void* stream) {
  return launch<false>(ptrs, dims, stream);
}

extern "C" int omg_sdf_query_baked(void* const* ptrs, const long long* dims,
                                   void* stream) {
  return launch<true>(ptrs, dims, stream);
}
