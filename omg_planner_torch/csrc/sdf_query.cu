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
// Layout: one thread per (scene row, point), 256 a block.  The thread
// moves its point into each object's frame in index order, evaluates the
// penalised SDF and its gradient there (sdf_point.cuh, shared with
// rigid_rollout.cu), applies the hinge, rotates the gradient back with
// R^T and adds the object's terms, masked by its ``disables``, to its own
// sums.  No atomics (the reference adds with one atomicAdd a (point,
// object) pair, in an order that changes from run to run): the sums run
// in object order, so a point's result never depends on B, on P or on
// where it sits in the batch.
//
// Every input has a leading scene axis whose stride the caller gives (0:
// one row shared by every scene), so the scene tensors of an unbatched
// scene are never copied B times.  fp32, no fast math.
//
// -DOMG_CUDA_EMU compiles the file with g++ against cuda_emu.h
// (tests/test_torch_plan_kernels_emu.py).

#include "sdf_point.cuh"

namespace {

constexpr int kThreads = 256;

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

template <bool kBaked>
__global__ void __launch_bounds__(kThreads) sdf_query_kernel(Ptrs A, Dims D) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= D.B * D.P) return;
  const long long b = i / D.P, p = i % D.P;
  const V3 x = load3(A.points + b * D.s_points + p * 3);
  float pot = 0.f, col = 0.f;
  V3 g = v3(0.f, 0.f, 0.f);
  for (int o = 0; o < D.O; ++o) {
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
    pot += pv * keep;
    g = g + keep * gw;
    col += hit * keep;
  }
  A.pot[i] = pot;
  float* gd = A.grad + i * 3;
  gd[0] = g.x;
  gd[1] = g.y;
  gd[2] = g.z;
  A.collide[i] = col;
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
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(sdf_query_kernel<kBaked>, static_cast<int>(blocks), kThreads,
              0, A, D);
#else
  sdf_query_kernel<kBaked><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(A, D);
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
