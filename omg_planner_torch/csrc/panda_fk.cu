// Batched Franka Panda forward kinematics and body points, for Hopper
// (sm_90a).
//
// Computes models/panda.py::forward_kinematics_batch (link poses, with or
// without the mesh-centre offsets, and the world joint origins and axes)
// followed by collision_point_positions (the body points of every link),
// for N configurations at once.  It has no Pallas counterpart: the JAX
// package leaves this chain to XLA, which fuses it
// (omg_planner_tpu/models/panda.py forward_kinematics_batch and
// collision_point_positions).  In eager PyTorch the same chain is ~450
// small operations a call; the planner calls it on every CHOMP step
// (N = 2 and T = 30), on every learner sweep (N = G x (n + 2), 544 to
// 1,700) and in the goal-set prune.
//
// What bounds it: bytes, on paper (a configuration writes 10 poses, 20 joint
// vectors and 10 P points, 1.0 KB at P = 15, for ~5,000 flops), and in
// practice the latency of one chain: 13 dependent 4 x 4 products, and the
// main path's N are small.
//
// Layout: one block of kCpb = 4 configurations, 16 lanes each (64
// threads), so N = 30 spreads over 8 blocks and N = 1,700 over 425.
//  0. the block stages the model's tables (one buffer, laid out once per
//     model by ops/kernels.py::_fk_tables) in shared memory;
//  1. each configuration's 16 lanes walk its chain element-parallel: lane
//     e = 4 i + j holds element (i, j) of the running 4 x 4 pose, gets row
//     i of the left factor and column j of a computed right factor by
//     shuffle within its 16 lanes, and reads a constant right factor from
//     shared memory.  Lane k < 7 takes cos and sin of q_k, which reach the
//     other lanes by shuffle.  The links, origins and axes go to shared
//     memory; the two finger products run side by side;
//  2. after one barrier the block multiplies the mesh-centre offsets in
//     (one output element a thread) and writes its poses, origins and axes
//     with coalesced stores;
//  3. after another, the block writes its body points, one (configuration,
//     link, point) a thread, from the poses in shared memory.
//
// Arithmetic: fp32, no fast math, and every product and sum rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an FMA) in the plain
// version's order: b = (P cos + Q sin) + R, the 4 x 4 products
// ((a0 b0 + a1 b1) + a2 b2) + a3 b3 (models/panda.py::_mm4_lanes, the JAX
// package's association), a point ((r0 p0 + r1 p1) + r2 p2) + t.  So on the
// card it gives the plain version's bits wherever cosf and sinf agree with
// torch's, and a configuration's result never depends on N or on where it
// sits in the batch.
//
// -DOMG_CUDA_EMU compiles the file with g++ against cuda_emu.h
// (tests/test_torch_plan_kernels_emu.py).

#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#define OMG_DYNAMIC_SMEM(name) float* name = emu::dynamic_smem()
#else
#include <cuda_runtime.h>
#define OMG_DYNAMIC_SMEM(name) extern __shared__ float name[]
#endif
#include <math.h>

namespace {

constexpr int kLinks = 10;
constexpr int kJoints = 7;
constexpr int kDof = 9;
constexpr int kLanes = 16;  // lanes a configuration: one a 4 x 4 element
constexpr int kCpb = 4;     // configurations a block
constexpr int kThreads = kCpb * kLanes;
constexpr unsigned kFull = 0xffffffffu;
// the tables' buffer, in floats: P_i, Q_i, R_i of models/panda.py::pqr_table
// [7, 3, 4, 4], the rest poses [10, 4, 4], the link frame -> mesh centre
// offsets [10, 4, 4], then (with_points) the body points [10, P, 3]
constexpr int kPqr = 0;
constexpr int kPose0 = kPqr + kJoints * 48;
constexpr int kOffset = kPose0 + kLinks * 16;
constexpr int kPts = kOffset + kLinks * 16;
// shared memory a block holds besides the tables, in floats: the links and
// the poses [kCpb, 10, 16], the origins and the axes [kCpb, 10, 3]
constexpr int kWork = kCpb * kLinks * (2 * 16 + 2 * 3);

struct Ptrs {
  const float* q;    // [N, 9]
  const float* tab;  // the tables' buffer (above)
  float* poses;      // [N, 10, 4, 4]
  float* origins;    // [N, 10, 3]
  float* axes;       // [N, 10, 3]
  float* x;          // [N, 10, P, 3] (with_points)
};
constexpr int kPtrs = 6;

struct Dims {
  int N, P, apply_offset, with_points;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// ((a0 b0 + a1 b1) + a2 b2) + a3 b3
__device__ __forceinline__ float dot4(float a0, float a1, float a2, float a3,
                                      float b0, float b1, float b2,
                                      float b3) {
  return add(add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2)), mul(a3, b3));
}

// Element (i, j) of a @ b for the lane e = 4 i + j of a 16-lane group that
// holds a (one element a lane), with b's column j given.
__device__ __forceinline__ float mm_lane(float a, int i, float b0, float b1,
                                         float b2, float b3) {
  const float a0 = __shfl_sync(kFull, a, 4 * i, kLanes);
  const float a1 = __shfl_sync(kFull, a, 4 * i + 1, kLanes);
  const float a2 = __shfl_sync(kFull, a, 4 * i + 2, kLanes);
  const float a3 = __shfl_sync(kFull, a, 4 * i + 3, kLanes);
  return dot4(a0, a1, a2, a3, b0, b1, b2, b3);
}

// ... with b held one element a lane too.
__device__ __forceinline__ float mm_lanes(float a, float b, int i, int j) {
  return mm_lane(a, i, __shfl_sync(kFull, b, j, kLanes),
                 __shfl_sync(kFull, b, 4 + j, kLanes),
                 __shfl_sync(kFull, b, 8 + j, kLanes),
                 __shfl_sync(kFull, b, 12 + j, kLanes));
}

// ... with b a 4 x 4 constant in shared memory.
__device__ __forceinline__ float mm_const(float a, int i, int j,
                                          const float* b) {
  return mm_lane(a, i, b[j], b[4 + j], b[8 + j], b[12 + j]);
}

// Configuration q's chain, by its 16 lanes (lane e = 4 i + j): the links
// [10, 16] (without the offsets), origins [10, 3] and axes [10, 3], into
// shared memory.
__device__ void chain(const float* tab, const float* q, int e, float* link,
                      float* og, float* ax) {
  const int i = e >> 2, j = e & 3;
  const bool origin = i < 3 && j == 3, axis = i < 3 && j == 2;
  float cq = 0.f, sq = 0.f;
  if (e < kJoints) {
    cq = cosf(q[e]);
    sq = sinf(q[e]);
  }
  float cur = 0.f;
#pragma unroll 1
  for (int k = 0; k < kJoints; ++k) {
    const float c = __shfl_sync(kFull, cq, k, kLanes);
    const float s = __shfl_sync(kFull, sq, k, kLanes);
    const float* P = tab + kPqr + 48 * k;
    const float b = add(add(mul(P[e], c), mul(P[16 + e], s)), P[32 + e]);
    // the joint's frame before Rz(q_k): the rest pose, then cur @ pose_0[k]
    const float pre =
        k == 0 ? tab[kPose0 + e] : mm_const(cur, i, j, tab + kPose0 + 16 * k);
    if (origin) og[3 * k + i] = pre;
    if (axis) ax[3 * k + i] = pre;
    cur = k == 0 ? b : mm_lanes(cur, b, i, j);
    link[16 * k + e] = cur;
  }
  const float hand = mm_const(cur, i, j, tab + kPose0 + 16 * 7);
  link[16 * 7 + e] = hand;
  if (origin) og[3 * 7 + i] = hand;
  if (axis) ax[3 * 7 + i] = 0.f;
  // the fingers: the rest pose shifted by +q7 / -q8 along the hand's y
  // (element (1, 3)), both products side by side
  const float* l8 = tab + kPose0 + 16 * 8;
  const float* l9 = tab + kPose0 + 16 * 9;
  const float a0 = __shfl_sync(kFull, hand, 4 * i, kLanes);
  const float a1 = __shfl_sync(kFull, hand, 4 * i + 1, kLanes);
  const float a2 = __shfl_sync(kFull, hand, 4 * i + 2, kLanes);
  const float a3 = __shfl_sync(kFull, hand, 4 * i + 3, kLanes);
  const float f8 = dot4(a0, a1, a2, a3, l8[j],
                        j == 3 ? add(l8[7], q[7]) : l8[4 + j], l8[8 + j],
                        l8[12 + j]);
  const float f9 = dot4(a0, a1, a2, a3, l9[j],
                        j == 3 ? add(l9[7], -q[8]) : l9[4 + j], l9[8 + j],
                        l9[12 + j]);
  link[16 * 8 + e] = f8;
  link[16 * 9 + e] = f9;
  if (origin) {
    og[3 * 8 + i] = f8;
    og[3 * 9 + i] = f9;
  }
  if (i < 3 && j == 1) {  // the hand's y axis, + for the left finger
    ax[3 * 8 + i] = hand;
    ax[3 * 9 + i] = -hand;
  }
}

__global__ void __launch_bounds__(kThreads)
    panda_fk_kernel(Ptrs A, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int n_tab = kPts + (D.with_points ? kLinks * D.P * 3 : 0);
  float* tab = smem;
  float* link = tab + n_tab;                 // [kCpb, 10, 16]
  float* pose = link + kCpb * kLinks * 16;   // [kCpb, 10, 16]
  float* og = pose + kCpb * kLinks * 16;     // [kCpb, 10, 3]
  float* ax = og + kCpb * kLinks * 3;        // [kCpb, 10, 3]
  const int tid = threadIdx.x;
  for (int k = tid; k < n_tab; k += kThreads) tab[k] = A.tab[k];
  __syncthreads();

  const long long n0 = static_cast<long long>(blockIdx.x) * kCpb;
  const int n_here = D.N - n0 < kCpb ? static_cast<int>(D.N - n0) : kCpb;
  // every lane walks a chain, so each shuffle has its whole warp: the
  // spare configurations of a ragged block repeat the last one and store
  // nothing
  const int c = tid / kLanes;
  const long long n = n0 + (c < n_here ? c : n_here - 1);
  chain(tab, A.q + n * kDof, tid % kLanes, link + c * kLinks * 16,
        og + c * kLinks * 3, ax + c * kLinks * 3);
  __syncthreads();

  // the offsets, one pose element a thread; coalesced stores of the
  // block's poses, origins and axes
  const int n_el = n_here * kLinks * 16;
  float* poses = A.poses + n0 * kLinks * 16;
  for (int k = tid; k < n_el; k += kThreads) {
    float v = link[k];
    if (D.apply_offset) {
      const int el = k & 15, row = k - el + 4 * (el >> 2);
      const float* b = tab + kOffset + 16 * ((k >> 4) % kLinks) + (el & 3);
      v = dot4(link[row], link[row + 1], link[row + 2], link[row + 3], b[0],
               b[4], b[8], b[12]);
    }
    pose[k] = v;
    poses[k] = v;
  }
  const int n_v = n_here * kLinks * 3;
  for (int k = tid; k < n_v; k += kThreads) {
    A.origins[n0 * kLinks * 3 + k] = og[k];
    A.axes[n0 * kLinks * 3 + k] = ax[k];
  }
  if (!D.with_points) return;
  __syncthreads();  // the block's poses are in shared memory

  // the body points, one (configuration, link, point) a thread
  const int per = kLinks * D.P;
  float* x = A.x + n0 * per * 3;
  for (int k = tid; k < n_here * per; k += kThreads) {
    const int cl = k / D.P;  // (configuration, link)
    const float* m = pose + 16 * cl;
    const float* pt = tab + kPts + (k - cl * D.P + (cl % kLinks) * D.P) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* r = m + 4 * a;
      x[3 * k + a] =
          add(add(add(mul(r[0], pt[0]), mul(r[1], pt[1])), mul(r[2], pt[2])),
              r[3]);
    }
  }
}

}  // namespace

// ptrs: the 6 pointers of Ptrs in order; dims: N, P, apply_offset,
// with_points.  Returns the CUDA error of the launch (0 on success).
extern "C" int omg_panda_fk(void* const* ptrs, const int* dims,
                            void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kPtrs; ++i) dst[i] = ptrs[i];
  const Dims D{dims[0], dims[1], dims[2], dims[3]};
  if (D.N <= 0) return 0;
  const int blocks = (D.N + kCpb - 1) / kCpb;
  const size_t smem =
      sizeof(float) * (kPts + (D.with_points ? kLinks * D.P * 3 : 0) + kWork);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        panda_fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(panda_fk_kernel, blocks, kThreads, smem, A, D);
#else
  panda_fk_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}
