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
// (N = T = 30), on every learner sweep (N = G x (n + 2), 544 to 1,700) and
// in the goal-set prune.
//
// What bounds it: bytes, on paper (a configuration writes 10 poses, 20 joint
// vectors and 10 P points, 1.0 KB at P = 15, for ~5,000 flops), and in
// practice the launch itself: the main path's N are small.
//
// Layout: one block of 256 threads per kCpb = 8 configurations (a
// block's latency is its chain walk and then its share of the points, so
// few configurations a block keep many blocks in flight at the plan's
// small N).
//  1. thread c < kCpb walks configuration c's chain in registers with the
//     per-joint constants of models/panda.py::pqr_table,
//     A_i Rz(q_i) C_i = cos q_i P_i + sin q_i Q_i + R_i, and writes each
//     link's pose, origin and axis as it goes;
//  2. after one barrier, all 256 threads write the block's body points,
//     one (configuration, link, point) at a time, from the poses that
//     phase 1 wrote to device memory.
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
#else
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace {

constexpr int kLinks = 10;
constexpr int kJoints = 7;
constexpr int kDof = 9;
constexpr int kCpb = 8;       // configurations a block
constexpr int kThreads = 256;

struct Ptrs {
  const float* q;        // [N, 9]
  const float* pqr;      // [7, 3, 4, 4]: P_i, Q_i, R_i
  const float* pose0;    // [10, 4, 4] rest poses
  const float* offset;   // [10, 4, 4] link frame -> mesh centre
  const float* pts;      // [10, P, 3] body points in the link frame
  float* poses;          // [N, 10, 4, 4]
  float* origins;        // [N, 10, 3]
  float* axes;           // [N, 10, 3]
  float* x;              // [N, 10, P, 3] (with_points)
};

struct Dims {
  int N, P, apply_offset, with_points;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// c = a @ b (row-major 4 x 4), summed as ((a0 b0 + a1 b1) + a2 b2) + a3 b3
__device__ __forceinline__ void mm4(const float* a, const float* b,
                                    float* c) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[4 * i + j] =
          add(add(add(mul(a[4 * i], b[j]), mul(a[4 * i + 1], b[4 + j])),
                  mul(a[4 * i + 2], b[8 + j])),
              mul(a[4 * i + 3], b[12 + j]));
}

__device__ __forceinline__ void copy16(const float* a, float* c) {
#pragma unroll
  for (int e = 0; e < 16; ++e) c[e] = a[e];
}

__device__ __forceinline__ void put3(float* dst, float a, float b, float c) {
  dst[0] = a;
  dst[1] = b;
  dst[2] = c;
}

// Link j's pose, with its mesh-centre offset when asked.
__device__ __forceinline__ void store_link(const Ptrs& A, const Dims& D,
                                           long long n, int j,
                                           const float* link) {
  float* dst = A.poses + (n * kLinks + j) * 16;
  if (D.apply_offset) {
    float out[16];
    mm4(link, A.offset + 16 * j, out);
    copy16(out, dst);
  } else {
    copy16(link, dst);
  }
}

// Origin (translation column) and z axis (third column) of a 4 x 4 frame.
__device__ __forceinline__ void store_joint(const Ptrs& A, long long n, int j,
                                            const float* pre) {
  put3(A.origins + (n * kLinks + j) * 3, pre[3], pre[7], pre[11]);
  put3(A.axes + (n * kLinks + j) * 3, pre[2], pre[6], pre[10]);
}

__device__ void chain(const Ptrs& A, const Dims& D, long long n) {
  const float* q = A.q + n * kDof;
  float cur[16], b[16], t[16];
#pragma unroll 1
  for (int i = 0; i < kJoints; ++i) {
    const float c = cosf(q[i]), s = sinf(q[i]);
    const float* P = A.pqr + 48 * i;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      b[e] = add(add(mul(P[e], c), mul(P[16 + e], s)), P[32 + e]);
    if (i == 0) {
      store_joint(A, n, 0, A.pose0);
      copy16(b, cur);
    } else {
      mm4(cur, A.pose0 + 16 * i, t);  // the joint's frame before Rz(q_i)
      store_joint(A, n, i, t);
      mm4(cur, b, t);
      copy16(t, cur);
    }
    store_link(A, D, n, i, cur);
  }
  float hand[16];
  mm4(cur, A.pose0 + 16 * 7, hand);
  store_link(A, D, n, 7, hand);
  put3(A.origins + (n * kLinks + 7) * 3, hand[3], hand[7], hand[11]);
  put3(A.axes + (n * kLinks + 7) * 3, 0.f, 0.f, 0.f);
  // the fingers: the rest pose shifted by +q7 / -q8 along the hand's y
#pragma unroll 1
  for (int f = 0; f < 2; ++f) {
    copy16(A.pose0 + 16 * (8 + f), b);
    b[7] = add(b[7], f == 0 ? q[7] : -q[8]);
    mm4(hand, b, t);
    store_link(A, D, n, 8 + f, t);
    put3(A.origins + (n * kLinks + 8 + f) * 3, t[3], t[7], t[11]);
    const float sg = f == 0 ? 1.f : -1.f;
    put3(A.axes + (n * kLinks + 8 + f) * 3, sg * hand[1], sg * hand[5],
         sg * hand[9]);
  }
}

__global__ void __launch_bounds__(kThreads)
    panda_fk_kernel(Ptrs A, Dims D) {
  const long long n0 = static_cast<long long>(blockIdx.x) * kCpb;
  const int tid = threadIdx.x;
  if (tid < kCpb && n0 + tid < D.N) chain(A, D, n0 + tid);
  if (!D.with_points) return;
  __syncthreads();  // the block's poses are in device memory
  const int per = kLinks * D.P;
  const int n_here = D.N - n0 < kCpb ? static_cast<int>(D.N - n0) : kCpb;
  for (int k = tid; k < n_here * per; k += kThreads) {
    const long long n = n0 + k / per;
    const int j = (k % per) / D.P, p = k % D.P;
    const float* m = A.poses + (n * kLinks + j) * 16;
    const float* pt = A.pts + (j * D.P + p) * 3;
    float* dst = A.x + ((n * kLinks + j) * D.P + p) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      dst[a] = add(add(add(mul(m[4 * a], pt[0]), mul(m[4 * a + 1], pt[1])),
                       mul(m[4 * a + 2], pt[2])),
                   m[4 * a + 3]);
  }
}

}  // namespace

// ptrs: the 9 pointers of Ptrs in order; dims: N, P, apply_offset,
// with_points.  Returns the CUDA error of the launch (0 on success).
extern "C" int omg_panda_fk(void* const* ptrs, const int* dims,
                            void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < 9; ++i) dst[i] = ptrs[i];
  const Dims D{dims[0], dims[1], dims[2], dims[3]};
  if (D.N <= 0) return 0;
  const int blocks = (D.N + kCpb - 1) / kCpb;
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(panda_fk_kernel, blocks, kThreads, 0, A, D);
#else
  panda_fk_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}
