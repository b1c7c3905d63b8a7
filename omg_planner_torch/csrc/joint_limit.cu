// The CHOMP step's smoothed joint-limit projection, for Hopper (sm_90a).
//
// Computes ops/kernels.py::joint_limit_plain for S rows (scenes) at once:
// while the trajectory's violation of the joint limits has a norm above
// 1e-2, at most max_steps times, add scale * Ainv @ tv, where tv [T, D] is
// the violation and scale = max|tv| / (|tvs.flat[argmax |tv|]| + 1e-8),
// argmax over the row-major flattened [T, D], first index on ties.  It
// has no Pallas counterpart: the JAX package leaves the loop to XLA, which
// keeps it on the device (omg_planner_tpu/ops/chomp.py handle_joint_limit,
// a lax.while_loop).  In eager PyTorch the loop is a dozen operations and
// one host read a pass.
//
// What bounds it: neither bytes (a row reads its trajectory, the limits
// and Ainv, 5.0 KB at T = 30, D = 9, and writes 1.1 KB) nor operations
// (16 K flops a pass): the latency of each pass's dependent chain (two
// block reductions, a length-T dot product, the update), and of the
// launch.  The design keeps every pass of the loop in one launch with no
// host read.
//
// Layout: one block a row, one thread a (t, d) element (270 of 288
// threads at T = 30, D = 9; a thread loops over several elements where T D
// exceeds 1,024).  Ainv, the trajectory, tv and tvs live in shared memory.
// Each pass: a block reduction for the first-index argmax of |tv|, one
// dot product of length T a thread for tvs (summed in k order), the
// update, then the new violation and a block reduction for its squared
// norm.  The loop condition is uniform over the block (every thread sums
// the warps' partial sums in the same order).  A row whose live flag is
// false keeps its trajectory.
//
// Arithmetic: fp32, no fast math; every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an FMA), so the card
// and the g++ build give the same bits, and a row's result depends on
// nothing but its own inputs.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Ptrs {
  const float* xi;            // [S, T, D]
  const float* lower;         // [S, D]
  const float* upper;         // [S, D]
  const float* ainv;          // [T, T]
  const unsigned char* live;  // [S] bool, or null: every row live
  float* out;                 // [S, T, D]
};
constexpr int kPtrs = 6;

struct Dims {
  int S, T, D, max_steps;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// (value, index) pairs: the larger value wins, the smaller index on ties
__device__ __forceinline__ void better(float& v, float& i, float ov,
                                       float oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void joint_limit_kernel(Ptrs A, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int T = D.T, n = D.T * D.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const size_t row = blockIdx.x;
  float* ainv = smem;            // [T, T]
  float* x = ainv + T * T;       // [T, D]
  float* tv = x + n;             // [T, D]
  float* tvs = tv + n;           // [T, D]
  float* lo = tvs + n;           // [D]
  float* hi = lo + D.D;          // [D]
  float* red_sum = hi + D.D;     // [warps]
  float* red_v = red_sum + kMaxWarps;
  float* red_i = red_v + kMaxWarps;

  for (int k = tid; k < T * T; k += nt) ainv[k] = A.ainv[k];
  for (int k = tid; k < n; k += nt) x[k] = A.xi[row * n + k];
  for (int k = tid; k < D.D; k += nt) {
    lo[k] = A.lower[row * D.D + k];
    hi[k] = A.upper[row * D.D + k];
  }
  __syncthreads();

  // tv = (lower - xi) (xi < lower) + (upper - xi) (xi > upper), and its
  // norm, the same in every thread
  auto violation_norm = [&]() {
    float acc = 0.f;
    for (int k = tid; k < n; k += nt) {
      const int d = k % D.D;
      const float xv = x[k];
      const float v = xv < lo[d] ? add(lo[d], -xv)
                                 : (xv > hi[d] ? add(hi[d], -xv) : 0.f);
      tv[k] = v;
      acc = add(acc, mul(v, v));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = add(acc, __shfl_xor_sync(kFull, acc, o));
    if (lane == 0) red_sum[warp] = acc;
    __syncthreads();
    float s = red_sum[0];
    for (int w = 1; w < nw; ++w) s = add(s, red_sum[w]);
    return sqrtf(s);
  };

  const bool live = A.live == nullptr || A.live[blockIdx.x];
  float norm = violation_norm();
  for (int cnt = 0; live && cnt < D.max_steps && norm > 1e-2f; ++cnt) {
    // max |tv| and its first flat index
    float bv = -1.f, bi = static_cast<float>(n);
    for (int k = tid; k < n; k += nt) better(bv, bi, fabsf(tv[k]), k);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const float oi = __shfl_xor_sync(kFull, bi, o);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    // tvs = Ainv @ tv, one element a thread, summed in k order
    for (int k = tid; k < n; k += nt) {
      const int t = k / D.D, d = k - t * D.D;
      const float* a = ainv + t * T;
      float s = mul(a[0], tv[d]);
      for (int j = 1; j < T; ++j) s = add(s, mul(a[j], tv[j * D.D + d]));
      tvs[k] = s;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
    for (int w = 1; w < nw; ++w) better(bv, bi, red_v[w], red_i[w]);
    const float scale = bv / add(fabsf(tvs[static_cast<int>(bi)]), 1e-8f);
    for (int k = tid; k < n; k += nt) x[k] = add(x[k], mul(scale, tvs[k]));
    norm = violation_norm();
  }
  for (int k = tid; k < n; k += nt) A.out[row * n + k] = x[k];
}

}  // namespace

// Threads a block takes for T D elements: one an element, in whole warps,
// at most 1,024.
static int joint_limit_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// ptrs: the 6 pointers of Ptrs in order; dims: S, T, D, max_steps.
// Returns the CUDA error of the launch (0 on success).
extern "C" int omg_joint_limit(void* const* ptrs, const int* dims,
                               void* stream) {
  Ptrs A;
  void** dst = reinterpret_cast<void**>(&A);
  for (int i = 0; i < kPtrs; ++i) dst[i] = ptrs[i];
  const Dims D{dims[0], dims[1], dims[2], dims[3]};
  if (D.S <= 0 || D.T * D.D <= 0) return 0;
  const int threads = joint_limit_threads(D.T * D.D);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(D.T) * D.T +
                       3 * static_cast<size_t>(D.T) * D.D + 2 * D.D +
                       3 * kMaxWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        joint_limit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#ifdef OMG_CUDA_EMU
  (void)stream;
  emu::launch(joint_limit_kernel, D.S, threads, smem, A, D);
#else
  joint_limit_kernel<<<D.S, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(A, D);
#endif
  return static_cast<int>(cudaGetLastError());
}
