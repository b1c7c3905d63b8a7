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
// (16 K flops a pass): the latency of each pass's dependent chain (a
// block reduction, a length-T dot product, the update), and of the
// launch.  The design keeps every pass of the loop in one launch with no
// host read, and keeps the first check off Ainv's load.
//
// Layout: one block a row, one thread a (t, d) element (270 of 288
// threads at T = 30, D = 9), its value, its (t, d) and its limits in
// registers; a thread loops over several elements where T D exceeds 1,024,
// the further ones in shared memory.  The block starts Ainv's copy into
// shared memory (cp.async, 16 bytes a copy where Ainv's address allows
// it) and, while it runs, loads the trajectory and forms the first
// violation; it waits for the copy only when a pass starts, so a row that
// makes no pass never waits on it (the block waits for its own copies
// only before it ends; the copy reads Ainv on every live row).  The
// violation's check is one block reduction that carries the squared norm,
// the largest |tv| and its first flat index together (a butterfly for the
// sum, warp-wide max and min for the index, the warps' partials behind one
// barrier); every thread then combines the partials in the same order, so
// the loop condition is uniform over the block.  A pass: each thread forms
// its element's tvs = (Ainv @ tv)[t, d] (a length-T dot product in k
// order, loads unrolled ahead of the sums); the thread that owns the
// argmax publishes its tvs in shared memory, and after a second barrier
// every thread takes the scale from it, updates its elements and forms
// the next violation.  tv and the partials are double-buffered in shared
// memory, so a pass's writes cannot race the previous pass's reads.  A
// row whose live flag is false copies its trajectory out.
//
// Arithmetic: fp32, no fast math; every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: never contracted into an FMA), so the card
// and the g++ build give the same bits, and a row's result depends on
// nothing but its own inputs.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// a reduction buffer: the warps' squared sums, largest |tv| and its index
constexpr int kRed = 3 * kMaxWarps;

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

constexpr unsigned kNone = 0xffffffffu;  // no index

// (Ainv @ tv)[t, d] = sum_j a[j] tv[j, d], a = Ainv's row t, in j order
__device__ __forceinline__ float dot(const float* a, const float* tv, int d,
                                     int T, int D) {
  float s = mul(a[0], tv[d]);
#pragma unroll 6
  for (int j = 1; j < T; ++j) s = add(s, mul(a[j], tv[j * D + d]));
  return s;
}

// r[0] + r[1] + ... + r[nw - 1], in that order, the loads formed ahead
__device__ __forceinline__ float sum_partials(const float* r, int nw) {
  constexpr int kChunk = 8;
  float s = r[0];
  for (int w0 = 1; w0 < nw; w0 += kChunk) {
    float p[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (w0 + u < nw) p[u] = r[w0 + u];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (w0 + u < nw) s = add(s, p[u]);
  }
  return s;
}

__global__ void joint_limit_kernel(Ptrs A, Dims D) {
  OMG_DYNAMIC_SMEM(smem);
  const int T = D.T, Dd = D.D, n = D.T * D.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const size_t row = blockIdx.x;
  const float* xi = A.xi + row * n;
  float* out = A.out + row * n;
  if (A.live != nullptr && !A.live[blockIdx.x]) {
    for (int k = tid; k < n; k += nt) out[k] = xi[k];
    return;
  }
  float* ainv = smem;            // [T, T] (16-byte aligned)
  float* x = ainv + T * T;       // [T, D]: a thread's elements past its first
  float* tv = x + n;             // [2][T, D]
  float* lo = tv + 2 * n;        // [D]
  float* hi = lo + Dd;           // [D]
  float* red = hi + Dd;          // [2][kRed]
  float* at_tvs = red + 2 * kRed;  // tvs at the argmax

  // the thread's first element k = tid in registers (its (t, d), its
  // value, its limits); any further ones (T D > 1,024) in shared memory
  const bool has0 = tid < n;
  const int k0 = has0 ? tid : n - 1;
  const int t0 = k0 / Dd, d0 = k0 - t0 * Dd;
  float x0 = has0 ? xi[tid] : 0.f;
  for (int k = tid + nt; k < n; k += nt) x[k] = xi[k];
  for (int k = tid; k < Dd; k += nt) {
    lo[k] = A.lower[row * Dd + k];
    hi[k] = A.upper[row * Dd + k];
  }
  // Ainv's copy, in flight while the first violation is formed
  const int tt = T * T;
  const int t4 = (reinterpret_cast<uintptr_t>(A.ainv) & 15) == 0 ? tt / 4 : 0;
  for (int k = tid; k < t4; k += nt)
    __pipeline_memcpy_async(ainv + 4 * k, A.ainv + 4 * k, 16);
  for (int k = 4 * t4 + tid; k < tt; k += nt)
    __pipeline_memcpy_async(ainv + k, A.ainv + k, 4);
  __pipeline_commit();
  __syncthreads();  // the limits
  const float lo0 = lo[d0], hi0 = hi[d0];

  // tv = (lower - x) (x < lower) + (upper - x) (x > upper) into buffer b;
  // the block's sum of tv^2 (each thread's elements in k order, a
  // butterfly in the warp, the warps in order), max |tv| and its first
  // flat index (the largest bits of |tv|, then the smallest index among
  // them: warp-wide max and min), the same in every thread
  float sq, top;
  unsigned at;
  auto violation = [&](int b) {
    float* t = tv + b * n;
    float acc = 0.f;
    unsigned vb = 0u, vi = kNone;
    auto element = [&](int k, float l, float h, float xv) {
      const float v = xv < l ? add(l, -xv) : (xv > h ? add(h, -xv) : 0.f);
      t[k] = v;
      acc = add(acc, mul(v, v));
      const unsigned bits = __float_as_uint(fabsf(v));
      if (bits > vb || vi == kNone) {
        vb = bits;
        vi = static_cast<unsigned>(k);
      }
    };
    if (has0) element(tid, lo0, hi0, x0);
    for (int k = tid + nt; k < n; k += nt)
      element(k, lo[k % Dd], hi[k % Dd], x[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = add(acc, __shfl_xor_sync(kFull, acc, o));
    const unsigned wb = __reduce_max_sync(kFull, vb);
    const unsigned wi = __reduce_min_sync(kFull, vb == wb ? vi : kNone);
    float* r = red + b * kRed;
    unsigned* rb = reinterpret_cast<unsigned*>(r + kMaxWarps);
    unsigned* ri = rb + kMaxWarps;
    if (lane == 0) {
      r[warp] = acc;
      rb[warp] = wb;
      ri[warp] = wi;
    }
    __syncthreads();
    sq = sum_partials(r, nw);
    const unsigned pb = lane < nw ? rb[lane] : 0u;
    const unsigned mb = __reduce_max_sync(kFull, pb);
    at = __reduce_min_sync(kFull, lane < nw && pb == mb ? ri[lane] : kNone);
    top = __uint_as_float(mb);
  };

  int b = 0;
  violation(b);
  for (int cnt = 0; cnt < D.max_steps && sqrtf(sq) > 1e-2f; ++cnt) {
    if (cnt == 0) {  // Ainv, every thread's part of it
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    // tvs = Ainv @ tv at the thread's first element (a thread without one
    // repeats the last element's, so that no warp diverges) and at the
    // argmax; then the further elements'
    const float* t = tv + b * n;
    const int ib = static_cast<int>(at);
    const float s0 = dot(ainv + t0 * T, t, d0, T, Dd);
    if (ib == tid) {
      *at_tvs = s0;
    } else if (ib >= nt && ib % nt == tid) {
      const int tb = ib / Dd;
      *at_tvs = dot(ainv + tb * T, t, ib - tb * Dd, T, Dd);
    }
    __syncthreads();
    const float sb = *at_tvs;
    const float scale = top / add(fabsf(sb), 1e-8f);
    if (has0) x0 = add(x0, mul(scale, s0));
    for (int k = tid + nt; k < n; k += nt) {
      const int tk = k / Dd;
      x[k] = add(x[k], mul(scale, dot(ainv + tk * T, t, k - tk * Dd, T, Dd)));
    }
    b ^= 1;
    violation(b);
  }
  if (has0) out[tid] = x0;
  for (int k = tid + nt; k < n; k += nt) out[k] = x[k];
  __pipeline_wait_prior(0);  // no copy outlives the block
}

}  // namespace

// Threads a block takes for T D elements: one an element, in whole warps,
// at most 1,024.
static int joint_limit_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Shared memory a block needs for a T x D trajectory, in bytes.
static size_t joint_limit_smem(int T, int D) {
  return sizeof(float) * (static_cast<size_t>(T) * T +
                          3 * static_cast<size_t>(T) * D + 2 * D + 2 * kRed +
                          4);
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
  const size_t smem = joint_limit_smem(D.T, D.D);
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
