// Nearest-point distance grid for the perception-mode SDF, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel omg_planner_tpu/ops/pallas_kernels.py
// (min_dist_grid, body _min_dist_kernel, pallas_call at :92): for every
// grid cell g of grid [G, 3], out[g] = min over points p of points [N, 3]
// of |g - p|.  N = 0 gives +inf, as the XLA oracle does.
//
// Bound on an H100 SXM: fp32 issue on the CUDA cores.  The perception grid
// of synthetic scene 0 (G = 413,820 cells, N = 1,035 points) is 4.28e8
// (cell, point) pairs against ~6.6 MB of traffic (0.002 ms at 3.35 TB/s).
// At four issue slots a pair and 128 slots a clock on each of 132 SMs at
// 1.98 GHz the pairs take 0.0511 ms: 8 flop-equivalents a pair over
// 67 TFLOP/s.
//
// Form: the TPU kernel's expansion |g - p|^2 = |g'|^2 + (|p'|^2 - 2 g'.p')
// with g' = g - c and p' = p - c.  Each block packs every point once as
// q = (-2 p', |p'|^2) in shared memory, and a pair is then three FFMA,
//   t = fma(g'z, q.z, fma(g'y, q.y, fma(g'x, q.x, q.w))),
// and one FMNMX: four slots, where the direct form (g - p).(g - p) takes
// seven (three FADD, one FMUL, two FFMA, one FMNMX).  |g'|^2 is added once
// per cell after the minimum: out = sqrt(max(min_p t + |g'|^2, 0)).  The
// expansion cancels near d = 0, by up to about sqrt(eps |g'|^2), so the
// centre c is the midpoint of the bounding box of the block's own cells:
// |g'| is the block's extent, not the grid's.  Measured on an H100
// (chip_smoke.py): 3.2e-6 m from the float64 direct form on 20,000 sampled
// cells of the main shape; the d = 0 worst case is in PERF.md.
//
// Layout: each thread owns kCells = 8 cells in registers, so one broadcast
// LDS.128 of q feeds 32 FFMA/FMNMX slots, and eight independent chains hide
// the FFMA latency.  The 32 x kCells cells of a warp are a unit.  The launch
// has at most one block per SM, so the whole grid is resident at once (no
// second wave), and splits the units evenly over the blocks: no SM holds
// more than one unit above another.  Inside a block, each round of up to
// kWarps units is split over the warps by (unit, point) pairs, so every
// warp, and with it each of the SM's four schedulers, sweeps the same
// number of pairs; a unit that two warps share combines their minima with
// a shared-memory atomicMin.  kWarps = 20, five warps per scheduler, hides
// the LDS latency at the top of the point loop and the register-bank stalls
// of the FFMA chains better than four or six did on the H100.  The whole
// cloud is staged once in dynamic shared memory when it fits
// (N <= kTilePoints, the observed cloud's cap); a tile loop keeps any larger
// N correct.  Ragged ends are masked: no sentinel padding.
//
// Not used:
// * Tensor cores.  The depth is 3 (5 with |g|^2 and |p|^2 folded in),
//   padded to 8.  TF32 keeps ~1e-3 relative on d^2 of order 1, which is
//   cm-scale at d ~ 0.  3xTF32 costs three MMAs a tile (a bound of
//   ~0.041 ms at 495 TFLOP/s) and still leaves one FMNMX a pair on the
//   CUDA cores at half the FFMA rate: at most ~20% under this kernel's
//   bound, for much more code and a d ~ 0 error near the 1e-3 m bar.
// * TMA and cp.async.  Staging reads ~12 KB per block from L2 and
//   transforms it on the way in: under 1% of the kernel's time.
// * Spatial culling of point tiles.  Same output, but it changes the work
//   that the bound counts.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kCells = 8;             // cells per thread
constexpr int kWarps = 20;            // warps per block: 5 per scheduler
constexpr int kThreads = 32 * kWarps;
constexpr int kUnit = 32 * kCells;    // cells per warp unit
constexpr int kTilePoints = 3072;     // points staged at once: 48 KB
constexpr int kInfBits = 0x7f800000;  // +inf as an int

// Dynamic shared memory: kWarps * kUnit minima of d^2 (as int bits, which
// order like the floats since they are >= 0), then the staged points.
size_t smem_bytes(int N) {
  return sizeof(int) * kWarps * kUnit +
         sizeof(float4) * std::min(N, kTilePoints);
}

// One warp's sweep of its kCells cells per lane, cell0 + k * 32, against
// the staged points q[0, n); folds min d^2 into bits[k * 32].
__device__ __forceinline__ void sweep(const float* __restrict__ grid, int G,
                                      int cell0, float cx, float cy,
                                      float cz, const float4* q, int n,
                                      int* bits) {
  float gx[kCells], gy[kCells], gz[kCells], best[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const long long g = cell0 + k * 32;
    const bool ok = g < G;
    gx[k] = ok ? grid[3 * g + 0] - cx : 0.f;
    gy[k] = ok ? grid[3 * g + 1] - cy : 0.f;
    gz[k] = ok ? grid[3 * g + 2] - cz : 0.f;
    best[k] = INFINITY;
  }
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p = q[j];
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      best[k] = fminf(best[k],
                      fmaf(gz[k], p.z, fmaf(gy[k], p.y, fmaf(gx[k], p.x, p.w))));
  }
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    if (cell0 + k * 32 < G) {
      const float g2 = fmaf(gx[k], gx[k], fmaf(gy[k], gy[k], gz[k] * gz[k]));
      atomicMin(bits + k * 32, __float_as_int(fmaxf(best[k] + g2, 0.f)));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
min_dist_grid_kernel(const float* __restrict__ grid,
                     const float* __restrict__ pts,
                     float* __restrict__ out, int G, int N) {
  extern __shared__ float4 smem[];
  int* const bits = reinterpret_cast<int*>(smem);
  float4* const tile = smem + kWarps * kUnit / 4;
  __shared__ float red[kWarps][6];
  __shared__ float centre[3];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this block's units [u_begin, u_end): an even split over the blocks
  const int units = (G + kUnit - 1) / kUnit;
  const int u_begin = static_cast<long long>(blockIdx.x) * units / gridDim.x;
  const int u_end =
      static_cast<long long>(blockIdx.x + 1) * units / gridDim.x;
  const int cell_end = min(G, u_end * kUnit);

  // centre c: midpoint of the bounding box of the block's cells
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int g = u_begin * kUnit + threadIdx.x; g < cell_end; g += kThreads) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = grid[3LL * g + d];
      lo[d] = fminf(lo[d], v);
      hi[d] = fmaxf(hi[d], v);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    for (int off = 16; off > 0; off /= 2) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], off));
    }
    if (lane == 0) {
      red[warp][d] = lo[d];
      red[warp][3 + d] = hi[d];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float a = INFINITY, b = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      a = fminf(a, red[w][threadIdx.x]);
      b = fmaxf(b, red[w][3 + threadIdx.x]);
    }
    centre[threadIdx.x] = 0.5f * (a + b);
  }
  __syncthreads();
  const float cx = centre[0], cy = centre[1], cz = centre[2];

  int staged = -1;  // first point of the tile in shared memory
  for (int r0 = u_begin; r0 < u_end; r0 += kWarps) {
    const int n_units = min(kWarps, u_end - r0);
    for (int i = threadIdx.x; i < n_units * kUnit; i += kThreads)
      bits[i] = kInfBits;
    __syncthreads();
    // this warp's share of the round's (unit, point) pairs, u * N + p
    const long long pairs = static_cast<long long>(n_units) * N;
    const long long seg_begin = pairs * warp / kWarps;
    const long long seg_end = pairs * (warp + 1) / kWarps;
    for (int t0 = 0; t0 < N; t0 += kTilePoints) {
      const int tn = min(kTilePoints, N - t0);
      if (t0 != staged) {
        __syncthreads();  // no warp still reads the previous tile
        for (int i = threadIdx.x; i < tn; i += kThreads) {
          const float* p = pts + 3LL * (t0 + i);
          const float x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
          tile[i] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                                fmaf(x, x, fmaf(y, y, z * z)));
        }
        __syncthreads();
        staged = t0;
      }
      // pieces of the segment: unit u, points [p, pe), clipped to the tile
      for (long long s = seg_begin; s < seg_end;) {
        const int u = static_cast<int>(s / N);
        const int p = static_cast<int>(s - static_cast<long long>(u) * N);
        const long long left = seg_end - s;
        const int pe = left < N - p ? p + static_cast<int>(left) : N;
        const int a = max(p, t0), b = min(pe, t0 + tn);
        if (a < b)
          sweep(grid, G, (r0 + u) * kUnit + lane, cx, cy, cz,
                tile + (a - t0), b - a, bits + u * kUnit + lane);
        s += pe - p;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_units * kUnit; i += kThreads) {
      const int g = r0 * kUnit + i;
      if (g < G) out[g] = sqrtf(__int_as_float(bits[i]));
    }
    __syncthreads();  // before the next round resets bits
  }
}

struct Layout {
  int blocks, blocks_per_sm, sms, units;
  size_t smem;
};

// The launch for G cells and N points on the current device.  The SM count
// is read, and the shared-memory limit raised, once per device.
cudaError_t layout(int G, int N, Layout* l) {
  static int cached_dev = -1, cached_sms = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev) {
    e = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(min_dist_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kTilePoints)));
    if (e != cudaSuccess) return e;
    cached_dev = dev;
  }
  l->sms = cached_sms;
  l->smem = smem_bytes(std::max(N, 0));
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &l->blocks_per_sm, min_dist_grid_kernel, kThreads, l->smem);
  if (e != cudaSuccess) return e;
  if (l->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  l->units = (std::max(G, 0) + kUnit - 1) / kUnit;
  l->blocks = std::min(l->units, l->sms);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` (a cudaStream_t); returns the first CUDA error of
// the set-up or cudaGetLastError() after the launch.
extern "C" int omg_min_dist_grid(const float* grid, const float* pts,
                                 float* out, int G, int N, void* stream) {
  if (G <= 0) return static_cast<int>(cudaGetLastError());
  Layout l;
  const cudaError_t e = layout(G, N, &l);
  if (e != cudaSuccess) return static_cast<int>(e);
  min_dist_grid_kernel<<<l.blocks, kThreads, l.smem,
                         static_cast<cudaStream_t>(stream)>>>(grid, pts, out,
                                                              G, N);
  return static_cast<int>(cudaGetLastError());
}

// The launch omg_min_dist_grid makes for G cells and N points on the
// current device, into info[7]: blocks, threads per block, dynamic shared
// memory bytes, resident blocks per SM, SMs, warp units, cells per unit.
extern "C" int omg_min_dist_grid_layout(int G, int N, int* info) {
  Layout l;
  const cudaError_t e = layout(G, N, &l);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = l.blocks;
  info[1] = kThreads;
  info[2] = static_cast<int>(l.smem);
  info[3] = l.blocks_per_sm;
  info[4] = l.sms;
  info[5] = l.units;
  info[6] = kUnit;
  return 0;
}
