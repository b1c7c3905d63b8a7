// Nearest-point distance grid for the perception-mode SDF, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel omg_planner_tpu/ops/pallas_kernels.py
// (min_dist_grid, body _min_dist_kernel): for every grid cell g of
// grid [G, 3], out[g] = min over points p of points [N, 3] of |g - p|.
//
// What bounds it on an H100: fp32 arithmetic on the CUDA cores.  Each
// (cell, point) pair costs 3 subtractions, 3 multiply-adds (contracted
// to one FMUL and two FFMA) and one min; memory traffic is only
// 12 (G + N) + 4 G bytes.  At the perception grid of scene 0
// (G = 413,820 cells, N = 1,035 points) that is ~4.3e8 pairs, ~3.4e9
// flops, against ~6.6 MB of traffic.
//
// Design: one thread owns kCellsPerThread cells and keeps their running
// minima of squared distance in registers; each block stages tiles of
// kTile points as float4 in shared memory and every thread sweeps the
// tile (all threads of a warp read the same point: a broadcast).  The
// ragged ends are masked: cells past G are neither loaded nor written,
// and the last tile holds only the points that remain, so no sentinel
// padding is needed.  The squared distance is the direct form
// (g - p) . (g - p), not the TPU kernel's |g|^2 + |p|^2 - 2 g.p
// expansion: at depth 3 it costs the same, and it does not cancel
// catastrophically near d = 0.  Tensor cores are not used: a wgmma or
// TF32 product would pad the depth from 3 to 8 and drop the fp32
// accuracy the field needs.  N = 0 gives +inf, as the XLA oracle does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 2;
constexpr int kTile = 2048;  // 32 KB of float4 per block

__global__ void __launch_bounds__(kThreads)
min_dist_grid_kernel(const float* __restrict__ grid,
                     const float* __restrict__ pts,
                     float* __restrict__ out, int G, int N) {
  __shared__ float4 tile[kTile];

  const long long base = static_cast<long long>(blockIdx.x) * kThreads *
                         kCellsPerThread;
  float gx[kCellsPerThread], gy[kCellsPerThread], gz[kCellsPerThread];
  float best[kCellsPerThread];
#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    const long long g = base + c * kThreads + threadIdx.x;
    const bool ok = g < G;
    gx[c] = ok ? grid[3 * g + 0] : 0.f;
    gy[c] = ok ? grid[3 * g + 1] : 0.f;
    gz[c] = ok ? grid[3 * g + 2] : 0.f;
    best[c] = INFINITY;
  }

  for (int start = 0; start < N; start += kTile) {
    const int n = min(kTile, N - start);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* p = pts + 3LL * (start + i);
      tile[i] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
#pragma unroll
      for (int c = 0; c < kCellsPerThread; ++c) {
        const float dx = gx[c] - p.x;
        const float dy = gy[c] - p.y;
        const float dz = gz[c] - p.z;
        best[c] = fminf(best[c], dx * dx + dy * dy + dz * dz);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kCellsPerThread; ++c) {
    const long long g = base + c * kThreads + threadIdx.x;
    if (g < G) out[g] = sqrtf(fmaxf(best[c], 0.f));
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t); returns cudaGetLastError().
extern "C" int omg_min_dist_grid(const float* grid, const float* pts,
                                 float* out, int G, int N, void* stream) {
  if (G <= 0) return static_cast<int>(cudaGetLastError());
  const int per_block = kThreads * kCellsPerThread;
  const int blocks = (G + per_block - 1) / per_block;
  min_dist_grid_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(grid, pts, out,
                                                              G, N);
  return static_cast<int>(cudaGetLastError());
}
