// One point's signed distance and gradient against one object, shared by
// the kernels that query the scene: rigid_rollout.cu (contacts of the
// rollout) and sdf_query.cu (the planner's collision query).
//
// * analytic_sdf_grad: a box, sphere or cylinder, edge-rounded, with the
//   inside penalty (ops/sdf.py::_analytic_sdf_grad);
// * grid_sdf_grad: a 4-channel (value, gradient) trilinear read of a baked
//   grid, (1, 0) outside its volume (ops/sdf.py::_query_baked).
//
// Both take the point in the object's frame and return the distance and
// the object-frame gradient.  fp32, no fast math.  The small 3-vector type
// V3 and its operators live here too.  Under -DOMG_CUDA_EMU the file
// compiles with g++ against cuda_emu.h (the kernels' CPU tests).
#pragma once

#ifdef OMG_CUDA_EMU
#include "cuda_emu.h"
#else
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return {x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 unit(V3 a) {
  return (1.f / fmaxf(norm(a), 1e-9f)) * a;
}
__device__ __forceinline__ V3 load3(const float* p) {
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

struct SdfG {  // a signed distance and its gradient
  float d;
  V3 g;
};

// Penalised analytic SDF and its object-frame gradient at p
// (ops/sdf.py::_analytic_sdf_grad for one point).  Not inlined, as the grid
// read below: one copy serves every call site of a kernel (the rollout's
// three contact pools), which keeps the code of its loop small.
__device__ __noinline__ SdfG analytic_sdf_grad(int kind, V3 half,
                                                  float penal, float round,
                                                  V3 p) {
  const float tiny = 1e-12f;
  const float rr = fminf(round, 0.45f * fminf(half.x, fminf(half.y, half.z)));
  const V3 hb = v3(half.x - rr, half.y - rr, half.z - rr);
  const V3 sp = v3(sgn(p.x), sgn(p.y), sgn(p.z));
  const V3 q = v3(fabsf(p.x) - hb.x, fabsf(p.y) - hb.y, fabsf(p.z) - hb.z);
  float d;
  V3 grad;
  if (kind == 0) {
    const V3 qp = v3(fmaxf(q.x, 0.f), fmaxf(q.y, 0.f), fmaxf(q.z, 0.f));
    const float l_out = sqrtf(qp.x * qp.x + qp.y * qp.y + qp.z * qp.z);
    const float qmax = fmaxf(q.x, fmaxf(q.y, q.z));
    d = l_out + fminf(qmax, 0.f);
    if (l_out > 0.f) {
      const float s = fmaxf(l_out, tiny);
      grad = v3(sp.x * qp.x / s, sp.y * qp.y / s, sp.z * qp.z / s);
    } else {
      const float mx = q.x == qmax ? 1.f : 0.f, my = q.y == qmax ? 1.f : 0.f,
                  mz = q.z == qmax ? 1.f : 0.f;
      const float cnt = fmaxf(mx + my + mz, 1.f);
      grad = v3(sp.x * (mx / cnt), sp.y * (my / cnt), sp.z * (mz / cnt));
    }
  } else if (kind == 1) {
    const float pn = sqrtf(p.x * p.x + p.y * p.y + p.z * p.z);
    d = pn - hb.x;
    const float s = fmaxf(pn, tiny);
    grad = v3(p.x / s, p.y / s, p.z / s);
  } else {
    const float rho = sqrtf(p.x * p.x + p.y * p.y);
    const float dr = rho - hb.x;
    const float a = fmaxf(dr, 0.f), b = fmaxf(q.z, 0.f);
    const float l = sqrtf(a * a + b * b);
    d = l + fminf(fmaxf(dr, q.z), 0.f);
    const float rs = fmaxf(rho, tiny);
    const float erx = p.x / rs, ery = p.y / rs;
    if (l > 0.f) {
      const float ls = fmaxf(l, tiny);
      const float al = a / ls;
      grad = v3(al * erx, al * ery, (b / ls) * sp.z);
    } else if (dr >= q.z) {
      grad = v3(erx, ery, 0.f);
    } else {
      grad = v3(0.f, 0.f, sp.z);
    }
  }
  d = d - rr;
  const float scale = d < 0.f ? penal : 1.f;
  return {d * scale, scale * grad};
}

// 4-channel trilinear read of a flat baked grid (value + gradient), out of
// volume (1, 0): ops/sdf.py::_query_one_object_baked of the JAX package.
__device__ __noinline__ SdfG grid_sdf_grad(const float4* g4,
                                              const float* lim, V3 p) {
  const int d0 = static_cast<int>(lim[6]), d1 = static_cast<int>(lim[7]),
            d2 = static_cast<int>(lim[8]);
  const float px = (p.x - lim[0]) / (lim[3] - lim[0]) * static_cast<float>(d0);
  const float py = (p.y - lim[1]) / (lim[4] - lim[1]) * static_cast<float>(d1);
  const float pz = (p.z - lim[2]) / (lim[5] - lim[2]) * static_cast<float>(d2);
  const float ax = px - 0.5f, ay = py - 0.5f, az = pz - 0.5f;
  const int x0 = static_cast<int>(truncf(ax)), y0 = static_cast<int>(truncf(ay)),
            z0 = static_cast<int>(truncf(az));
  const float fx = ax - static_cast<float>(x0),
              fy = ay - static_cast<float>(y0),
              fz = az - static_cast<float>(z0);
  const bool inb = x0 >= 0 && x0 + 1 < d0 && y0 >= 0 && y0 + 1 < d1 &&
                   z0 >= 0 && z0 + 1 < d2;
  if (!inb) return {1.f, v3(0.f, 0.f, 0.f)};
  const long long base =
      (static_cast<long long>(x0) * d1 + y0) * d2 + z0;
  auto val = [&](int dx, int dy, int dz) {
    return g4[base + (static_cast<long long>(dx) * d1 + dy) * d2 + dz];
  };
  auto lerp4 = [](float4 a, float4 b, float f) {
    return make_float4(a.x * (1 - f) + b.x * f, a.y * (1 - f) + b.y * f,
                       a.z * (1 - f) + b.z * f, a.w * (1 - f) + b.w * f);
  };
  const float4 dx00 = lerp4(val(0, 0, 0), val(1, 0, 0), fx);
  const float4 dx01 = lerp4(val(0, 0, 1), val(1, 0, 1), fx);
  const float4 dx10 = lerp4(val(0, 1, 0), val(1, 1, 0), fx);
  const float4 dx11 = lerp4(val(0, 1, 1), val(1, 1, 1), fx);
  const float4 dxy0 = lerp4(dx00, dx10, fy);
  const float4 dxy1 = lerp4(dx01, dx11, fy);
  const float4 out = lerp4(dxy0, dxy1, fz);
  return {out.x, v3(out.y, out.z, out.w)};
}

}  // namespace
