// The model families of the hand-written kernels (csrc/fused_stage.cu,
// csrc/assoc_options.cu), one struct each: PRM3D camera, Linear2D,
// Linear1D, with the NaN-propagating min / max and the small sums they use.
// Every formula follows the operation order of the port's models
// (models/prm3d.py, models/linear_models.py, gm/smallmat.py), so under
// -fmad=false a kernel computes what its plain version computes bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// the model's own parameters, by value (fused_kernel.model_params):
// PRM3D: f, f^2, film left, right, top, bottom, range min, max; linear: range
struct ModelParams {
  float v[8];
};

// NaN-propagating min / max (jnp.minimum / torch.minimum; fminf drops NaN)
__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  float s = a0 * b0;
  s = s + a1 * b1;
  s = s + a2 * b2;
  return s;
}

template <int D>
__device__ __forceinline__ float quadn(const float (&x)[D], const float (&a)[D][D]) {
  float s = x[0] * a[0][0] * x[0];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (i + j > 0) s = s + x[i] * a[i][j] * x[j];
  return s;
}

// ---- model families ---------------------------------------------------------------
// Each gives: D; frame(pose) once per block; to_map (back-projection of a
// measurement); measure (h and the landmark Jacobian dh/dm [D][3]); fuzzy
// (the visibility ramp in [0, 1]).

struct Prm3d {  // pixel-range camera, pose = location + quaternion
  static constexpr int D = 3, S = 7;
  struct Frame {
    float loc[3];
    float R[3][3];
  };
  static __device__ __forceinline__ void frame(const float* pose, Frame& fr) {
    for (int i = 0; i < 3; ++i) fr.loc[i] = pose[i];
    const float qw = pose[3], qx = pose[4], qy = pose[5], qz = pose[6];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float xw = qx * qw, yw = qy * qw, zw = qz * qw;
    float(&R)[3][3] = fr.R;
    R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - zw); R[0][2] = 2.f * (xz + yw);
    R[1][0] = 2.f * (xy + zw); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - xw);
    R[2][0] = 2.f * (xz - yw); R[2][1] = 2.f * (yz + xw); R[2][2] = 1.f - 2.f * (xx + yy);
  }
  static __device__ __forceinline__ void to_map(const ModelParams& mp, const Frame& fr,
                                                const float (&z)[3], float (&out)[3]) {
    const float f = mp.v[0], f2 = mp.v[1];
    const float px = z[0], py = z[1], rng = z[2];
    const float alpha = rng / sqrtf(f2 + px * px + py * py);
    const float d0 = alpha * px, d1 = alpha * py, d2 = alpha * f;
    for (int i = 0; i < 3; ++i)
      out[i] = fr.loc[i] + dot3(fr.R[i][0], d0, fr.R[i][1], d1, fr.R[i][2], d2);
  }
  static __device__ __forceinline__ void measure(const ModelParams& mp, const Frame& fr,
                                                 const float (&m)[3], float (&h)[3],
                                                 float (&hj)[3][3]) {
    const float f = mp.v[0];
    const float(&R)[3][3] = fr.R;
    const float d[3] = {m[0] - fr.loc[0], m[1] - fr.loc[1], m[2] - fr.loc[2]};
    const float lx = dot3(R[0][0], d[0], R[1][0], d[1], R[2][0], d[2]);
    const float ly = dot3(R[0][1], d[0], R[1][1], d[1], R[2][1], d[2]);
    const float lz = dot3(R[0][2], d[0], R[1][2], d[1], R[2][2], d[2]);
    h[0] = f * lx / lz;
    h[1] = f * ly / lz;
    h[2] = sgn(lz) * sqrtf(dot3(d[0], d[0], d[1], d[1], d[2], d[2]));
    const float sign = lz > 0.f ? 1.f : -1.f;
    const float mag = sign * sqrtf(lx * lx + ly * ly + lz * lz);
    const float jp[3][3] = {{f / lz, 0.f, -f * lx / (lz * lz)},
                            {0.f, f / lz, -f * ly / (lz * lz)},
                            {lx / mag, ly / mag, lz / mag}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        hj[i][j] = dot3(jp[i][0], R[j][0], jp[i][1], R[j][1], jp[i][2], R[j][2]);
  }
  static __device__ __forceinline__ float fuzzy(const ModelParams& mp, const float* ramp,
                                                const float (&h)[3]) {
    const float left = mp.v[2], right = mp.v[3], top = mp.v[4], bottom = mp.v[5];
    const float rmin = mp.v[6], rmax = mp.v[7];
    float d = jmin((h[0] - left) / ramp[0], (right - h[0]) / ramp[0]);
    d = jmin(d, (h[1] - top) / ramp[1]);
    d = jmin(d, (bottom - h[1]) / ramp[1]);
    d = jmin(d, (h[2] - rmin) / ramp[2]);
    d = jmin(d, (rmax - h[2]) / ramp[2]);
    return jmin(jmax(d, 0.f), 1.f);
  }
};

template <int DIM>
struct Linear {  // pose = position; z = landmark - pose within a box
  static constexpr int D = DIM, S = DIM;
  struct Frame {
    float loc[DIM];
  };
  static __device__ __forceinline__ void frame(const float* pose, Frame& fr) {
    for (int i = 0; i < DIM; ++i) fr.loc[i] = pose[i];
  }
  static __device__ __forceinline__ void to_map(const ModelParams&, const Frame& fr,
                                                const float (&z)[DIM], float (&out)[3]) {
    for (int i = 0; i < 3; ++i) out[i] = 0.f;
    for (int i = 0; i < DIM; ++i) out[i] = fr.loc[i] + z[i];
  }
  static __device__ __forceinline__ void measure(const ModelParams&, const Frame& fr,
                                                 const float (&m)[3], float (&h)[DIM],
                                                 float (&hj)[DIM][3]) {
    for (int i = 0; i < DIM; ++i) {
      h[i] = m[i] - fr.loc[i];
      for (int k = 0; k < 3; ++k) hj[i][k] = i == k ? 1.f : 0.f;
    }
  }
  static __device__ __forceinline__ float fuzzy(const ModelParams& mp, const float* ramp,
                                                const float (&h)[DIM]) {
    const float range = mp.v[0];
    float d = jmin((h[0] + range) / ramp[0], (range - h[0]) / ramp[0]);
    for (int i = 1; i < DIM; ++i) {
      d = jmin(d, (h[i] + range) / ramp[i]);
      d = jmin(d, (range - h[i]) / ramp[i]);
    }
    return jmin(jmax(d, 0.f), 1.f);
  }
};

}  // namespace
