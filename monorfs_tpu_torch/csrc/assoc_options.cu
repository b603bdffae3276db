// The association beam's option tensors for every particle in one launch,
// for the three model families (PRM3D camera, Linear2D, Linear1D).
//
// Replaces no Pallas kernel: in the JAX package this stage is XLA
// (monorfs_tpu/slam/phd.py's weight inputs). The port ran it as eager
// PyTorch, slam/assoc_kernel.py::assoc_options_plain: ~200 launches a
// frame building [P, E, M] float32 tensors (the gated log-likelihood of
// every MAP row against every measurement slot) and one stable sort of the
// [P, M, E] candidates. At the flagship deployment's 100,000 particles
// (E = 48 MAP rows, M = 24 slots) those took ~32 device ms a frame on an
// H100 (80 GB HBM3, 700 W), 13.8 of them the sort.
//
// What it computes, per particle p (PHDNavigator.cs:415-453):
//   rows      the measurement slots live-first in slot order (live_first),
//             the first M of them, a non-finite coordinate read as 0;
//   landmarks for each MAP row e: the predicted measurement h of its mean,
//             pd_e = clamp(fuzzy(h) * PD, 1e-30, 1 - 1e-7), log pd_e plus the
//             measurement covariance's log-multiplier, log1p(-pd_e);
//   base      the sum of log1p(-pd_e) over the valid rows;
//   options   a live measurement row: the clutter slot log(clutter
//             density), then its C best landmarks by delta = ll - log1p(-pd)
//             where ll = log pd + log mult - d^2 / 2 is gated (d^2 < 25, the
//             Mahalanobis gate 5) on a valid row, else delta = NEG; sorted
//             descending, ties to the lower landmark index, the NEG entries
//             too (topk_stable's order); word and bit of each landmark index
//             in the beam's used set; a dead row: (0, NEG, ..., NEG) over
//             landmarks 0..C-1, as prepare_options builds it.
// Every formula follows the plain version's operation order and the build
// uses -fmad=false, so opt_delta, word_k and bit_k are the plain version's
// bit for bit; base adds the same terms in landmark order, where the plain
// version's torch.sum adds them in its own.
//
// Bound on the H100: bytes. At the flagship's frame it reads the poses and
// the MAP means (~62 MB) and writes the options (~183 MB): ~0.07 ms at
// 3.35 TB/s; the ~115 M (row, landmark) pairs at ~30 fp32 operations each
// take ~0.05 ms at 67 TFLOP/s.
//
// Design: a block of 256 threads takes PB = 256 / M particles (at least
// one; fewer where their landmark table would not fit shared memory). The
// block builds the live-first row order from the slots' mask, then one
// thread per (particle, MAP row) computes that row's predicted measurement,
// log pd + log mult and log miss into shared memory (a structure of arrays
// per particle, E + 1 words a field against bank conflicts), and one thread
// per particle sums base. Then one thread per (particle, measurement row)
// walks the E landmarks in index order and keeps the CMAX best in a sorted
// list in registers (CMAX = 8 or 32, the smallest that holds C: the first C
// of a stable descending order are the first C of its first CMAX). A
// landmark enters the list only if its delta is strictly above an entry,
// and then after every entry at least as large, so equal deltas keep the
// lower index first. Nothing of size [P, E, M] leaves the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "model_policy.cuh"

namespace {

constexpr float NEG = -1.0e30f;                  // association.NEG
constexpr float HALF_NEG = (float)(-1.0e30 / 2);  // the plain version's NEG / 2, in float32
constexpr float PD_MIN = (float)1e-30;
constexpr float PD_MAX = (float)(1.0 - 1e-7);
constexpr float GATE2 = 25.0f;  // Mahalanobis gate 5, squared
constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory one H100 block may use

// packed parameter layout (assoc_kernel.pack_params): log clutter density,
// PD, the measurement covariance's log-multiplier, the visibility ramp [D],
// the covariance's inverse [D, D]
enum { Q_CLUTTER = 0, Q_PD, Q_LOGMULT, Q_RAMP };

// words of one particle's landmark table: h [D], log pd + log mult, log miss
__host__ __device__ inline size_t table_words(int E, int D) { return (size_t)(D + 2) * (E + 1); }

// Particles a block takes: 256 / M (at least one), fewer where their tables
// and the row slots would not fit a block's shared memory; 0 where one
// particle's do not.
__host__ __device__ inline int particles_per_block(int E, int M, int Mz, int D) {
  const size_t words = SMEM_MAX / 4, fixed = (size_t)M + Mz, per = table_words(E, D);
  if (fixed + per > words) return 0;
  const size_t fit = (words - fixed) / per;
  const int want = M > 0 && M < THREADS ? THREADS / M : 1;
  return (size_t)want < fit ? want : (int)fit;
}

__host__ __device__ inline size_t layout_bytes(int E, int M, int Mz, int D) {
  return 4 * ((size_t)particles_per_block(E, M, Mz, D) * table_words(E, D) + M + Mz);
}

// Insert (v, e) into the descending list (lv, li): only if v is strictly
// above its last entry, and then after every entry at least as large (e is
// above every index in the list, so equal values keep the lower index first).
template <int CMAX>
__device__ __forceinline__ void insert(float (&lv)[CMAX], int (&li)[CMAX], float v, int e) {
  if (!(v > lv[CMAX - 1])) return;
  bool above = true;  // v > lv[j], the list as it was
#pragma unroll
  for (int j = CMAX - 1; j > 0; --j) {
    const bool above_prev = v > lv[j - 1];
    if (above_prev) {
      lv[j] = lv[j - 1];
      li[j] = li[j - 1];
    } else if (above) {
      lv[j] = v;
      li[j] = e;
    }
    above = above_prev;
  }
  if (above) {
    lv[0] = v;
    li[0] = e;
  }
}

template <class Mdl, int CMAX>
__global__ void __launch_bounds__(THREADS)
assoc_options_kernel(const float* __restrict__ prm, const float* __restrict__ pose,
                     const float* __restrict__ jm0, const float* __restrict__ jm1,
                     const float* __restrict__ jm2, long long jm_row, long long jm_col,
                     const bool* __restrict__ jvalid, const float* __restrict__ z,
                     const bool* __restrict__ zmask, int Mz, int P, int E, int M, int C, int PB,
                     ModelParams mp, float* __restrict__ base, float* __restrict__ od,
                     int* __restrict__ wk, int* __restrict__ bk) {
  constexpr int D = Mdl::D, S = Mdl::S;
  extern __shared__ float smem[];
  const int ES = E + 1;
  float* lm = smem;                                      // [PB][D + 2][ES]
  int* rowslot = (int*)(lm + (size_t)PB * table_words(E, D));  // [M]
  int* zlive = rowslot + M;                              // [Mz]
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * PB;
  const int np = min(PB, P - p0);

  for (int i = t; i < Mz; i += THREADS) zlive[i] = zmask[i] ? 1 : 0;
  __syncthreads();
  if (t == 0) {  // the live slots, then the dead ones, each in slot order
    int j = 0;
    for (int live = 1; live >= 0; --live)
      for (int i = 0; i < Mz && j < M; ++i)
        if (zlive[i] == live) rowslot[j++] = i;
  }

  // ---- the landmark table: h, log pd + log mult, log miss ---------------------------
  float ramp[D];
#pragma unroll
  for (int i = 0; i < D; ++i) ramp[i] = prm[Q_RAMP + i];
  const float pd = prm[Q_PD], logmult = prm[Q_LOGMULT];
  for (int k = t; k < np * E; k += THREADS) {
    const int pp = k / E, e = k - pp * E, p = p0 + pp;
    typename Mdl::Frame fr;
    Mdl::frame(pose + (size_t)p * S, fr);
    const size_t at = (size_t)p * jm_row + (size_t)e * jm_col;
    const float m[3] = {jm0[at], jm1[at], jm2[at]};
    float h[D], hj[D][3];
    Mdl::measure(mp, fr, m, h, hj);
    const float pdv = jmin(jmax(Mdl::fuzzy(mp, ramp, h) * pd, PD_MIN), PD_MAX);
    const bool valid = jvalid[(size_t)p * E + e];
    float* L = lm + (size_t)pp * table_words(E, D);
#pragma unroll
    for (int i = 0; i < D; ++i) L[i * ES + e] = h[i];
    // an invalid row's ll is -inf, which no gate passes (ll > NEG / 2 fails
    // for -inf and NaN alike); its miss adds 0 to base
    L[D * ES + e] = valid ? logf(pdv) + logmult : -INFINITY;
    L[(D + 1) * ES + e] = valid ? log1pf(-pdv) : 0.f;
  }
  __syncthreads();
  if (t < np) {
    const float* miss = lm + (size_t)t * table_words(E, D) + (size_t)(D + 1) * ES;
    float s = 0.f;
    for (int e = 0; e < E; ++e) s = s + miss[e];
    base[p0 + t] = s;
  }

  // ---- each measurement row's options ----------------------------------------------
  float rinv[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) rinv[i][j] = prm[Q_RAMP + D + i * D + j];
  const float clutter = prm[Q_CLUTTER];
  for (int k = t; k < np * M; k += THREADS) {
    const int pp = k / M, r = k - pp * M;
    const size_t row = (size_t)(p0 + pp) * M + r;
    float* o = od + row * (C + 1);
    int* w = wk + row * C;
    int* b = bk + row * C;
    const int slot = rowslot[r];
    if (!zlive[slot]) {  // a dead slot: every landmark NEG, in index order
      o[0] = 0.f;
      for (int j = 0; j < C; ++j) {
        o[1 + j] = NEG;
        w[j] = j >> 5;
        b[j] = (int)(1u << (j & 31));
      }
      continue;
    }
    float zr[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float v = z[(size_t)slot * D + i];
      zr[i] = isfinite(v) ? v : 0.f;
    }
    float lv[CMAX];
    int li[CMAX];
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      lv[j] = -INFINITY;
      li[j] = 0;
    }
    const float* L = lm + (size_t)pp * table_words(E, D);
    for (int e = 0; e < E; ++e) {
      float diff[D];
#pragma unroll
      for (int i = 0; i < D; ++i) diff[i] = zr[i] - L[i * ES + e];
      const float d2 = quadn<D>(diff, rinv);
      const float ll = L[D * ES + e] - 0.5f * d2;
      const float delta = d2 < GATE2 && ll > HALF_NEG ? ll - L[(D + 1) * ES + e] : NEG;
      insert<CMAX>(lv, li, delta, e);
    }
    o[0] = clutter;
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      if (j < C) {
        o[1 + j] = lv[j];
        w[j] = li[j] >> 5;
        b[j] = (int)(1u << (li[j] & 31));
      }
    }
  }
}

template <class Mdl, int CMAX>
int launch(const float* prm, const float* pose, const float* jm0, const float* jm1,
           const float* jm2, long long jm_row, long long jm_col, const bool* jvalid, const float* z,
           const bool* zmask, int Mz, int P, int E, int M, int C, const ModelParams& mp,
           float* base, float* od, int* wk, int* bk, cudaStream_t stream) {
  static std::atomic<size_t> smem_set[kMaxDevices];  // per instantiation
  const int pb = particles_per_block(E, M, Mz, Mdl::D);
  if (pb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = layout_bytes(E, M, Mz, Mdl::D);
  auto kernel = assoc_options_kernel<Mdl, CMAX>;
  cudaError_t err = allow_smem((const void*)kernel, smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(P + pb - 1) / pb, THREADS, smem, stream>>>(prm, pose, jm0, jm1, jm2, jm_row, jm_col,
                                                       jvalid, z, zmask, Mz, P, E, M, C, pb, mp,
                                                       base, od, wk, bk);
  return (int)cudaGetLastError();
}

template <class Mdl>
int launch_c(const float* prm, const float* pose, const float* jm0, const float* jm1,
             const float* jm2, long long jm_row, long long jm_col, const bool* jvalid,
             const float* z, const bool* zmask, int Mz, int P, int E, int M, int C,
             const ModelParams& mp, float* base, float* od, int* wk, int* bk, cudaStream_t st) {
  if (C <= 8)
    return launch<Mdl, 8>(prm, pose, jm0, jm1, jm2, jm_row, jm_col, jvalid, z, zmask, Mz, P, E, M,
                          C, mp, base, od, wk, bk, st);
  if (C <= 32)
    return launch<Mdl, 32>(prm, pose, jm0, jm1, jm2, jm_row, jm_col, jvalid, z, zmask, Mz, P, E,
                           M, C, mp, base, od, wk, bk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory one block asks for at this shape (0 where no block holds
// one particle's landmark table).
extern "C" size_t assoc_options_smem_bytes(int E, int M, int Mz, int D) {
  return particles_per_block(E, M, Mz, D) > 0 ? layout_bytes(E, M, Mz, D) : 0;
}

// Particles one block takes at this shape.
extern "C" int assoc_options_particles_per_block(int E, int M, int Mz, int D) {
  return particles_per_block(E, M, Mz, D);
}

// meas_dim 3 = PRM3D, 2 = Linear2D, 1 = Linear1D. prm [3 + D + D*D] f32;
// pose [P, S] f32; jm0..jm2 the MAP means' coordinates [P, E] f32, element
// (p, e) at p * jm_row + e * jm_col; jvalid [P, E] bool; z [Mz, D] f32 and
// zmask [Mz] bool, the step's measurement slots; M <= Mz rows, C <= 32 <= E
// candidates; m0..m7 the model's parameters (ModelParams). base [P],
// od [P, M, C+1] f32, wk and bk [P, M, C] int32 out.
extern "C" int assoc_options_launch(int meas_dim, const float* prm, const float* pose,
                                    const float* jm0, const float* jm1, const float* jm2,
                                    long long jm_row, long long jm_col, const bool* jvalid,
                                    const float* z, const bool* zmask, int Mz, int P, int E,
                                    int M, int C, float m0, float m1, float m2, float m3,
                                    float m4, float m5, float m6, float m7, float* base, float* od,
                                    int* wk, int* bk, void* stream) {
  if (P == 0) return 0;
  const ModelParams mp{{m0, m1, m2, m3, m4, m5, m6, m7}};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (meas_dim) {
    case 3: return launch_c<Prm3d>(prm, pose, jm0, jm1, jm2, jm_row, jm_col, jvalid, z, zmask, Mz, P,
                                   E, M, C, mp, base, od, wk, bk, st);
    case 2: return launch_c<Linear<2>>(prm, pose, jm0, jm1, jm2, jm_row, jm_col, jvalid, z, zmask, Mz,
                                       P, E, M, C, mp, base, od, wk, bk, st);
    case 1: return launch_c<Linear<1>>(prm, pose, jm0, jm1, jm2, jm_row, jm_col, jvalid, z, zmask, Mz,
                                       P, E, M, C, mp, base, od, wk, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}
