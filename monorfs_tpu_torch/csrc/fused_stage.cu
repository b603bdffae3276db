// PHD births + correct + prune for every particle in one launch, for the
// three model families (PRM3D camera, Linear2D, Linear1D).
//
// Replaces: monorfs_tpu/slam/fused_pallas.py::fused_stage (Pallas body
// _make_kernel), with the kernel semantics of fused_pallas.py:21-41.
//
// What it computes, per particle (PHDNavigator.cs:793-948):
//   births    back-project every measurement; a live one whose local map
//             density (components within 3 radius) is below the
//             exploration threshold becomes a birth component;
//   EKF       per predicted component: h, S, S^-1, gain, (I-KH)P;
//   pairs     gated [M, K0+M] log-weights normalised per measurement by
//             clutter + the gated weight sum;
//   cut       MaxQuantity as a 30-step bisection for tau over misses and
//             pairs (strict `>` counts; ties at tau dropped);
//   compact   misses in component order, then each measurement's pairs in
//             (weight desc, index asc) order, at most gate_top a row;
//   merge     greedy Mahalanobis merge, (weight, index) leader order,
//             merge_rounds synchronous leader rounds, moments pooled about
//             the leader's mean.
//
// Bound on the H100: on paper, operations at the flagship's shape (P =
// 100,000, K0 = 128, M = 48, the cap binding: ~1.1 ms of fp32 work at 67
// TFLOP/s) and bytes at the command line's (pred's copy of the map and
// cor's fill, ~4.4 us at K0 = 600, P = 200). In practice, latency: one
// block of 256 threads per particle, each a chain of phases separated by
// barriers, so a phase costs its longest serial chain, and the waves of
// blocks (three an SM) follow one another.
//
// The design works on the live components only. A filter's map holds a few
// dozen to K0 live components of K0 slots, so a block first lists its live
// input components (logw > ALIVE_THRESHOLD) in component order and runs
// every phase over the N = L + M local components (L live, then the M birth
// candidates) and the O = min(K0, survivors) output slots, never over K0:
// dead slots give nothing to the births' density (masked there), their
// misses and pairs sit at DEAD under any tau, and a list in component order
// keeps the misses' order and the pairs' (weight desc, index asc) order.
// pred's map part is the input copied as it stands; cor's tail takes the
// plain version's fill. The model-specific parts (pose -> frame,
// back-projection, measurement and its landmark Jacobian, fuzzy visibility,
// the measurement dimension D) are a template parameter, one instantiation
// per family (csrc/model_policy.cuh). Gathers are indices, not one-hot
// products. Every phase uses the whole block, and no thread runs a serial
// loop over N:
//   births, pairs   warp per measurement row, lanes over components, warp sums;
//   EKF             thread per local component (one pass: its cost is one
//                   component's dependent chain, which more threads would
//                   not shorten); pairs compute a likelihood only in gate;
//   cut             the entries above lo (the rest never count for a
//                   threshold >= lo) compacted into one list whose head sits
//                   in registers; a bisection count is a register pass, a
//                   warp reduction and one barrier (partials double-buffered);
//   compaction      misses by a block-wide ballot prefix scan, row offsets by
//                   a warp scan; each row's survivors gathered by one warp
//                   (ballot prefix) and ranked against each other, so a row
//                   costs its survivors squared over 32 lanes, not N each;
//   merge relation  the O slots ranked (weight desc, index asc); one warp per
//                   member, its lanes over the heavier ranks only, so half of
//                   the O x O tests are never made; a hit sets its bit with
//                   atomicOr;
//   pooling         each leader walks its member bits (set by atomicOr,
//                   which is order-free), members in index order.
//
// Tables are placed per block: each goes to a shared arena of LIVE_ARENA
// words while it fits (stage A grows up from the arena's start: z, the
// predicted mixture, the EKF channels, the pair table; the output slots
// grow down from its end; the merge tables reuse stage A's room), else to
// the block's slot of a per-particle device-memory workspace sized for
// N = K0 + M and O = K0 (LiveWs). So every (K0, M) launches, with shared
// memory that does not grow with K0: three blocks an SM (72 KB each, at
// most 80 registers a thread). chip_smoke.py prints the cycles of each
// phase (the clk probe). Every elementwise formula follows the plain
// version's operation order, and the build uses -fmad=false, so the two
// differ only where a reduction sums in another order: the births' density
// and the pairs' weight sum, split across lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_util.cuh"
#include "model_policy.cuh"

namespace {

constexpr float DEAD = -1.0e30f;
constexpr float ALIVE_THRESHOLD = -0.5e30f;
constexpr float PD_MAX = (float)(1.0 - 1e-7);
constexpr float LOG2PI3 = (float)(3.0 * 1.8378770664093453);
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// parameter vector layout (fused_kernel.pack_params): 7 scalars, the
// visibility ramp [D], the measurement covariance [D, D], the birth
// covariance [3, 3]
enum { P_PD = 0, P_CLUTTER, P_BIRTH_W, P_MIN_W, P_MERGE, P_EXPLORE, P_RADIUS, P_RAMP = 7 };

// Phase clock probe: with clk set, thread 0 of each block writes clock64()
// at entry and after the barrier that ends each of the NPHASE phases.
constexpr int NPHASE = 9;
__device__ __forceinline__ void probe(long long* clk, int i) {
  if (clk == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) clk[(size_t)blockIdx.x * (NPHASE + 1) + i] = clock64();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < NWARPS; ++i) r = fmaxf(r, scratch[i]);
  return r;
}

// smallmat twins (same operation order as the Python unrolled sums)
__device__ __forceinline__ float det3(const float a[3][3]) {
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
         a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0]) +
         a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

__device__ __forceinline__ void inv3(const float a[3][3], float dt, float o[3][3]) {
  const float r = 1.0f / dt;
  o[0][0] = (a[1][1] * a[2][2] - a[1][2] * a[2][1]) * r;
  o[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) * r;
  o[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) * r;
  o[1][0] = (a[1][2] * a[2][0] - a[1][0] * a[2][2]) * r;
  o[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) * r;
  o[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) * r;
  o[2][0] = (a[1][0] * a[2][1] - a[1][1] * a[2][0]) * r;
  o[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) * r;
  o[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) * r;
}

__device__ __forceinline__ float quadform(const float x[3], const float a[3][3]) {
  float s = x[0] * a[0][0] * x[0];
  s = s + x[0] * a[0][1] * x[1];
  s = s + x[0] * a[0][2] * x[2];
  s = s + x[1] * a[1][0] * x[0];
  s = s + x[1] * a[1][1] * x[1];
  s = s + x[1] * a[1][2] * x[2];
  s = s + x[2] * a[2][0] * x[0];
  s = s + x[2] * a[2][1] * x[1];
  s = s + x[2] * a[2][2] * x[2];
  return s;
}

__device__ __forceinline__ void sym_to_mat(const float c[6], float a[3][3]) {
  a[0][0] = c[0]; a[0][1] = c[1]; a[0][2] = c[2];
  a[1][0] = c[1]; a[1][1] = c[3]; a[1][2] = c[4];
  a[2][0] = c[2]; a[2][1] = c[4]; a[2][2] = c[5];
}

// small D x D algebra, D in {1, 2, 3}, in smallmat's operation order
template <int D>
__device__ __forceinline__ float detn(const float (&a)[D][D]) {
  if constexpr (D == 1) {
    return a[0][0];
  } else if constexpr (D == 2) {
    return a[0][0] * a[1][1] - a[0][1] * a[1][0];
  } else {
    return det3(a);
  }
}

template <int D>
__device__ __forceinline__ void invn(const float (&a)[D][D], float dt, float (&o)[D][D]) {
  if constexpr (D == 1) {
    o[0][0] = 1.0f / dt;
  } else if constexpr (D == 2) {
    const float r = 1.0f / dt;
    o[0][0] = a[1][1] * r;
    o[0][1] = -a[0][1] * r;
    o[1][0] = -a[1][0] * r;
    o[1][1] = a[0][0] * r;
  } else {
    inv3(a, dt, o);
  }
}

// ---- the kernel ----------------------------------------------------------------------

constexpr int LIVE_CUT_REGS = 8;    // entries above lo a thread keeps in registers
constexpr int LIVE_ARENA = 15872;   // words of the shared arena
constexpr int LIST_CAP = 128;       // a warp's gathered survivors of one row
constexpr int LIVE_FIXED = 32 + 64 + 2 * LIST_CAP * NWARPS;  // prm, scratch, the row lists

__host__ __device__ constexpr size_t live_smem_bytes() {
  return (size_t)(LIVE_FIXED + LIVE_ARENA) * sizeof(float);
}

// one particle's workspace (words): a slot for every table at its largest
struct LiveWs {
  size_t z, pm, ekf, pair, cut, om, oc, olw, isl, w, lead, lbits, rmean, rinv, bits, total;
  __host__ __device__ LiveWs(int K0, int M) {
    const size_t KPm = (size_t)K0 + M, K = K0, NWK = ((size_t)K0 + 31) / 32;
    size_t o = 0;
    z = o; o += 9 * (size_t)M;     // z 3, live flag, back-projections 3, row counts, row offsets
    pm = o; o += 10 * KPm;         // the local predicted mixture
    ekf = o; o += 30 * KPm;        // EKF channels (births: inverse covariances)
    pair = o; o += (size_t)M * KPm;
    cut = o; o += (1 + (size_t)M) * KPm;  // the cut's entries above lo
    om = o; o += 3 * K;            // output slots: means, covariances, log-weights, sources
    oc = o; o += 6 * K;
    olw = o; o += K;
    isl = o; o += K;
    w = o; o += K;                 // merge: weights, rank order / leaders, leader bits,
    lead = o; o += K;              // rank-ordered means and metrics, the relation
    lbits = o; o += NWK;
    rmean = o; o += 3 * K;
    rinv = o; o += 6 * K;
    bits = o; o += K * NWK;
    total = o;
  }
};

// a table goes to shared memory while [lo, hi) has room for it, else to its
// workspace slot; the decision depends on block-uniform counts only
struct Arena {
  float* sm;
  int lo, hi;
  float* ws;
  __device__ float* up(size_t words, size_t off) {
    if ((size_t)(hi - lo) >= words) {
      float* q = sm + lo;
      lo += (int)words;
      return q;
    }
    return ws + off;
  }
  __device__ float* down(size_t words, size_t off) {
    if ((size_t)(hi - lo) >= words) {
      hi -= (int)words;
      return sm + hi;
    }
    return ws + off;
  }
};

template <class Mdl>
__global__ void __launch_bounds__(THREADS, 3)
fused_stage_kernel_live(const float* __restrict__ prm_g, const float* __restrict__ pose_g,
                        const float* __restrict__ maps, const float* __restrict__ zg,
                        const int* __restrict__ zmask, int zmask_stride, float* __restrict__ pred,
                        float* __restrict__ cor, float* __restrict__ work, int P, int K0, int M,
                        int gate_top, int merge_rounds, ModelParams mp, long long* clk) {
  extern __shared__ float sm[];
  probe(clk, 0);
  constexpr int D = Mdl::D;
  constexpr int P_R = P_RAMP + D, P_BC = P_R + D * D, NPRM = P_BC + 9;
  constexpr float LOG2PID = (float)(D * 1.8378770664093453);
  const int K = K0, KP = K0 + M;
  const int p = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const LiveWs W(K0, M);
  float* prm = sm;
  float* fscratch = sm + 32;
  int* iscratch = reinterpret_cast<int*>(sm + 64);  // [0, 16) count partials, [16, 24) ballots, 24 total
  float* lists = sm + 96;                           // [NWARPS][2][LIST_CAP]
  Arena ar{sm + LIVE_FIXED, 0, LIVE_ARENA, work + (size_t)p * W.total};
  const float* lw_in = maps + ((size_t)9 * P + p) * K0;

  // ---- measurements, the live input components --------------------------------------
  // z first (its table's place does not depend on L), so its loads overlap
  // the live count's; then the list, then each live component's channels,
  // one load round for the block
  float* zs = ar.up(9 * (size_t)M, W.z);
  float* zl = zs + 3 * M;
  float* bp = zs + 4 * M;
  int* rowcnt = reinterpret_cast<int*>(zs + 7 * M);
  int* rowoff = reinterpret_cast<int*>(zs + 8 * M);
  typename Mdl::Frame fr;
  Mdl::frame(pose_g + (size_t)p * Mdl::S, fr);
  for (int i = t; i < NPRM; i += THREADS) prm[i] = prm_g[i];
  for (int j = t; j < M; j += THREADS) {
    float zj[D], b[3];
    for (int i = 0; i < D; ++i) {
      zj[i] = zg[j * D + i];
      zs[i * M + j] = zj[i];
    }
    zl[j] = zmask[(size_t)p * zmask_stride + j] != 0 ? 1.f : 0.f;  // row p, or the shared row
    Mdl::to_map(mp, fr, zj, b);
    for (int i = 0; i < 3; ++i) bp[i * M + j] = b[i];
  }
  // one streaming pass over the map: pred's map part is the input as it
  // stands (ten loads in flight a thread), and the live count
  int mine_live = 0;
  for (int k = t; k < K0; k += THREADS) {
    float v[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) v[c] = maps[((size_t)c * P + p) * K0 + k];
#pragma unroll
    for (int c = 0; c < 10; ++c) pred[((size_t)c * P + p) * KP + k] = v[c];
    mine_live += v[9] > ALIVE_THRESHOLD;
  }
  mine_live = __reduce_add_sync(FULL, mine_live);
  if (lane == 0) iscratch[16 + warp] = mine_live;
  __syncthreads();
  int L = 0;
  for (int w = 0; w < NWARPS; ++w) L += iscratch[16 + w];
  __syncthreads();
  const int N = L + M;
  float* pm = ar.up(10 * (size_t)N, W.pm);
  float* h = ar.up(30 * (size_t)N, W.ekf);
  float* cpair = ar.up((size_t)M * N, W.pair);
  float* sinv = h + 3 * N;   // [D * D][N]
  float* slogm = h + 12 * N;
  float* gain = h + 13 * N;  // [3 * D][N]
  float* covu = h + 22 * N;
  float* logpd = h + 28 * N;
  float* cmiss = h + 29 * N;
  float* inv0 = h;            // births only: [9][L], then logmult0 [L]
  float* logmult0 = h + 9 * L;
  const float lminw = jmax(logf(prm[P_MIN_W]), -80.f);
  const float* Rm = prm + P_R;
  const float* ramp = prm + P_RAMP;

  // the list in component order (block-wide ballot prefix scans), held in
  // pm's log-weight row until each entry's channels replace it
  int* lidx = reinterpret_cast<int*>(pm + 9 * N);
  int nl = 0;
  for (int base = 0; base < K0; base += THREADS) {
    const int k = base + t;
    const bool keep = k < K0 && lw_in[k] > ALIVE_THRESHOLD;
    const uint32_t bal = __ballot_sync(FULL, keep);
    if (lane == 0) iscratch[16 + warp] = __popc(bal);
    __syncthreads();
    int q = nl + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < NWARPS; ++w) {
      const int c = iscratch[16 + w];
      q += w < warp ? c : 0;
      nl += c;
    }
    if (keep) lidx[q] = k;
    __syncthreads();
  }
  for (int q = t; q < L; q += THREADS) {
    const int k = lidx[q];
    float v[10], c6[6], a[3][3], o[3][3];
    for (int c = 0; c < 10; ++c) v[c] = maps[((size_t)c * P + p) * K0 + k];
    for (int c = 0; c < 10; ++c) pm[c * N + q] = v[c];
    for (int c = 0; c < 6; ++c) c6[c] = v[3 + c];
    sym_to_mat(c6, a);
    const float dt = det3(a);
    inv3(a, dt, o);
    for (int i = 0; i < 9; ++i) inv0[i * L + q] = o[i / 3][i % 3];
    logmult0[q] = -0.5f * (LOG2PI3 + logf(dt));
  }
  for (int j = t; j < M; j += THREADS) {
    const int q = L + j;
    const float* bc = prm + P_BC;
    for (int i = 0; i < 3; ++i) pm[i * N + q] = bp[i * M + j];
    pm[3 * N + q] = bc[0]; pm[4 * N + q] = bc[1]; pm[5 * N + q] = bc[2];
    pm[6 * N + q] = bc[4]; pm[7 * N + q] = bc[5]; pm[8 * N + q] = bc[8];
  }
  __syncthreads();

  // ---- births: local density of the live components at each back-projection ------
  {
    const float r3 = 3.0f * prm[P_RADIUS];
    for (int j = warp; j < M; j += NWARPS) {
      float acc = 0.f;
      for (int q = lane; q < L; q += 32) {
        const float lw = pm[9 * N + q];
        float d[3], a[3][3];
        for (int i = 0; i < 3; ++i) d[i] = bp[i * M + j] - pm[i * N + q];
        for (int i = 0; i < 9; ++i) a[i / 3][i % 3] = inv0[i * L + q];
        const float logp = logmult0[q] - 0.5f * quadform(d, a);
        const float dist2 = dot3(d[0], d[0], d[1], d[1], d[2], d[2]);
        if (lw > ALIVE_THRESHOLD && dist2 <= r3 * r3) acc += expf(lw + logp);
      }
      const float density = warp_sum(acc);
      if (lane == 0)
        pm[9 * N + L + j] =
            (zl[j] > 0.5f && density < prm[P_EXPLORE]) ? logf(prm[P_BIRTH_W]) : DEAD;
    }
  }
  __syncthreads();
  probe(clk, 1);
  for (int i = t; i < 10 * M; i += THREADS) {  // pred's births (its map part went out first)
    const int c = i / M, j = i - c * M;
    pred[((size_t)c * P + p) * KP + K0 + j] = pm[c * N + L + j];
  }
  probe(clk, 2);

  // ---- EKF precompute per local component -------------------------------------------
  for (int k = t; k < N; k += THREADS) {
    const float lw = pm[9 * N + k];
    const bool alive = lw > ALIVE_THRESHOLD;
    if (!alive) {  // a dead birth is never gated: only its miss is read
      cmiss[k] = DEAD;
      continue;
    }
    float c6[6], cv[3][3];
    for (int i = 0; i < 6; ++i) c6[i] = pm[(3 + i) * N + k];
    sym_to_mat(c6, cv);
    const float mk[3] = {pm[k], pm[N + k], pm[2 * N + k]};
    float hk[D], hj[D][3];
    Mdl::measure(mp, fr, mk, hk, hj);
    float pdk = alive ? Mdl::fuzzy(mp, ramp, hk) * prm[P_PD] : 0.f;
    pdk = jmin(jmax(pdk, 0.f), PD_MAX);
    const float miss = alive ? lw + log1pf(-pdk) : DEAD;

    float pht[3][D], s[D][D], si[D][D], g[3][D], ikh[3][3], a[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < D; ++j)
        pht[i][j] = dot3(cv[i][0], hj[j][0], cv[i][1], hj[j][1], cv[i][2], hj[j][2]);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j)
        s[i][j] = dot3(hj[i][0], pht[0][j], hj[i][1], pht[1][j], hj[i][2], pht[2][j]) +
                  Rm[i * D + j];
    const float det_s = detn<D>(s);
    invn<D>(s, det_s, si);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < D; ++j) {
        float acc = pht[i][0] * si[0][j];
        for (int c = 1; c < D; ++c) acc = acc + pht[i][c] * si[c][j];
        g[i][j] = acc;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float acc = g[i][0] * hj[0][j];
        for (int c = 1; c < D; ++c) acc = acc + g[i][c] * hj[c][j];
        ikh[i][j] = (i == j ? 1.f : 0.f) - acc;
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        a[i][j] = dot3(ikh[i][0], cv[0][j], ikh[i][1], cv[1][j], ikh[i][2], cv[2][j]);
    const int up[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
    for (int i = 0; i < 6; ++i) {
      const float v = 0.5f * (a[up[i][0]][up[i][1]] + a[up[i][1]][up[i][0]]);
      covu[i * N + k] = isfinite(v) ? v : 0.f;
    }
    for (int i = 0; i < D; ++i) h[i * N + k] = hk[i];
    for (int i = 0; i < D * D; ++i) sinv[i * N + k] = si[i / D][i % D];
    for (int i = 0; i < 3 * D; ++i) gain[i * N + k] = g[i / D][i % D];
    slogm[k] = -0.5f * (LOG2PID + logf(det_s));
    logpd[k] = logf(jmax(pdk, 1e-30f));
    cmiss[k] = miss >= lminw ? miss : DEAD;
  }
  __syncthreads();
  probe(clk, 3);

  // ---- gated pair log-weights, normalised per measurement ----------------------------
  {
    const float r2 = prm[P_RADIUS] * prm[P_RADIUS];
    for (int j = warp; j < M; j += NWARPS) {
      const bool zlive = zl[j] > 0.5f;
      float acc = 0.f;
      for (int k = lane; k < N; k += 32) {
        const float lw = pm[9 * N + k];
        float d[3];
        for (int i = 0; i < 3; ++i) d[i] = bp[i * M + j] - pm[i * N + k];
        const bool gate = dot3(d[0], d[0], d[1], d[1], d[2], d[2]) <= r2 &&
                          lw > ALIVE_THRESHOLD && zlive;
        float ln = DEAD;
        if (gate) {  // the likelihood only where it is read
          float in[D], a[D][D];
          for (int i = 0; i < D; ++i) in[i] = zs[i * M + j] - h[i * N + k];
          for (int i = 0; i < D * D; ++i) a[i / D][i % D] = sinv[i * N + k];
          float q = slogm[k] - 0.5f * quadn<D>(in, a);
          if (!isfinite(q)) q = DEAD;
          ln = logpd[k] + lw + q;
          acc += expf(ln);
        }
        cpair[j * N + k] = ln;
      }
      // out-of-gate entries hold DEAD and stay below lminw after the shift
      const float lden = logf(prm[P_CLUTTER] + warp_sum(acc));
      for (int k = lane; k < N; k += 32) {
        const float u = cpair[j * N + k] - lden;
        cpair[j * N + k] = u >= lminw ? u : DEAD;
      }
    }
  }
  __syncthreads();
  probe(clk, 4);

  // ---- MaxQuantity cut: bisect for tau ------------------------------------------------
  // Every threshold tried is >= lo, so an entry <= lo never counts: the
  // entries above lo (misses, then pairs) are compacted into one list (a
  // block scan of each thread's count gives its offset), its first
  // LIVE_CUT_REGS x THREADS entries go to registers, and a count reads the
  // registers and the list's tail.
  const int nall = N + M * N;
  auto entry = [&](int i) { return i < N ? cmiss[i] : cpair[i - N]; };
  float tau;
  {
    const float lo = (0.f + lminw) - 1.0f;
    float mx = -INFINITY;
    int held = 0;
    for (int i = t; i < nall; i += THREADS) {
      const float v = entry(i);
      mx = fmaxf(mx, v);
      held += v > lo;
    }
    int incl = held;  // exclusive block scan of held: warp scan, then the warps' totals
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      incl += lane >= o ? u : 0;
    }
    if (lane == 31) iscratch[16 + warp] = incl;
    const float hi = jmax(block_max(mx, fscratch), lo + 1e-3f);  // its barriers order the totals
    int off = incl - held, n_c = 0;
    for (int w = 0; w < NWARPS; ++w) {
      const int c = iscratch[16 + w];
      off += w < warp ? c : 0;
      n_c += c;
    }
    const int lo_a = ar.lo;
    float* clist = ar.up(n_c, W.cut);
    const int end = off + held;
    for (int i = t; i < nall && off < end; i += THREADS) {
      const float v = entry(i);
      if (v > lo) clist[off++] = v;
    }
    __syncthreads();
    float mine[LIVE_CUT_REGS];
#pragma unroll
    for (int r = 0; r < LIVE_CUT_REGS; ++r) {
      const int i = t + r * THREADS;
      mine[r] = i < n_c ? clist[i] : -INFINITY;
    }
    int* part = iscratch;  // [2][NWARPS]
    auto count_above = [&](float th, int buf) {
      int c = 0;
#pragma unroll
      for (int r = 0; r < LIVE_CUT_REGS; ++r) c += mine[r] > th;
      for (int i = t + LIVE_CUT_REGS * THREADS; i < n_c; i += THREADS) c += clist[i] > th;
      c = __reduce_add_sync(FULL, c);
      if (lane == 0) part[buf * NWARPS + warp] = c;
      __syncthreads();
      int total = 0;
      for (int w = 0; w < NWARPS; ++w) total += part[buf * NWARPS + w];
      return total;
    };
    tau = lo;
    if (count_above(lo, 0) > K) {  // the cap binds (uniform across the block)
      float lo_b = lo, hi_b = hi;
      for (int it = 0; it < 30; ++it) {
        const float mid = 0.5f * (lo_b + hi_b);
        const bool over = count_above(mid, (it + 1) & 1) > K;
        lo_b = over ? mid : lo_b;
        hi_b = over ? hi_b : mid;
      }
      tau = hi_b;
    }
    __syncthreads();  // the list is dead: its room goes back to the arena
    ar.lo = lo_a;
  }
  probe(clk, 5);

  // ---- compaction -------------------------------------------------------------------
  // The survivors fill slots [0, O) exactly: misses in component order, then
  // each row's pairs (at most gate_top) in (weight desc, index asc) order.
  int n_miss = 0;
  for (int base = 0; base < N; base += THREADS) {
    const int k = base + t;
    n_miss += __syncthreads_count(k < N && cmiss[k] > tau);
  }
  for (int j = warp; j < M; j += NWARPS) {  // survivors per measurement row
    int cnt = 0;
    for (int base = 0; base < N; base += 32) {
      const int k = base + lane;
      cnt += __popc(__ballot_sync(FULL, k < N && cpair[j * N + k] > tau));
    }
    if (lane == 0) rowcnt[j] = cnt < gate_top ? cnt : gate_top;
  }
  __syncthreads();
  if (warp == 0) {  // row offsets: exclusive warp scan, 32 rows a pass
    int carry = 0;
    for (int base = 0; base < M; base += 32) {
      const int j = base + lane;
      const int v = j < M ? rowcnt[j] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, o);
        incl += lane >= o ? u : 0;
      }
      if (j < M) rowoff[j] = carry + incl - v;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) iscratch[24] = carry;
  }
  __syncthreads();
  const int n_sur = n_miss + iscratch[24];
  const int O = n_sur < K ? n_sur : K;
  const int NWO = (O + 31) / 32;
  float* om = ar.down(3 * (size_t)O, W.om);
  float* oc = ar.down(6 * (size_t)O, W.oc);
  float* olw = ar.down(O, W.olw);
  int* isl = reinterpret_cast<int*>(ar.down(O, W.isl));  // a pair's (j * N + k), -1 for a miss
  {
    int nm = 0;
    for (int base = 0; base < N; base += THREADS) {
      const int k = base + t;
      const bool keep = k < N && cmiss[k] > tau;
      const uint32_t bal = __ballot_sync(FULL, keep);
      if (lane == 0) iscratch[16 + warp] = __popc(bal);
      __syncthreads();
      int slot = nm + __popc(bal & ((1u << lane) - 1u));
      for (int w = 0; w < NWARPS; ++w) {
        const int c = iscratch[16 + w];
        slot += w < warp ? c : 0;
        nm += c;
      }
      if (keep && slot < O) {
        for (int c = 0; c < 9; ++c) {
          const float v = pm[c * N + k];
          (c < 3 ? om[c * O + slot] : oc[(c - 3) * O + slot]) = isfinite(v) ? v : 0.f;
        }
        olw[slot] = cmiss[k];
        isl[slot] = -1;
      }
      __syncthreads();
    }
  }
  // each row's survivors in (weight desc, index asc) order: one warp per row
  // gathers them (ballot prefix) into its list and each ranks itself against
  // the list; a row with more survivors than the list holds ranks each
  // against the whole row
  {
    float* sv = lists + warp * 2 * LIST_CAP;
    int* sk = reinterpret_cast<int*>(sv + LIST_CAP);
    for (int j = warp; j < M; j += NWARPS) {
      const int take = rowcnt[j];
      if (take == 0) continue;
      const float* row = cpair + j * N;
      const int first = n_miss + rowoff[j];
      auto place = [&](float v, int k, int r) {
        const int slot = first + r;
        if (r < take && slot < O) {
          isl[slot] = j * N + k;
          olw[slot] = v;
        }
      };
      int n = 0;
      for (int base = 0; base < N; base += 32) {
        const int k = base + lane;
        const float v = k < N ? row[k] : -INFINITY;
        const bool keep = v > tau;
        const uint32_t bal = __ballot_sync(FULL, keep);
        const int pos = n + __popc(bal & ((1u << lane) - 1u));
        if (keep && pos < LIST_CAP) {
          sv[pos] = v;
          sk[pos] = k;
        }
        n += __popc(bal);
      }
      __syncwarp();
      if (n <= LIST_CAP) {
        for (int e = lane; e < n; e += 32) {
          const float v = sv[e];
          int r = 0;
          for (int u = 0; u < n; ++u) {
            const float x = sv[u];
            r += (x > v) || (x == v && u < e);
          }
          place(v, sk[e], r);
        }
      } else {
        for (int k = lane; k < N; k += 32) {
          const float v = row[k];
          if (!(v > tau)) continue;
          int r = 0;
          for (int u = 0; u < N; ++u) r += (row[u] > v) || (row[u] == v && u < k);
          place(v, k, r);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int slot = t; slot < O; slot += THREADS) {  // the pair survivors' moments
    const int f = isl[slot];
    if (f < 0) continue;
    const int j = f / N, k = f - j * N;
    float in[D];
    for (int c = 0; c < D; ++c) in[c] = zs[c * M + j] - h[c * N + k];
    for (int i = 0; i < 3; ++i) {
      float gd = gain[(D * i) * N + k] * in[0];
      for (int c = 1; c < D; ++c) gd = gd + gain[(D * i + c) * N + k] * in[c];
      const float mu = pm[i * N + k] + gd;
      om[i * O + slot] = isfinite(mu) ? mu : 0.f;
    }
    for (int c = 0; c < 6; ++c) oc[c * O + slot] = covu[c * N + k];
  }
  __syncthreads();
  probe(clk, 6);

  // ---- greedy weight-ordered merge over the O live slots --------------------------------
  ar.lo = 0;  // stage A's tables are dead: the merge's take their room
  float* wt = ar.up(O, W.w);
  int* lead = reinterpret_cast<int*>(ar.up(O, W.lead));
  uint32_t* lbits = reinterpret_cast<uint32_t*>(ar.up(NWO, W.lbits));
  float* rmean = ar.up(3 * (size_t)O, W.rmean);  // rank-ordered means and metrics, so lanes
  float* rinv = ar.up(6 * (size_t)O, W.rinv);    // over consecutive ranks read distinct banks
  uint32_t* bits = reinterpret_cast<uint32_t*>(ar.up((size_t)O * NWO, W.bits));  // row k = member
  for (int i = t; i < O; i += THREADS) {
    wt[i] = expf(olw[i]);
    isl[i] = 1;
  }
  for (int i = t; i < O * NWO; i += THREADS) bits[i] = 0u;
  __syncthreads();
  for (int i = t; i < O; i += THREADS) {  // (weight desc, index asc) rank: lead[rank] = index
    const float w = wt[i];
    int r = 0;
#pragma unroll 8
    for (int u = 0; u < O; ++u) {  // branch-free, so the loads pipeline
      const float wu = wt[u];
      r += (wu > w) | ((wu == w) & (u < i));
    }
    lead[r] = i;
  }
  __syncthreads();
  for (int q = t; q < O; q += THREADS) {  // each leader metric, in rank order
    const int i = lead[q];
    float c6[6], a[3][3], o[3][3];
    for (int c = 0; c < 6; ++c) c6[c] = oc[c * O + i];
    sym_to_mat(c6, a);
    inv3(a, det3(a), o);  // exactly symmetric: a is, and inv3 pairs equal products
    const int up[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
    for (int c = 0; c < 6; ++c) rinv[c * O + q] = o[up[c][0]][up[c][1]];
    for (int c = 0; c < 3; ++c) rmean[c * O + q] = om[c * O + i];
  }
  __syncthreads();
  // lower(i, k) = i heavier than k, within the merge distance of i's
  // metric: one warp per member k, its lanes over the heavier ranks only; a
  // hit sets its bit with atomicOr (order-free, so exact)
  const float thr2 = prm[P_MERGE] * prm[P_MERGE];
  for (int a = warp; a < O; a += NWARPS) {
    const int k = lead[a];
    const float mk[3] = {rmean[a], rmean[O + a], rmean[2 * O + a]};
    for (int q = lane; q < a; q += 32) {
      float d[3], c6[6], m[3][3];
      for (int c = 0; c < 3; ++c) d[c] = mk[c] - rmean[c * O + q];
      for (int c = 0; c < 6; ++c) c6[c] = rinv[c * O + q];
      sym_to_mat(c6, m);
      if (quadform(d, m) < thr2) {
        const int i = lead[q];
        atomicOr(&bits[k * NWO + (i >> 5)], 1u << (i & 31));
      }
    }
  }
  __syncthreads();
  probe(clk, 7);
  for (int round = 0; round <= merge_rounds; ++round) {
    for (int base = warp * 32; base < NWO * 32; base += THREADS) {
      const int k = base + lane;
      const uint32_t b = __ballot_sync(FULL, k < O && isl[k]);
      if (lane == 0) lbits[base >> 5] = b;
    }
    __syncthreads();
    if (round == merge_rounds) break;
    for (int k = t; k < O; k += THREADS) {
      bool conflict = false;
      for (int wi = 0; wi < NWO; ++wi) conflict |= (bits[k * NWO + wi] & lbits[wi]) != 0u;
      isl[k] = !conflict;
    }
    __syncthreads();
  }
  for (int k = t; k < O; k += THREADS) {  // heaviest eligible leader, lowest index on ties
    int best = k;
    float mw = -1.f;
    for (int wi = 0; wi < NWO; ++wi) {
      uint32_t e = bits[k * NWO + wi] & lbits[wi];
      while (e) {
        const int b = __ffs(e) - 1;
        e &= e - 1u;
        const int i = wi * 32 + b;
        if (wt[i] > mw) {
          mw = wt[i];
          best = i;
        }
      }
    }
    lead[k] = best;
  }
  __syncthreads();
  probe(clk, 8);
  // member words: bit k of row i set when k follows leader i (the
  // relation's words are free again); OR is order-free, so this is exact
  for (int i = t; i < O * NWO; i += THREADS) bits[i] = 0u;
  __syncthreads();
  for (int k = t; k < O; k += THREADS) atomicOr(&bits[lead[k] * NWO + (k >> 5)], 1u << (k & 31));
  __syncthreads();
  const size_t leaf = (size_t)P * K;
  for (int i = t; i < O; i += THREADS) {  // moments pooled about the leader mean
    float acc[16];
    for (int c = 0; c < 16; ++c) acc[c] = 0.f;
    if (isl[i]) {
      for (int wi = 0; wi < NWO; ++wi) {  // members in index order
        uint32_t e = bits[i * NWO + wi];
        while (e) {
          const int k = wi * 32 + __ffs(e) - 1;
          e &= e - 1u;
          const float w = wt[k];
          float dv[3];
          for (int a = 0; a < 3; ++a) dv[a] = om[a * O + k] - om[a * O + i];
          acc[0] += w;
          for (int a = 0; a < 3; ++a) acc[1 + a] += w * dv[a];
          acc[4] += w * dv[0] * dv[0];
          acc[5] += w * dv[0] * dv[1];
          acc[6] += w * dv[0] * dv[2];
          acc[7] += w * dv[1] * dv[1];
          acc[8] += w * dv[1] * dv[2];
          acc[9] += w * dv[2] * dv[2];
          for (int c = 0; c < 6; ++c) acc[10 + c] += w * oc[c * O + k];
        }
      }
    }
    const bool out_alive = isl[i] && acc[0] > 0.f;
    const float safe = jmax(acc[0], 1e-30f);
    const float dm[3] = {acc[1] / safe, acc[2] / safe, acc[3] / safe};
    const int up[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
    const float eye6[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
    float* out = cor + (size_t)p * K + i;
    for (int a = 0; a < 3; ++a) out[a * leaf] = out_alive ? om[a * O + i] + dm[a] : 0.f;
    for (int c = 0; c < 6; ++c) {
      const float spread = acc[4 + c] / safe - dm[up[c][0]] * dm[up[c][1]];
      out[(3 + c) * leaf] = out_alive ? acc[10 + c] / safe + spread : eye6[c];
    }
    out[9 * leaf] = out_alive ? logf(safe) : DEAD;
  }
  // the empty slots [O, K): the plain version's fill, one leaf at a time
  for (int c = 0; c < 10; ++c) {
    const float v = c == 9 ? DEAD : (c == 3 || c == 6 || c == 8) ? 1.f : 0.f;
    float* out = cor + c * leaf + (size_t)p * K;
    for (int i = O + t; i < K; i += THREADS) out[i] = v;
  }
  probe(clk, 9);
}

template <class Mdl>
int launch(const float* prm, const float* pose, const float* maps, const float* z,
           const int* zmask, int zmask_stride, float* pred, float* cor, float* work, int P,
           int K0, int M, int gate_top, int merge_rounds, const ModelParams& mp, long long* clk,
           cudaStream_t stream) {
  static std::atomic<size_t> smem_done[kMaxDevices];  // per instantiation
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = live_smem_bytes();
  auto kernel = fused_stage_kernel_live<Mdl>;
  cudaError_t err = allow_smem((const void*)kernel, smem_done, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<P, THREADS, smem, stream>>>(prm, pose, maps, z, zmask, zmask_stride, pred, cor, work, P,
                                       K0, M, gate_top, merge_rounds, mp, clk);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block asks for: a fixed 72 KB at every shape.
extern "C" size_t fused_stage_smem_bytes(int, int) { return live_smem_bytes(); }

// f32 words of one particle's workspace (LiveWs).
extern "C" size_t fused_stage_workspace_floats(int K0, int M) { return LiveWs(K0, M).total; }

// meas_dim 3 = PRM3D, 2 = Linear2D, 1 = Linear1D. prm [16 + D + D*D]; pose
// [P, S]; maps [10, P, K0]; z [M, D] f32; zmask int32, [M] shared by every
// particle (zmask_stride 0) or [P, M] one row per particle (zmask_stride M); pred [10, P, K0+M]
// and cor [10, P, K0] f32 out; work: [P, fused_stage_workspace_floats] f32
// scratch; m0..m7 the model's parameters (ModelParams); clk [P, NPHASE+1]
// int64 phase clocks, or null (the main path).
extern "C" int fused_stage_launch(int meas_dim, const float* prm, const float* pose,
                                  const float* maps, const float* z, const int* zmask,
                                  int zmask_stride, float* pred, float* cor, float* work, int P,
                                  int K0, int M,
                                  int gate_top, int merge_rounds, float m0, float m1, float m2,
                                  float m3, float m4, float m5, float m6, float m7,
                                  long long* clk, void* stream) {
  if (P == 0) return 0;
  const ModelParams mp{{m0, m1, m2, m3, m4, m5, m6, m7}};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (meas_dim) {
    case 3: return launch<Prm3d>(prm, pose, maps, z, zmask, zmask_stride, pred, cor, work, P, K0, M,
                                 gate_top, merge_rounds, mp, clk, st);
    case 2: return launch<Linear<2>>(prm, pose, maps, z, zmask, zmask_stride, pred, cor, work, P, K0,
                                     M, gate_top, merge_rounds, mp, clk, st);
    case 1: return launch<Linear<1>>(prm, pose, maps, z, zmask, zmask_stride, pred, cor, work, P, K0,
                                     M, gate_top, merge_rounds, mp, clk, st);
  }
  return (int)cudaErrorInvalidValue;
}
