// The weight stage's two mixture likelihoods for every particle in one launch.
//
// Replaces no Pallas kernel: in the JAX package this stage is XLA
// (monorfs_tpu/slam/phd.py's weight inputs). The port ran it as eager
// PyTorch, slam/mixture_kernel.py::mixture_rest_plain: two calls of
// gm/mixture.py::log_evaluate_many_soa, each building [P, E, K] float32
// tensors through ~135 elementwise launches, then masking away the dead
// slots and the invalid MAP rows it had computed. At the chap3 grid's 2000
// particles (K = 548 and 500 slots, E = 128 MAP rows) those chains took
// ~44 device ms a frame on an H100 (80 GB HBM3, 700 W), ~87% of the card's
// busy time.
//
// What it computes, per particle p:
//   rest[p] = (LL(pred) - N(pred)) - (LL(cor) - N(cor)),
//   LL(gm)  = sum over rows e with jvalid[p, e] of
//             max(clamp(log sum_k exp(logw_k + logp_k(x_e)), min DEAD), LOG_EVAL_FLOOR),
//   N(gm)   = sum over live k of exp(logw_k),
// over the live components (logw > ALIVE_THRESHOLD) only, x_e the MAP
// means. logp_k is the Gaussian log-density with the inverse and the
// log-multiplier of gm/smallmat.py (cofactors over det, the quadratic form
// summed in its order), a non-finite logp taken as DEAD: with -fmad=false
// every pair's score is bit-equal to the plain version's, and a row's log-
// sum-exp is taken as there (the row's max, then the sum of exp(s - max)),
// so a row differs from the plain version's only by the order of that sum,
// and the result by the order of the sums over rows and components. A dead
// slot or an invalid row adds exactly 0 in the plain version (exp(DEAD - peak)
// underflows to 0 whenever the row's peak is above DEAD; a row whose peak is
// not clamps to LOG_EVAL_FLOOR either way), so skipping them is exact.
//
// Bound on the H100: bytes. Both maps' 10 leaves and the MAP means are read
// once, ~88 MB at P = 2000 (26 us at 3.35 TB/s); the work, even dense,
// is ~8e9 fp32 operations (0.12 ms at 67 TFLOP/s), and the live pairs of
// the chap3 maps far fewer.
//
// Design: one block of 256 threads per particle; no intermediate leaves the
// block. Per map, the block walks the slots in chunks of 256: a thread
// reads its slot's log-weight, the warps ballot the live ones, and a prefix
// over the eight warps' counts compacts them, in slot order, into a tile in
// shared memory; each live slot's thread computes its inverse (6 unique
// entries; the adjugate of a symmetric matrix is symmetric bit for bit) and
// log-multiplier once, there, and adds exp(logw) to its share of N. The
// tile holds up to round_up(K, 32) components, at most TILE_MAX; a map with
// more live components than the tile holds is walked in tiles (a tile is
// evaluated when the next chunk might not fit), and a row then merges its
// tiles' (max, sum) pairs online. The eight warps take the valid MAP rows
// (e = warp, warp + 8, ...); the lanes of a warp walk the tile's
// components, first for the row's max, then for its sum of exp, each closed
// by a butterfly over the warp and lane 0's value kept. Lane 0 of each warp
// keeps its rows' sum; the block adds the warps' sums in warp order, so a
// result does not change from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr float DEAD = -1.0e30f;
constexpr float ALIVE_THRESHOLD = -0.5e30f;
constexpr float LOG_EVAL_FLOOR = -690.77552789821368f;
constexpr float LOG2PI3 = 5.5136311992280365f;  // 3 log(2 pi), as smallmat's n * LOG2PI
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_MAX = 2048;  // components a tile holds at most (88 KB)
constexpr int FIELDS = 11;      // mean 3, inverse 6, log-multiplier, log-weight

std::atomic<size_t> smem_set[kMaxDevices];

struct Map {
  const float* leaf[10];  // SGM order: mx my mz cxx cxy cxz cyy cyz czz logw; each [P, K]
  int k;
};

// Components a tile holds: every slot of the larger map, rounded up to a
// warp, at least one chunk, at most TILE_MAX.
inline int tile_size(int k_max) {
  int t = ((k_max > 1 ? k_max : 1) + 31) / 32 * 32;
  if (t > TILE_MAX) t = TILE_MAX;
  return t < THREADS ? THREADS : t;
}

inline size_t smem_bytes(int k_max, int e) {
  return sizeof(float) * ((size_t)FIELDS * tile_size(k_max) + 2 * (size_t)e + 2 * WARPS) +
         sizeof(int) * WARPS;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Butterfly sum; every lane ends with a sum, lane 0's is the one kept.
__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}

// Fields of a tile's components, each [tile]: mx my mz, the inverse's
// i00 i01 i02 i11 i12 i22, the log-multiplier, the log-weight.
struct Tile {
  float* base;
  int stride;
  __device__ float& f(int field, int c) const { return base[field * stride + c]; }
};

// logw + logp of tile component c at point (px, py, pz), in the plain
// version's operation order (gm/mixture.py::_pairwise, smallmat.quadform).
__device__ inline float score(const Tile& t, int c, float px, float py, float pz) {
  const float dx = px - t.f(0, c), dy = py - t.f(1, c), dz = pz - t.f(2, c);
  const float i00 = t.f(3, c), i01 = t.f(4, c), i02 = t.f(5, c);
  const float i11 = t.f(6, c), i12 = t.f(7, c), i22 = t.f(8, c);
  float q = dx * i00 * dx;
  q = q + dx * i01 * dy;
  q = q + dx * i02 * dz;
  q = q + dy * i01 * dx;
  q = q + dy * i11 * dy;
  q = q + dy * i12 * dz;
  q = q + dz * i02 * dx;
  q = q + dz * i12 * dy;
  q = q + dz * i22 * dz;
  float logp = t.f(9, c) - 0.5f * q;
  if (!isfinite(logp)) logp = DEAD;
  return t.f(10, c) + logp;
}

// The tile's n components against every valid row this warp owns: the
// row's (max, sum of exp(s - max)) merged into (row_m, row_s).
__device__ void evaluate(const Tile& t, int n, const float* jx, const float* jy, const float* jz,
                         const bool* jvalid, int e_count, int se, float* row_m, float* row_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < e_count; e += WARPS) {
    if (!jvalid[e]) continue;
    const float px = jx[e * se], py = jy[e * se], pz = jz[e * se];
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, score(t, c, px, py, pz));
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < n; c += 32) s = s + expf(score(t, c, px, py, pz) - m);
    s = warp_sum(s);
    if (lane == 0) {
      if (row_s[e] == 0.0f) {  // the row's first tile
        row_m[e] = m;
        row_s[e] = s;
      } else {
        const float top = fmaxf(row_m[e], m);
        row_s[e] = row_s[e] * expf(row_m[e] - top) + s * expf(m - top);
        row_m[e] = top;
      }
    }
  }
}

// LL(gm) - N(gm) of this block's particle, in thread 0 (every thread
// returns; only thread 0's value is the result).
__device__ float map_term(const Map& map, int p, const Tile& t, int tile, const float* jx, const float* jy,
                          const float* jz, const bool* jvalid, int e_count, int se, float* row_m,
                          float* row_s, int* warp_n, float* warp_f) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = map.k;
  for (int e = tid; e < e_count; e += THREADS) row_s[e] = 0.0f;
  __syncthreads();
  float size = 0.0f;  // this thread's share of N(gm)
  int count = 0;      // components in the tile
  const size_t row = (size_t)p * k;
  for (int c0 = 0; c0 < k; c0 += THREADS) {
    const int chunk = k - c0 < THREADS ? k - c0 : THREADS;
    if (count + chunk > tile) {  // uniform: every thread holds the same count
      evaluate(t, count, jx, jy, jz, jvalid, e_count, se, row_m, row_s);
      __syncthreads();
      count = 0;
    }
    const int slot = c0 + tid;
    float lw = DEAD;
    if (slot < k) lw = map.leaf[9][row + slot];
    const bool live = lw > ALIVE_THRESHOLD;
    const unsigned ballot = __ballot_sync(FULL, live);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = warp_n[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (live) {
      const int c = count + before + __popc(ballot & ((1u << lane) - 1u));
      const float cxx = map.leaf[3][row + slot], cxy = map.leaf[4][row + slot];
      const float cxz = map.leaf[5][row + slot], cyy = map.leaf[6][row + slot];
      const float cyz = map.leaf[7][row + slot], czz = map.leaf[8][row + slot];
      // smallmat.det / inv / log_multiplier on [[cxx cxy cxz] [cxy cyy cyz] [cxz cyz czz]]
      const float det = cxx * (cyy * czz - cyz * cyz) - cxy * (cxy * czz - cyz * cxz) +
                        cxz * (cxy * cyz - cyy * cxz);
      const float r = 1.0f / det;
      t.f(0, c) = map.leaf[0][row + slot];
      t.f(1, c) = map.leaf[1][row + slot];
      t.f(2, c) = map.leaf[2][row + slot];
      t.f(3, c) = (cyy * czz - cyz * cyz) * r;
      t.f(4, c) = (cxz * cyz - cxy * czz) * r;
      t.f(5, c) = (cxy * cyz - cxz * cyy) * r;
      t.f(6, c) = (cxx * czz - cxz * cxz) * r;
      t.f(7, c) = (cxz * cxy - cxx * cyz) * r;
      t.f(8, c) = (cxx * cyy - cxy * cxy) * r;
      t.f(9, c) = -0.5f * (LOG2PI3 + logf(det));
      t.f(10, c) = lw;
      size = size + expf(lw);
    }
    count += total;
    __syncthreads();  // the tile's writes seen; warp_n free again
  }
  if (count > 0) {
    evaluate(t, count, jx, jy, jz, jvalid, e_count, se, row_m, row_s);
  }
  // each warp closes its own rows (those evaluate wrote), so no barrier here
  float ll = 0.0f;
  if (lane == 0) {
    for (int e = warp; e < e_count; e += WARPS) {
      if (!jvalid[e]) continue;
      float out = row_s[e] == 0.0f ? DEAD : row_m[e] + logf(row_s[e]);
      out = out < DEAD ? DEAD : out;                      // clamp(min=DEAD)
      out = out < LOG_EVAL_FLOOR ? LOG_EVAL_FLOOR : out;  // clamp(min=LOG_EVAL_FLOOR)
      ll = ll + out;
    }
  }
  size = warp_sum(size);
  if (lane == 0) {
    warp_f[warp] = ll;
    warp_f[WARPS + warp] = size;
  }
  __syncthreads();
  float term = 0.0f;
  if (tid == 0) {
    float ll_sum = 0.0f, n_sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      ll_sum = ll_sum + warp_f[w];
      n_sum = n_sum + warp_f[WARPS + w];
    }
    term = ll_sum - n_sum;
  }
  __syncthreads();  // warp_f, row_m, row_s and the tile free for the next map
  return term;
}

__global__ void __launch_bounds__(THREADS) mixture_ll_kernel(Map pred, Map cor, const float* jx,
                                                             const float* jy, const float* jz,
                                                             const bool* jvalid, int e_count,
                                                             long long sp, int se, int tile,
                                                             float* rest) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const Tile t{smem, tile};
  float* row_m = smem + (size_t)FIELDS * tile;
  float* row_s = row_m + e_count;
  float* warp_f = row_s + e_count;
  int* warp_n = reinterpret_cast<int*>(warp_f + 2 * WARPS);
  const size_t off = (size_t)p * sp;
  const bool* valid = jvalid + (size_t)p * e_count;
  const float a = map_term(pred, p, t, tile, jx + off, jy + off, jz + off, valid, e_count, se, row_m,
                           row_s, warp_n, warp_f);
  const float b = map_term(cor, p, t, tile, jx + off, jy + off, jz + off, valid, e_count, se, row_m,
                           row_s, warp_n, warp_f);
  if (threadIdx.x == 0) rest[p] = a - b;
}

}  // namespace

extern "C" size_t mixture_ll_smem_bytes(int k_max, int e) { return smem_bytes(k_max, e); }

// pred / cor: 10 leaf pointers each ([P, KP] / [P, KC] f32, contiguous);
// jx, jy, jz: the MAP means [P, E] with strides (sp, se) in floats; jvalid
// [P, E] bool, contiguous; rest [P] f32.
extern "C" int mixture_ll_launch(const void* const* pred, const void* const* cor, int P, int KP,
                                 int KC, const float* jx, const float* jy, const float* jz,
                                 const bool* jvalid, int E, long long sp, int se, float* rest,
                                 void* stream) {
  if (P == 0) return 0;
  const int k_max = KP > KC ? KP : KC;
  const size_t smem = smem_bytes(k_max, E);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  Map mp, mc;
  for (int i = 0; i < 10; ++i) {
    mp.leaf[i] = static_cast<const float*>(pred[i]);
    mc.leaf[i] = static_cast<const float*>(cor[i]);
  }
  mp.k = KP;
  mc.k = KC;
  const cudaError_t err = allow_smem((const void*)mixture_ll_kernel, smem_set, smem);
  if (err != cudaSuccess) return (int)err;
  mixture_ll_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(
      mp, mc, jx, jy, jz, jvalid, E, sp, se, tile_size(k_max), rest);
  return (int)cudaGetLastError();
}
