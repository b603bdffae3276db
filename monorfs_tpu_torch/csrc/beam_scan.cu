// Association beam scan for every particle in one launch.
//
// Replaces: monorfs_tpu/slam/beam_pallas.py::beam_scan_batch (Pallas body
// _beam_kernel), the weight stage's set-likelihood beam.
//
// What it computes, per particle: scan M measurements; expand B hypotheses
// by C+1 options each (clutter, or one of C gated landmarks not yet in the
// hypothesis's packed used-set words); keep the top B sorted descending,
// ties to the lower flat index b * (C+1) + c (lax.top_k's order); the new
// words are the source row's words OR the picked landmark's bit. Output:
// final scores. Candidate sums are `score[src] + delta` in float32, as the
// plain version adds them, so the result is bit-identical to it.
//
// Bound on the H100: neither bytes (~0.4 MB in, 26 KB out at the bench
// shape) nor operations (~4 M): a latency-bound chain of M dependent steps
// per particle. What counts is the length of one step's dependent chain;
// spreading particles over more SMs or more warps per SM does not shorten it.
//
// Design for B <= 32, C+1 <= 8 and NW <= 4 (the bench shape: B = 32, C = 6,
// NW = 2): one warp per particle, several particles per block, no block
// barrier. The particle's options (1.8 KB) are staged into shared memory
// once, so no step touches device memory; a step's options are then read
// once into registers, the same for every lane. Lane b holds beam row b:
// its score and its used-set words in registers. It forms the row's C+1
// candidates and sorts them (value desc, option asc) as 64-bit keys (an
// order-preserving map of the value above 7 - c) with Batcher's
// 19-comparator network. The warp then takes the best B in order in B
// rounds of a warp argmax over the lanes' heads: __reduce_max_sync over the
// value keys, a ballot of the lanes at the maximum, the lowest such lane
// wins and shifts its list. A lower lane is a lower row and a row's list
// keeps the lower option first, so ties follow the flat index b (C+1) + c as
// lax.top_k does. A round moves only keys; afterwards lane r finds the
// winner of round r's option from the winner's won-rounds mask, and its
// score and words by shuffle. Selection work per step is about
// NC + 32 B lane operations; the chain is B rounds of about eight dependent
// instructions, REDUX latency first: ~5 k cycles a step measured at the
// bench shape, against ~11.5 k for the 224-wide rank count it replaces.
//
// Design for every other shape (the default PHDConfig's B = 200, C = 8): one
// block per particle. Candidates are not stored: a candidate's value is
// recomputed from its row's score and words and the step's options where
// it is compared. The block sorts the candidate indices (value desc, index
// asc) with a bitonic network in which every comparator orders the same
// way, so the padding to a power of two holds minima that never move and is
// never touched; the first B indices are the new beam. Shared memory is
// B scores, B(C+1) indices and 2 B NW words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // shared memory one H100 block may use
constexpr int WARP_PARTICLES = 4;    // particles (warps) per block of the warp design
constexpr int NWMAX = 4;             // used-set words a lane keeps in registers there

// value of option c of a row whose words are rw: clutter, the landmark's
// delta, or NEG when the landmark is already in the row's used set
__device__ __forceinline__ float option_delta(const float* dk, const int* wkm,
                                              const uint32_t* bkm, const uint32_t* rw,
                                              int c, int NW) {
  if (c == 0) return dk[0];
  const int w = wkm[c - 1];
  const uint32_t uw = (w >= 0 && w < NW) ? rw[w] : 0u;
  return (uw & bkm[c - 1]) != 0u ? NEG : dk[c];
}

// the source row's words OR the picked landmark's bit (none for clutter)
__device__ __forceinline__ void next_words(const int* wkm, const uint32_t* bkm,
                                           const uint32_t* src, uint32_t* dst, int c, int NW) {
  const int pw = c > 0 ? wkm[c - 1] : -1;
  const uint32_t pb = c > 0 ? bkm[c - 1] : 0u;
  for (int w = 0; w < NW; ++w) dst[w] = src[w] | (pw == w ? pb : 0u);
}

typedef unsigned long long u64;

// Order-preserving map of a float onto uint32 (a larger float gets a larger
// key); -0 and +0 compare equal and get one key. Every float, -inf
// included, maps above 0, which marks an empty slot.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// 4-byte words of one warp's region: the staged od, wk and bk, padded so
// that a step's clamped option reads stay inside
__host__ __device__ size_t warp_words(int M, int C) {
  return (size_t)M * (C + 1) + 2 * (size_t)M * C + 2;
}

// compare-exchange, the larger key to a
__device__ __forceinline__ void cx(u64& a, u64& b) {
  const u64 hi = a > b ? a : b, lo = a > b ? b : a;
  a = hi;
  b = lo;
}

// one lane's 8 keys sorted descending (Batcher's 19-comparator network)
__device__ __forceinline__ void sort8(u64 k[8]) {
  cx(k[0], k[1]); cx(k[2], k[3]); cx(k[4], k[5]); cx(k[6], k[7]);
  cx(k[0], k[2]); cx(k[1], k[3]); cx(k[4], k[6]); cx(k[5], k[7]);
  cx(k[1], k[2]); cx(k[5], k[6]);
  cx(k[0], k[4]); cx(k[1], k[5]); cx(k[2], k[6]); cx(k[3], k[7]);
  cx(k[2], k[4]); cx(k[3], k[5]);
  cx(k[1], k[2]); cx(k[3], k[4]); cx(k[5], k[6]);
}

// word w of a row's used set (w0..w3); 0 outside [0, NWMAX), where the
// words past NW are 0 too; selects only, no branch
__device__ __forceinline__ uint32_t word_at(int w, uint32_t w0, uint32_t w1, uint32_t w2,
                                            uint32_t w3) {
  const uint32_t lo = (w & 1) ? w1 : w0, hi = (w & 1) ? w3 : w2;
  return (unsigned)w < (unsigned)NWMAX ? ((w & 2) ? hi : lo) : 0u;
}

__global__ void __launch_bounds__(32 * WARP_PARTICLES)
beam_scan_warp_kernel(const float* __restrict__ base, const float* __restrict__ od,
                      const int* __restrict__ wk, const int* __restrict__ bk,
                      float* __restrict__ out, int P, int M, int C, int B, int NW) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;  // a whole warp: the kernel has no block barrier
  const int C1 = C + 1;
  float* sod = reinterpret_cast<float*>(smem + (threadIdx.x >> 5) * warp_words(M, C));
  int* swk = reinterpret_cast<int*>(sod + M * C1);
  uint32_t* sbk = reinterpret_cast<uint32_t*>(swk + M * C);

  const float* odp = od + (size_t)p * M * C1;
  const int* wkp = wk + (size_t)p * M * C;
  const uint32_t* bkp = reinterpret_cast<const uint32_t*>(bk) + (size_t)p * M * C;
  for (int i = lane; i < M * C1; i += 32) sod[i] = odp[i];
  for (int i = lane; i < M * C; i += 32) {
    swk[i] = wkp[i];
    sbk[i] = bkp[i];
  }
  __syncwarp();

  const bool row = lane < B;
  float s = lane == 0 ? base[p] : NEG;
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;  // this row's used-set words
  for (int m = 0; m < M; ++m) {
    // the step's options, the same for every row (reads clamped, masked below)
    float dl[8];
    int ow[8];
    uint32_t ob[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ci = c - 1 < C ? (c > 0 ? c - 1 : 0) : (C > 0 ? C - 1 : 0);
      dl[c] = sod[m * C1 + (c < C1 ? c : 0)];
      ow[c] = c > 0 ? swk[m * C + ci] : -1;
      ob[c] = c > 0 ? sbk[m * C + ci] : 0u;
    }

    // this row's candidates sorted (value desc, option asc): the order key
    // of the value above 7 - c; 0 = no candidate
    u64 k8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t used = word_at(ow[c], w0, w1, w2, w3) & ob[c];
      const float v = s + (c == 0 ? dl[0] : (used != 0u ? NEG : dl[c]));
      k8[c] = (row && c < C1) ? ((u64)order_key(v) << 32) | (uint32_t)(7 - c) : 0ull;
    }
    sort8(k8);
    uint32_t key[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) key[i] = (uint32_t)(k8[i] >> 32);

    // B rounds of warp argmax over the heads: the lowest lane at the
    // maximum wins and shifts its list; lane r keeps round r's winner
    uint32_t won = 0u;  // bit r: this lane won round r
    int src = 0;
    for (int r = 0; r < B; ++r) {
      const uint32_t top = __reduce_max_sync(FULL, key[0]);
      const int win = __ffs(__ballot_sync(FULL, key[0] == top)) - 1;
      const bool me = lane == win;
      src = lane == r ? win : src;
      won |= me ? 1u << r : 0u;
#pragma unroll
      for (int i = 0; i < 7; ++i) key[i] = me ? key[i + 1] : key[i];
      key[7] = me ? 0u : key[7];
    }
    // the source row's option taken in round `lane`: its j-th best, j the
    // rounds it won before
    const int j = __popc(__shfl_sync(FULL, won, src) & ((1u << lane) - 1u));
    int pick = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = 7 - (int)(uint32_t)__shfl_sync(FULL, k8[i], src);
      pick = j == i ? o : pick;
    }

    // new row `lane`: the source row's score and words (by shuffle) with the
    // picked option added, as option_delta and next_words define them
    const float ss = __shfl_sync(FULL, s, src);
    const uint32_t s0 = __shfl_sync(FULL, w0, src), s1 = __shfl_sync(FULL, w1, src);
    const uint32_t s2 = __shfl_sync(FULL, w2, src), s3 = __shfl_sync(FULL, w3, src);
    float pd = dl[0];
    int pw = -1;
    uint32_t pb = 0u;
#pragma unroll
    for (int c = 1; c < 8; ++c) {
      pd = pick == c ? dl[c] : pd;
      pw = pick == c ? ow[c] : pw;
      pb = pick == c ? ob[c] : pb;
    }
    const uint32_t used = word_at(pw, s0, s1, s2, s3) & pb;
    const float v = ss + (pick == 0 ? pd : (used != 0u ? NEG : pd));
    w0 = 0 < NW ? s0 | (pw == 0 ? pb : 0u) : 0u;
    w1 = 1 < NW ? s1 | (pw == 1 ? pb : 0u) : 0u;
    w2 = 2 < NW ? s2 | (pw == 2 ? pb : 0u) : 0u;
    w3 = 3 < NW ? s3 | (pw == 3 ? pb : 0u) : 0u;
    s = row ? v : NEG;
  }
  if (row) out[(size_t)p * B + lane] = s;
}

__global__ void beam_scan_block_kernel(const float* __restrict__ base, const float* __restrict__ od,
                                       const int* __restrict__ wk, const int* __restrict__ bk,
                                       float* __restrict__ out, int M, int C, int B, int NW) {
  extern __shared__ uint32_t smem[];
  const int C1 = C + 1;
  const int NC = B * C1;
  float* scores = reinterpret_cast<float*>(smem);      // [B]
  int* idx = reinterpret_cast<int*>(scores + B);        // [NC]
  uint32_t* words = reinterpret_cast<uint32_t*>(idx + NC);  // [B * NW]
  uint32_t* nwords = words + B * NW;                    // [B * NW]

  const int p = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  for (int i = t; i < B; i += T) scores[i] = (i == 0) ? base[p] : NEG;
  for (int i = t; i < B * NW; i += T) words[i] = 0u;
  int npad = 1;
  while (npad < NC) npad <<= 1;

  for (int m = 0; m < M; ++m) {
    const float* dk = od + ((size_t)p * M + m) * C1;
    const int* wkm = wk + ((size_t)p * M + m) * C;
    const uint32_t* bkm = reinterpret_cast<const uint32_t*>(bk) + ((size_t)p * M + m) * C;
    auto value = [&](int f) {
      const int b = f / C1;
      return scores[b] + option_delta(dk, wkm, bkm, words + b * NW, f - b * C1, NW);
    };
    for (int i = t; i < NC; i += T) idx[i] = i;
    __syncthreads();

    // bitonic sort, every comparator (i < l) puts the better index at i;
    // positions >= NC are virtual minima and never move
    for (int k = 2; k <= npad; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = t; q < npad / 2; q += T) {
          const int i = (q / j) * 2 * j + (q % j);
          const int l = (j == k >> 1) ? (i ^ (k - 1)) : (i + j);
          if (l >= NC) continue;
          const int a = idx[i], b = idx[l];
          const float va = value(a), vb = value(b);
          if (vb > va || (vb == va && b < a)) {
            idx[i] = b;
            idx[l] = a;
          }
        }
        __syncthreads();
      }
    }

    // the first B indices: new scores (parked in idx) and words
    for (int r = t; r < B; r += T) {
      const int f = idx[r];
      const int src = f / C1;
      const float v = value(f);
      next_words(wkm, bkm, words + src * NW, nwords + r * NW, f - src * C1, NW);
      idx[r] = __float_as_int(v);
    }
    __syncthreads();
    for (int r = t; r < B; r += T) scores[r] = __int_as_float(idx[r]);
    uint32_t* tmp = words;
    words = nwords;
    nwords = tmp;
    __syncthreads();
  }
  for (int i = t; i < B; i += T) out[(size_t)p * B + i] = scores[i];
}

bool use_warp(int M, int C, int B, int NW) {
  return B <= 32 && C + 1 <= 8 && NW <= NWMAX && 4 * warp_words(M, C) <= SMEM_MAX;
}

int warps_per_block(int M, int C) {
  const size_t fit = SMEM_MAX / (4 * warp_words(M, C));
  return fit < (size_t)WARP_PARTICLES ? (int)fit : WARP_PARTICLES;
}

size_t smem_bytes(int M, int C, int B, int NW) {
  if (use_warp(M, C, B, NW)) return 4 * warp_words(M, C) * warps_per_block(M, C);
  return 4 * ((size_t)B + (size_t)B * (C + 1) + 2 * (size_t)B * NW);
}

std::atomic<size_t> smem_set_w[kMaxDevices], smem_set_b[kMaxDevices];

}  // namespace

// Shared memory one block asks for at this shape (the design the launch
// picks).
extern "C" size_t beam_scan_smem_bytes(int M, int C, int B, int NW) {
  return smem_bytes(M, C, B, NW);
}

// base [P], od [P, M, C+1] f32; wk, bk [P, M, C] int32; out [P, B] f32.
extern "C" int beam_scan_launch(const float* base, const float* od,
                                const int* wk, const int* bk, float* out,
                                int P, int M, int C, int B, int NW,
                                void* stream) {
  if (P == 0) return 0;
  const size_t smem = smem_bytes(M, C, B, NW);
  cudaError_t err;
  if (use_warp(M, C, B, NW)) {
    const int warps = warps_per_block(M, C);
    err = allow_smem((const void*)beam_scan_warp_kernel, smem_set_w, smem);
    if (err != cudaSuccess) return (int)err;
    beam_scan_warp_kernel<<<(P + warps - 1) / warps, 32 * warps, smem, (cudaStream_t)stream>>>(
        base, od, wk, bk, out, P, M, C, B, NW);
  } else {
    err = allow_smem((const void*)beam_scan_block_kernel, smem_set_b, smem);
    if (err != cudaSuccess) return (int)err;
    int npad = 1;
    while (npad < B * (C + 1)) npad <<= 1;
    int threads = ((npad / 2 + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
    beam_scan_block_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(
        base, od, wk, bk, out, M, C, B, NW);
  }
  return (int)cudaGetLastError();
}
