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
// shape; 12.8 MB in at k9's P=2000 M=64) nor operations (~4 M at the bench
// shape): each particle is a chain of M dependent steps, a step needing the
// previous step's B rows, so a launch takes at least M times the latency of
// one step, however wide the card. Both designs shorten that chain and keep
// many particles resident on each SM, so that their chains overlap.
//
// Warp design for B <= 32, C+1 <= 8 and NW <= 4 (the bench shape: B = 32,
// C = 6, NW = 2): one warp per particle, several particles per block, no
// block barrier. The particle's options (1.8 KB) are staged into shared
// memory once, so no step touches device memory; a step's options are then
// read once into registers, the same for every lane. Lane b holds beam row
// b: its score and its used-set words in registers. It forms the row's C+1
// candidates and sorts them (value desc, option asc) as 64-bit keys (an
// order-preserving map of the value above 7 - c) with Batcher's
// 19-comparator network. The warp then takes the best B in order in B
// rounds of a warp argmax over the lanes' heads: __reduce_max_sync over the
// value keys, a ballot of the lanes at the maximum, the lowest such lane
// wins and shifts its list. A lower lane is a lower row and a row's list
// keeps the lower option first, so ties follow the flat index b (C+1) + c as
// lax.top_k does. A round moves only keys; afterwards lane r finds the
// winner of round r's option from the winner's won-rounds mask, and its
// score and words by shuffle. The chain is B rounds of about eight
// dependent instructions, REDUX latency first.
//
// Block design for every other shape (the default PHDConfig's B = 200,
// C = 8, NW = 4: the command line, the grids, k9; and the smoother's B = 32,
// C = 8, NW = 1): one block of at most 256 threads per particle, thread t
// owning the K candidates of flat indices [t K, t K + K), K the fewest of
// 2, 4, ..., 32 that fit; past 8,192 candidates (B >= 911 at C = 8) a
// block of at most 1024 threads, K the fewest of 16, 32, 64 that fit, up
// to 65,535 candidates (the scan of step 3 packs two 16-bit counts) or
// until the layout outgrows a block's shared memory (B = 4,768 at C = 8,
// NW = 4, M = 24). The options are staged into shared memory once, as in
// the warp design. A step:
//   1. each thread forms its candidates' order keys once, in registers;
//   2. a radix select finds the B-th largest key: per 8-bit digit from the
//      top, a shared histogram (integer atomics, so the counts do not depend
//      on their order) of the keys that match the digits fixed so far, then
//      warp 0 scans it for the bin that holds the B-th; a pass whose bin is
//      taken whole ends the search;
//   3. a block scan of (above, at) counts places the keys above the found
//      prefix and, of those at it, the ones with the lowest flat index (the
//      (value, ~flat) 64-bit key is unique and orders as lax.top_k does)
//      into B slots;
//   4. each kept key's rank among the B, by counting, is its new row: the
//      source row's score and words with the picked option added.
// At most 11 block barriers a step, against the 66 of the bitonic sort of
// all B(C+1) candidates that this design replaces, which ran one 1024-thread
// block an SM. __launch_bounds__(256, 8) caps a thread at 32 registers
// (ptxas -v: 32 at every K, with 56 bytes of stack at K = 8), so an SM holds
// 8 particles' 256-thread blocks: the grid's P=800 runs in one wave and
// P=2000 in two. At the smoother's B = 32, C = 8 (K = 2, 160 threads) this
// design also beat the warp design widened to 16 option slots
// (chip_smoke.py's beam-block line, PERF.md), which was therefore not kept.
// The 1024-thread block runs one block an SM at up to 64 registers a
// thread; its K = 64 keeps part of its keys in local memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_util.cuh"

namespace {

constexpr float NEG = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // shared memory one H100 block may use
constexpr int WARP_PARTICLES = 4;    // particles (warps) per block of the warp design
constexpr int NWMAX = 4;             // used-set words a lane keeps in registers there
constexpr int BLOCK_THREADS = 256;   // threads of one particle's block, at most
constexpr int BLOCK_RESIDENT = 8;    // blocks an SM must hold at once (caps registers at 32)
constexpr int WIDE_THREADS = 1024;   // the block past BLOCK_THREADS x 32 candidates
constexpr int MAX_CANDIDATES = 65535;  // B(C+1) the block scan's 16-bit counts hold
constexpr int RADIX = 256;           // bins of one radix-select pass (8 bits)

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

// 4-byte word offsets of the block design's shared memory
struct BlockLayout {
  size_t sel, od, wk, bk, scores, words, hist, wsum, state, total;
};

__host__ __device__ inline BlockLayout block_layout(int M, int C, int B, int NW) {
  BlockLayout l;
  l.sel = 0;                                       // u64 [B + 1]: the step's kept keys, 0-padded
  l.od = l.sel + 2 * ((size_t)B + 1);              // f32 [M, C+1]: the staged options
  l.wk = l.od + (size_t)M * (C + 1);               // int [M, C]
  l.bk = l.wk + (size_t)M * C;                     // u32 [M, C]
  l.scores = l.bk + (size_t)M * C;                 // f32 [2, B]: this step's beam and the next
  l.words = l.scores + 2 * (size_t)B;              // u32 [2, B, NW]
  l.hist = (l.words + 2 * (size_t)B * NW + 3) & ~(size_t)3;  // int [256], 16-byte aligned
  l.wsum = l.hist + RADIX;                         // u32 [32]: per-warp totals of the scan
  l.state = l.wsum + 32;                           // int [3]: prefix, need, done
  l.total = l.state + 4;
  return l;
}

// One block of at most T threads per particle (R of them resident an SM);
// thread t owns the K candidates of flat indices [t K, t K + K).
template <int K, int T_MAX, int R>
__global__ void __launch_bounds__(T_MAX, R)
beam_scan_block_kernel(const float* __restrict__ base, const float* __restrict__ od,
                       const int* __restrict__ wk, const int* __restrict__ bk,
                       float* __restrict__ out, int M, int C, int B, int NW) {
  extern __shared__ __align__(16) uint32_t bsm[];
  const BlockLayout L = block_layout(M, C, B, NW);
  u64* sel = reinterpret_cast<u64*>(bsm + L.sel);
  float* sod = reinterpret_cast<float*>(bsm + L.od);
  int* swk = reinterpret_cast<int*>(bsm + L.wk);
  uint32_t* sbk = bsm + L.bk;
  float* scores = reinterpret_cast<float*>(bsm + L.scores);
  uint32_t* words = bsm + L.words;
  int* hist = reinterpret_cast<int*>(bsm + L.hist);
  uint32_t* wsum = bsm + L.wsum;
  int* state = reinterpret_cast<int*>(bsm + L.state);

  const int C1 = C + 1, NC = B * C1;
  const int p = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5;

  // stage the particle's options; the first beam is row 0 = base, the rest empty
  const float* odp = od + (size_t)p * M * C1;
  const int* wkp = wk + (size_t)p * M * C;
  const uint32_t* bkp = reinterpret_cast<const uint32_t*>(bk) + (size_t)p * M * C;
  for (int i = t; i < M * C1; i += T) sod[i] = odp[i];
  for (int i = t; i < M * C; i += T) {
    swk[i] = wkp[i];
    sbk[i] = bkp[i];
  }
  for (int i = t; i < B; i += T) scores[i] = i == 0 ? base[p] : NEG;
  for (int i = t; i < B * NW; i += T) words[i] = 0u;
  for (int i = t; i < RADIX; i += T) hist[i] = 0;
  if (t == 0) sel[B] = 0ull;
  __syncthreads();

  const int f0 = t * K;
  const int b0 = f0 / C1, c0 = f0 - b0 * C1;
  int cur = 0;
  for (int m = 0; m < M; ++m) {
    const float* dk = sod + m * C1;
    const int* wkm = swk + m * C;
    const uint32_t* bkm = sbk + m * C;
    const float* s = scores + cur * B;
    const uint32_t* rw = words + (size_t)cur * B * NW;

    // each candidate's order key, once
    uint32_t hi[K];
    {
      int b = b0, c = c0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        hi[i] = f0 + i < NC ? order_key(s[b] + option_delta(dk, wkm, bkm, rw + b * NW, c, NW)) : 0u;
        if (++c == C1) {
          c = 0;
          ++b;
        }
      }
    }

    // radix select of the B-th largest order key, 8 bits a pass from the
    // top: a histogram of the digit among the keys that match the digits
    // fixed so far (bin 255 - digit, so the bins run from the largest), then
    // warp 0 finds the bin that holds the B-th key and clears what it read
    uint32_t prefix = 0u, mask = 0u;
    int need = B;  // keys still to take from those that match prefix
    for (int sh = 24; sh >= 0; sh -= 8) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const bool in = f0 + i < NC && ((hi[i] ^ prefix) & mask) == 0u;
        if (in) atomicAdd(&hist[255u - ((hi[i] >> sh) & 255u)], 1);
      }
      __syncthreads();
      if (warp == 0) {
        const int4 lo4 = reinterpret_cast<const int4*>(hist)[2 * lane];
        const int4 hi4 = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
        const int cnt[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
        reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);
        int sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += cnt[j];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(FULL, incl, o);
          incl += lane >= o ? x : 0;
        }
        if (lane == __ffs(__ballot_sync(FULL, incl >= need)) - 1) {
          int above = incl - sum, bin = 0, h = 0;
          bool found = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool here = !found && above + cnt[j] >= need;
            bin = here ? 8 * lane + j : bin;
            h = here ? cnt[j] : h;
            above += found || here ? 0 : cnt[j];
            found = found || here;
          }
          state[0] = (int)(prefix | ((255u - (uint32_t)bin) << sh));
          state[1] = need - above;
          state[2] = h == need - above;  // the bin is taken whole: no later pass needed
        }
      }
      __syncthreads();
      prefix = (uint32_t)state[0];
      need = state[1];
      mask |= 255u << sh;
      if (state[2]) break;
    }

    // keep every key above prefix, and of the keys at prefix the `need`
    // with the lowest flat index: a block scan of (above, at) counts gives
    // each thread its first slot in sel
    int gt = 0, eq = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t h = hi[i] & mask;
      gt += f0 + i < NC && h > prefix;
      eq += f0 + i < NC && h == prefix;
    }
    const uint32_t packed = ((uint32_t)gt << 16) | (uint32_t)eq;
    uint32_t incl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(FULL, incl, o);
      incl += lane >= o ? x : 0u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    uint32_t excl = incl - packed;
    for (int w = 0; w < warp; ++w) excl += wsum[w];
    int at = (int)(excl & 0xffffu);
    int pos = (int)(excl >> 16) + (at < need ? at : need);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t h = hi[i] & mask;
      const bool take = f0 + i < NC && (h > prefix || (h == prefix && at < need));
      at += f0 + i < NC && h == prefix;
      if (take) sel[pos++] = ((u64)hi[i] << 32) | (uint32_t)~(uint32_t)(f0 + i);
    }
    __syncthreads();

    // each kept key's rank among the B is its new row: the source row's
    // score and words with the picked option added
    float* ns = scores + (cur ^ 1) * B;
    uint32_t* nw = words + (size_t)(cur ^ 1) * B * NW;
    const ulonglong2* sel2 = reinterpret_cast<const ulonglong2*>(sel);
    for (int r = t; r < B; r += T) {
      const u64 k = sel[r];
      int rank = 0;
      for (int j = 0; j < (B + 1) / 2; ++j) {
        const ulonglong2 q = sel2[j];
        rank += (q.x > k) + (q.y > k);
      }
      const int f = (int)~(uint32_t)k;
      const int b = f / C1, c = f - b * C1;
      ns[rank] = s[b] + option_delta(dk, wkm, bkm, rw + b * NW, c, NW);
      next_words(wkm, bkm, rw + b * NW, nw + rank * NW, c, NW);
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = t; i < B; i += T) out[(size_t)p * B + i] = scores[cur * B + i];
}

// candidates a thread of the block design owns: the fewest of 2..32 that
// fit NC candidates into BLOCK_THREADS threads, else the fewest of 16..64
// that fit them into WIDE_THREADS (0: the shape is too large)
int block_k(int NC) {
  for (int k = 2; k <= 32; k <<= 1)
    if ((NC + k - 1) / k <= BLOCK_THREADS) return k;
  if (NC > MAX_CANDIDATES) return 0;
  for (int k = 16; k <= 64; k <<= 1)
    if ((NC + k - 1) / k <= WIDE_THREADS) return k;
  return 0;
}

bool use_warp(int M, int C, int B, int NW) {
  return B <= 32 && C + 1 <= 8 && NW <= NWMAX && 4 * warp_words(M, C) <= SMEM_MAX;
}

int warps_per_block(int M, int C) {
  const size_t fit = SMEM_MAX / (4 * warp_words(M, C));
  return fit < (size_t)WARP_PARTICLES ? (int)fit : WARP_PARTICLES;
}

// 0: no design takes the shape
size_t smem_bytes(int M, int C, int B, int NW) {
  if (use_warp(M, C, B, NW)) return 4 * warp_words(M, C) * warps_per_block(M, C);
  if (block_k(B * (C + 1)) == 0) return 0;
  const size_t bytes = 4 * block_layout(M, C, B, NW).total;
  return bytes <= SMEM_MAX ? bytes : 0;
}

std::atomic<size_t> smem_set_w[kMaxDevices];

// the 256-thread block for K <= 32 at most 8,192 candidates, else the 1024-thread one
template <int K, int T_MAX, int R>
cudaError_t launch_block(const float* base, const float* od, const int* wk, const int* bk,
                         float* out, int P, int M, int C, int B, int NW, size_t smem,
                         cudaStream_t stream) {
  static std::atomic<size_t> smem_set[kMaxDevices];  // per instantiation
  cudaError_t err = allow_smem((const void*)beam_scan_block_kernel<K, T_MAX, R>, smem_set, smem);
  if (err != cudaSuccess) return err;
  const int threads = (((B * (C + 1) + K - 1) / K + 31) / 32) * 32;
  beam_scan_block_kernel<K, T_MAX, R><<<P, threads, smem, stream>>>(base, od, wk, bk, out, M, C, B, NW);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block asks for at this shape (the design the launch
// picks); 0 when neither design takes it.
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (use_warp(M, C, B, NW)) {
    const int warps = warps_per_block(M, C);
    const cudaError_t err = allow_smem((const void*)beam_scan_warp_kernel, smem_set_w, smem);
    if (err != cudaSuccess) return (int)err;
    beam_scan_warp_kernel<<<(P + warps - 1) / warps, 32 * warps, smem, st>>>(
        base, od, wk, bk, out, P, M, C, B, NW);
    return (int)cudaGetLastError();
  }
  constexpr int BT = BLOCK_THREADS, BR = BLOCK_RESIDENT, WT = WIDE_THREADS;
  const bool wide = B * (C + 1) > BLOCK_THREADS * 32;
  switch (block_k(B * (C + 1))) {
    case 2: return (int)launch_block<2, BT, BR>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
    case 4: return (int)launch_block<4, BT, BR>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
    case 8: return (int)launch_block<8, BT, BR>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
    case 16:
      return wide ? (int)launch_block<16, WT, 1>(base, od, wk, bk, out, P, M, C, B, NW, smem, st)
                  : (int)launch_block<16, BT, BR>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
    case 32:
      return wide ? (int)launch_block<32, WT, 1>(base, od, wk, bk, out, P, M, C, B, NW, smem, st)
                  : (int)launch_block<32, BT, BR>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
    default: return (int)launch_block<64, WT, 1>(base, od, wk, bk, out, P, M, C, B, NW, smem, st);
  }
}
