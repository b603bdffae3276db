// Association beam scan for every particle in one launch.
//
// Replaces: monorfs_tpu/slam/beam_pallas.py::beam_scan_batch (Pallas body
// _beam_kernel), the weight stage's set-likelihood beam.
//
// What it computes, per particle: scan M measurements; expand B hypotheses
// by C+1 options each (clutter, or one of C gated landmarks not yet in the
// hypothesis's packed used-set words); keep the top B sorted descending,
// ties to the lower flat index (lax.top_k's order); the new words are the
// source row's words OR the picked landmark's bit. Output: final scores.
//
// Bound on the H100: neither bytes (~0.5 MB in, 26 KB out) nor operations
// (~2.4 M compares a particle): a latency-bound chain of M dependent steps,
// three barriers each.
//
// Design: one block per particle, one thread per candidate (B*(C+1) = 224
// at the bench shape). Scores and words stay in shared memory across the
// M-step loop. Each step (1) forms every candidate, (2) gives each its exact
// rank by counting the candidates that beat it in (value desc, index asc)
// order -- a rank below B writes that slot, so the top-B is exact with no
// sort -- and (3) gathers the new words from the source rows. Candidate
// sums are `scores[src] + delta` in float32, as the plain version adds
// them, so the result is bit-identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;

__global__ void beam_scan_kernel(const float* __restrict__ base,
                                 const float* __restrict__ od,
                                 const int* __restrict__ wk,
                                 const int* __restrict__ bk,
                                 float* __restrict__ out,
                                 int M, int C, int B, int NW) {
  extern __shared__ float smem[];
  const int C1 = C + 1;
  const int NC = B * C1;
  float* scores = smem;                                 // [B]
  float* cand = scores + B;                             // [NC]
  int* sel = reinterpret_cast<int*>(cand + NC);         // [B]
  uint32_t* words = reinterpret_cast<uint32_t*>(sel + B);  // [B * NW]
  uint32_t* nwords = words + B * NW;                    // [B * NW]

  const int p = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < B; i += blockDim.x) scores[i] = (i == 0) ? base[p] : NEG;
  for (int i = t; i < B * NW; i += blockDim.x) words[i] = 0u;
  __syncthreads();

  const float* odp = od + (size_t)p * M * C1;
  const int* wkp = wk + (size_t)p * M * C;
  const uint32_t* bkp = reinterpret_cast<const uint32_t*>(bk) + (size_t)p * M * C;

  for (int m = 0; m < M; ++m) {
    const float* dk = odp + m * C1;
    const int* wkm = wkp + m * C;
    const uint32_t* bkm = bkp + m * C;

    // (1) candidates: flat index b * (C+1) + c, c = 0 clutter
    for (int i = t; i < NC; i += blockDim.x) {
      const int b = i / C1, c = i - (i / C1) * C1;
      float v;
      if (c == 0) {
        v = scores[b] + dk[0];
      } else {
        const int w = wkm[c - 1];
        const uint32_t uw = (w >= 0 && w < NW) ? words[b * NW + w] : 0u;
        const bool used = (uw & bkm[c - 1]) != 0u;
        v = scores[b] + (used ? NEG : dk[c]);
      }
      cand[i] = v;
    }
    __syncthreads();

    // (2) exact rank in (value desc, flat index asc) order
    for (int i = t; i < NC; i += blockDim.x) {
      const float v = cand[i];
      int r = 0;
      for (int u = 0; u < NC; ++u) {
        const float x = cand[u];
        r += (x > v) || (x == v && u < i);
      }
      if (r < B) sel[r] = i;
    }
    __syncthreads();

    // (3) new scores and words from the source rows
    for (int r = t; r < B; r += blockDim.x) {
      const int s = sel[r];
      const int src = s / C1, choice = s - (s / C1) * C1;
      scores[r] = cand[s];
      const int pw = choice > 0 ? wkm[choice - 1] : 0;
      const uint32_t pb = choice > 0 ? bkm[choice - 1] : 0u;
      for (int w = 0; w < NW; ++w)
        nwords[r * NW + w] = words[src * NW + w] | (pw == w ? pb : 0u);
    }
    __syncthreads();
    uint32_t* tmp = words;
    words = nwords;
    nwords = tmp;
  }
  for (int i = t; i < B; i += blockDim.x) out[(size_t)p * B + i] = scores[i];
}

size_t smem_bytes(int C, int B, int NW) {
  return sizeof(float) * (size_t)(B + B * (C + 1)) + sizeof(int) * (size_t)B +
         sizeof(uint32_t) * (size_t)(2 * B * NW);
}

}  // namespace

extern "C" size_t beam_scan_smem_bytes(int C, int B, int NW) {
  return smem_bytes(C, B, NW);
}

// base [P], od [P, M, C+1] f32; wk, bk [P, M, C] int32; out [P, B] f32.
extern "C" int beam_scan_launch(const float* base, const float* od,
                                const int* wk, const int* bk, float* out,
                                int P, int M, int C, int B, int NW,
                                void* stream) {
  if (P == 0) return 0;
  const size_t smem = smem_bytes(C, B, NW);
  cudaError_t err = cudaFuncSetAttribute(
      beam_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((B * (C + 1) + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  beam_scan_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(
      base, od, wk, bk, out, M, C, B, NW);
  return (int)cudaGetLastError();
}
