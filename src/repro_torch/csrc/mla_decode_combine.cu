// Split-KV combine for work-queue AMLA decode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mla_decode_combine.py:
// _combine_kernel / combine_split_partials (K3).
//
// What it computes.  For each request b and query row g, the LSE-weighted
// merge of the first n_splits[b] partial slots named in dest_table[b]:
//   out = sum_j exp(lse_j - M) o_j / sum_j exp(lse_j - M),  M = max_j lse_j,
// as a running (acc, m, w) merge whose max starts at BIG_NEG, so an empty
// partial (lse = -inf) weighs exactly 0 and a request with no live split
// gives exact zeros.
//
// What bounds it on an H100: bytes — the live partial rows (Dv fp32 + one
// lse each) read once and the (B, G, Dv) output written once, at 3.35 TB/s.
//
// Design.  The TPU grid walks the splits in order with the state in VMEM;
// here one CTA takes one (request, row) and walks its few splits itself,
// each of its 128 threads owning 4 of the Dv columns, so the reads of a
// partial row are coalesced and the merge weights are two scalar expf per
// split.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;  // Dv <= 512
constexpr float kBigNeg = -3.0e38f;

__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ o_part, const float* __restrict__ lse,
                   const int* __restrict__ dest_table, const int* __restrict__ n_splits,
                   float* __restrict__ out, int G, int Dv, int S) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int live = n_splits[b];
  float acc[kColsPerThread];
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) acc[k] = 0.0f;
  float m = kBigNeg, w = 0.0f;
  for (int j = 0; j < S && j < live; ++j) {
    const int slot = dest_table[b * S + j];
    const float lj = lse[static_cast<size_t>(slot) * G + g];
    const float m_new = fmaxf(m, lj);
    const float alpha = expf(m - m_new);
    const float wj = expf(lj - m_new);  // 0 for an empty partial (lse = -inf)
    const float* o = o_part + (static_cast<size_t>(slot) * G + g) * Dv;
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) {
      const int c = threadIdx.x + k * kThreads;
      if (c < Dv) acc[k] = acc[k] * alpha + wj * o[c];
    }
    w = w * alpha + wj;
    m = m_new;
  }
  float* dst = out + (static_cast<size_t>(b) * G + g) * Dv;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < Dv) dst[c] = w > 0.0f ? acc[k] / w : 0.0f;
  }
}

}  // namespace

// ---- host launcher ----

// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int amla_combine_split_partials(const float* o_part, const float* lse,
                                           const int* dest_table, const int* n_splits,
                                           float* out, int B, int G, int Dv, int S,
                                           void* stream) {
  if (Dv > kThreads * kColsPerThread || B < 1 || G < 1 || S < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  combine_kernel<<<dim3(G, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o_part, lse, dest_table, n_splits, out, G, Dv, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
