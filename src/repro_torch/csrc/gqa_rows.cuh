// The AMLA row body shared by the GQA kernels (K6 decode, K7 prefill).
//
// One CTA owns a tile of R = 8 * RPW query rows that read the same KV head
// (b, h / group) and walks that head's KV blocks of block_k rows in order.
// Per block the tile's scores against the block's keys are scaled, soft-
// capped, clamped to +-M_CLAMP and masked (k_pos < kv_len, causal k_pos <=
// q_pos, window k_pos > q_pos - window); each row then takes ONE online-
// softmax update with the AMLA MUL-by-ADD rescale (an int32 add on the
// fp32 accumulator's bits, skipped where it is zero; "base" multiplies
// instead), and P·V accumulates.  Output rows are normalized fp32, exact
// zeros for a row that saw no key.
//
// Layout.  Keys are read where they lie: K and V are (B, Hkv, S, Dh) with
// any batch/head/sequence strides and unit stride along Dh, so a dense
// cache or a slot of it is never copied.  A 512-key block of K at Dh 256 is
// 256 KB, above what a CTA may hold, so keys are staged in passes of 4096
// elements (128 keys x 32 dims for the scores, 4096 / Dh keys x Dh for
// P·V), loaded as 16-byte vectors into registers one pass ahead and
// stored into one of two shared buffers, so each pass costs one barrier
// and its loads overlap the previous pass's arithmetic.  The block's full
// R x block_k score strip stays in shared memory: the row max, and so the
// single per-block state update, is known before P·V.  Each warp owns RPW
// rows end to end (scores, softmax, state, accumulator in registers), so
// the state update needs warp shuffles only.
//
// Skipping.  Keys that every row of the tile masks are never read: past
// kv_len, past the tile's largest q_pos (causal) and before the window of
// its smallest q_pos; a block with none left is skipped whole.  A block a
// row cannot see leaves that row's state unchanged (m, l, n, gamma stay,
// the increment is 0), so skipping it changes no number.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "amla.cuh"

namespace gqa {
namespace {

constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 128;                       // keys per score strip
constexpr int kKeysPerLane = kStrip / 32;         // 4
constexpr int kDChunkMax = 32;                    // key dims per score pass
constexpr int kPassElems = 4096;                  // elements staged per pass
constexpr int kVecPerThread = kPassElems / 8 / kThreads;  // 2 vectors of 8
constexpr int kStageFloats = kStrip * (kDChunkMax + 1);   // one buffer
constexpr int kDhMax = 256;
constexpr int kColsPerLane = kDhMax / 32;         // 8 accumulator columns
constexpr int kBlockKMax = 512;

struct Params {
  const void* q;       // (B, H, R, Dh) contiguous
  const void* k;       // (B, Hkv, S, Dh) strided, unit stride along Dh
  const void* v;
  float* o;            // (B, H, R, Dh)
  const int* kv_len;   // (B,)
  const int* q_pos;    // (B, R) row positions, or null: position = row index
  int H, R, group, Dh, S, block_k;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale, softcap;  // softcap <= 0: off
  int window;            // <= 0: off
  int causal;
};

template <int RPW>
size_t smem_bytes(const Params& p) {
  constexpr int R = kWarps * RPW;
  return sizeof(float) * (static_cast<size_t>(R) * p.Dh +
                          static_cast<size_t>(R) * p.block_k + 2 * kStageFloats) +
         sizeof(int) * R;
}

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for fp32).
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* out) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// One staging pass held in registers: rows key0 .. key0 + nkeys - 1 (at
// most `rows_cap`) of a matrix with row stride `ss`, columns d0 .. d0 +
// 8 * vpr - 1; missing rows read as zeros.
struct Pass {
  float x[kVecPerThread][8];
};

template <typename T>
__device__ __forceinline__ void pass_load(Pass& pf, const T* base, long long ss,
                                          int key0, int nkeys, int d0, int vpr,
                                          int rows_cap) {
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int vi = threadIdx.x + kThreads * u;
    const int key = vi / vpr;
    const int part = vi - key * vpr;
    if (key < rows_cap && key < nkeys) {
      load8(base + (key0 + key) * ss + d0 + 8 * part, pf.x[u]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) pf.x[u][e] = 0.0f;
    }
  }
}

__device__ __forceinline__ void pass_store(const Pass& pf, float* buf, int sstride,
                                           int vpr, int rows_cap) {
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int vi = threadIdx.x + kThreads * u;
    const int key = vi / vpr;
    const int part = vi - key * vpr;
    if (key < rows_cap) {
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[key * sstride + 8 * part + e] = pf.x[u][e];
    }
  }
}

template <typename T, bool kAmla, int RPW>
__global__ void __launch_bounds__(kThreads, 1) gqa_rows_kernel(Params p) {
  constexpr int R = kWarps * RPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);                  // R x Dh
  float* sS = sQ + R * p.Dh;                                        // R x block_k
  float* sStage = sS + R * p.block_k;                               // 2 buffers
  int* sQPos = reinterpret_cast<int*>(sStage + 2 * kStageFloats);  // R

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Dh = p.Dh, bk = p.block_k;

  const T* q = static_cast<const T*>(p.q) + (static_cast<size_t>(b) * p.H + h) * p.R * Dh;
  const int hkv = h / p.group;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hkv * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hkv * p.v_sh;

  for (int idx = tid; idx < R * Dh; idx += kThreads) {
    const int r = row0 + idx / Dh;
    sQ[idx] = r < p.R ? amla::to_float(q[static_cast<size_t>(r) * Dh + idx % Dh]) : 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int rr = row0 + r;
    // Rows past R (a ragged last tile) get position -1 and are not written.
    sQPos[r] = rr < p.R ? (p.q_pos != nullptr ? p.q_pos[static_cast<size_t>(b) * p.R + rr] : rr) : -1;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = -1;
  for (int r = 0; r < R && row0 + r < p.R; ++r) {
    qmin = min(qmin, sQPos[r]);
    qmax = max(qmax, sQPos[r]);
  }

  // Row state of the warp's RPW rows, held redundantly by all its lanes.
  int n0;
  float inv_r0;
  amla::round_scale_to_pow2(amla::kMInit, &n0, &inv_r0);
  float m[RPW], l[RPW], gamma[RPW], s16[RPW];
  int n[RPW];
  float acc[RPW][kColsPerLane];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = amla::kMInit;
    l[i] = 0.0f;
    n[i] = n0;
    gamma[i] = 1.0f;
    s16[i] = amla::bf16_round(inv_r0);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;
  }

  const int dch = Dh < kDChunkMax ? Dh : kDChunkMax;  // dims per score pass
  const int nch = Dh / dch;
  const int vk = min(kStrip, kPassElems / Dh);        // keys per P·V pass
  const int k_len = min(p.kv_len[b], p.S);
  Pass pf;

  for (int start = 0; start < k_len; start += bk) {
    // The block's columns [lo, hi) that some row of the tile can see.
    int hi = min(bk, k_len - start);
    if (p.causal) hi = min(hi, qmax - start + 1);
    const int lo = p.window > 0 ? max(0, qmin - p.window + 1 - start) : 0;
    if (hi <= lo) continue;

    // ---- scores: sS[r][col] = q_r . k_col over columns [lo, hi) -------
    const int npass = (hi - lo + kStrip - 1) / kStrip * nch;
    __syncthreads();  // the last block's P·V is done with the stage buffers
    pass_load(pf, kb, p.k_ss, start + lo, min(kStrip, hi - lo), 0, dch / 8, kStrip);
    float sacc[RPW][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = 0.0f;
    }
    for (int it = 0; it < npass; ++it) {
      const int strip = it / nch;
      const int ch = it - strip * nch;
      float* buf = sStage + (it & 1) * kStageFloats;
      pass_store(pf, buf, dch + 1, dch / 8, kStrip);
      __syncthreads();
      if (it + 1 < npass) {
        const int s2 = (it + 1) / nch;
        const int k0 = lo + s2 * kStrip;
        pass_load(pf, kb, p.k_ss, start + k0, min(kStrip, hi - k0),
                  ((it + 1) - s2 * nch) * dch, dch / 8, kStrip);
      }
      const int d0 = ch * dch;
      for (int dd = 0; dd < dch; ++dd) {
        float qv[RPW], kv[kKeysPerLane];
#pragma unroll
        for (int i = 0; i < RPW; ++i) qv[i] = sQ[(warp * RPW + i) * Dh + d0 + dd];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) kv[j] = buf[(lane + 32 * j) * (dch + 1) + dd];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
        }
      }
      if (ch == nch - 1) {
        const int k0 = lo + strip * kStrip;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j) {
            const int col = k0 + lane + 32 * j;
            if (col < hi) sS[(warp * RPW + i) * bk + col] = sacc[i][j];
            sacc[i][j] = 0.0f;
          }
        }
      }
    }
    __syncwarp();  // each warp reads back only its own rows

    // ---- one online-softmax + AMLA state update per row per block -----
    int inc[RPW];
    float alpha[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float* srow = sS + (warp * RPW + i) * bk;
      const int qp = sQPos[warp * RPW + i];
      // scale, then softcap, then clamp, then mask to -inf
      float rmax = -INFINITY;
      for (int col = lo + lane; col < hi; col += 32) {
        const int kpos = start + col;
        float x = -INFINITY;
        if ((!p.causal || kpos <= qp) && (p.window <= 0 || kpos > qp - p.window)) {
          x = __fmul_rn(srow[col], p.scale);
          if (p.softcap > 0.0f) x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
          x = fminf(fmaxf(x, -amla::kMClamp), amla::kMClamp);
        }
        srow[col] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = amla::warp_max(rmax);
      const float m_prev = m[i];
      const float m_new = fmaxf(m_prev, rmax);
      float psum = 0.0f;
      for (int col = lo + lane; col < hi; col += 32) {
        const float e = expf(__fsub_rn(srow[col], m_new));
        srow[col] = e;
        psum += e;
      }
      psum = amla::warp_sum(psum);
      l[i] = __fadd_rn(__fmul_rn(l[i], expf(__fsub_rn(m_prev, m_new))), psum);
      m[i] = m_new;
      if (kAmla) {
        int n_new;
        float inv_r;
        amla::round_scale_to_pow2(m_new, &n_new, &inv_r);
        const float s = amla::bf16_round(inv_r);
        const float g_new = __fdiv_rn(inv_r, s);
        const float eps = __fsub_rn(__fdiv_rn(gamma[i], g_new), 1.0f);
        inc[i] = amla::pow2_int_increment(n_new - n[i], eps);
        n[i] = n_new;
        gamma[i] = g_new;
        s16[i] = s;
        // p_v = p * S16, rounded to the matmul dtype before P·V
        for (int col = lo + lane; col < hi; col += 32) {
          srow[col] = amla::round_to<T>(__fmul_rn(srow[col], s));
        }
      } else {
        alpha[i] = expf(__fsub_rn(m_prev, m_new));
        for (int col = lo + lane; col < hi; col += 32) srow[col] = amla::round_to<T>(srow[col]);
      }
    }

    // ---- rescale: MUL-by-ADD, skipped per row where the increment is 0 --
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (kAmla) {
        if (inc[i] != 0) {
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = amla::apply_int_increment(acc[i][j], inc[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha[i]);
      }
    }

    // ---- P·V over columns [lo, hi) -------------------------------------
    const int npv = (hi - lo + vk - 1) / vk;
    __syncthreads();  // every warp is done with the score buffers
    pass_load(pf, vb, p.v_ss, start + lo, min(vk, hi - lo), 0, Dh / 8, vk);
    for (int it = 0; it < npv; ++it) {
      float* buf = sStage + (it & 1) * kStageFloats;
      pass_store(pf, buf, Dh, Dh / 8, vk);
      __syncthreads();
      const int kc = lo + it * vk;
      if (it + 1 < npv) {
        pass_load(pf, vb, p.v_ss, start + kc + vk, min(vk, hi - kc - vk), 0, Dh / 8, vk);
      }
      const int klim = min(vk, hi - kc);
      for (int key = 0; key < klim; ++key) {
        float pv[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) pv[i] = sS[(warp * RPW + i) * bk + kc + key];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = lane + 32 * j;
          if (c < Dh) {
            const float v = buf[key * Dh + c];
#pragma unroll
            for (int i = 0; i < RPW; ++i) acc[i][j] = fmaf(pv[i], v, acc[i][j]);
          }
        }
      }
    }
  }

  // ---- finalize: o = acc / (l * S16) (amla) or acc / l, 0 when empty -----
  float* o = p.o + (static_cast<size_t>(b) * p.H + h) * p.R * Dh;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    if (r >= p.R) continue;
    const float denom = kAmla ? __fmul_rn(l[i], s16[i]) : l[i];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < Dh) o[static_cast<size_t>(r) * Dh + c] = denom > 0.0f ? __fdiv_rn(acc[i][j], denom) : 0.0f;
    }
  }
}

// Geometry the kernel takes: Dh a multiple of 8 up to 256 that the 32-dim
// score passes divide, block_k in [1, 512], grid within CUDA's limits.
inline bool valid(const Params& p, int B) {
  return p.Dh >= 8 && p.Dh <= kDhMax && p.Dh % 8 == 0 &&
         (p.Dh <= kDChunkMax || p.Dh % kDChunkMax == 0) && p.block_k >= 1 &&
         p.block_k <= kBlockKMax && B >= 1 && B <= 65535 && p.H >= 1 &&
         p.H <= 65535 && p.R >= 1 && p.group >= 1 && p.S >= 0;
}

template <typename T, bool kAmla, int RPW>
cudaError_t launch_typed(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<RPW>(p);
  auto kernel = gqa_rows_kernel<T, kAmla, RPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int R = kWarps * RPW;
  const dim3 grid((p.R + R - 1) / R, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launch on `stream` for bf16 (`bf16` != 0) or fp32 inputs.
template <int RPW>
cudaError_t launch(const Params& p, int B, int amla, int bf16, cudaStream_t stream) {
  if (!valid(p, B)) return cudaErrorInvalidValue;
  if (bf16) {
    return amla ? launch_typed<__nv_bfloat16, true, RPW>(p, B, stream)
                : launch_typed<__nv_bfloat16, false, RPW>(p, B, stream);
  }
  return amla ? launch_typed<float, true, RPW>(p, B, stream)
              : launch_typed<float, false, RPW>(p, B, stream);
}

}  // namespace
}  // namespace gqa
