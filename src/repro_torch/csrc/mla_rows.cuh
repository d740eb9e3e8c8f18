// The AMLA row body shared by the MLA kernels (K2 paged, K4 contiguous).
//
// One CTA owns a tile of kRows = 32 query rows of one request (width Dk, V
// = the first Dv columns of the same latent rows) and walks that request's
// KV blocks of block_k rows in order.  Per block the tile's scores are
// taken against the live keys, scaled, soft-capped, clamped to +-M_CLAMP
// and masked (k_pos < kv_len & k_pos <= q_pos); each row then takes ONE
// online-softmax update with the AMLA MUL-by-ADD rescale (an int32 add on
// the fp32 accumulator's bits, skipped where it is zero; "base" multiplies
// instead), and P·V accumulates.  The two kernels differ only in how a key
// position is addressed (block table or contiguous rows), which is the
// `key_off` functor handed to block_update.
//
// int8 pages (K2-int8) store symmetric per-row int8 latents with one fp32
// scale sigma per row.  The block's sigma strip is staged beside its keys;
// a score is multiplied by its key's sigma right after the q.k product and
// before scale, softcap and clamp, and sigma is folded into p before P.V
// (p * S16 * sigma for amla, p * sigma for base, then rounded to the matmul
// dtype), in the reference's order, so the int8 values themselves feed
// both products unscaled.
//
// Layout.  A 512 x 576 block does not fit in shared memory, so keys are
// staged in strips (128 keys x 32 dims for the scores, 16 keys x Dv for
// P·V) while the block's full 32 x block_k score strip stays in shared
// memory: the row max, and so the single per-block state update, is known
// before P·V.  Each warp owns 4 query rows end to end (scores, softmax,
// state, accumulator in registers), so the state update needs warp
// shuffles only.  Keys past kv_len, and past the tile's largest q_pos, are
// never read: every row masks them, so skipping them changes no number.
#pragma once

#include <cuda_runtime.h>

#include "amla.cuh"

namespace mla_rows {

constexpr int kRows = 32;                       // query rows per CTA
constexpr int kThreads = 256;                   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;    // 4 rows owned by each warp
constexpr int kStrip = 128;                     // keys per score strip
constexpr int kKeysPerLane = kStrip / 32;       // 4 keys per lane
constexpr int kDChunk = 32;                     // key dims staged per pass
constexpr int kVKeys = 16;                      // keys staged per P·V pass
constexpr int kDvMax = 512;
constexpr int kColsPerLane = kDvMax / 32;       // 16 value columns per lane
constexpr int kBlockKMax = 512;

// Row geometry and score transform of one launch.
struct Geom {
  int G, Dk, Dv, block_k;
  float scale, softcap;  // softcap <= 0: off
};

__host__ __device__ inline int stage_floats(int Dv) {
  const int a = kStrip * (kDChunk + 1), b = kVKeys * Dv;
  return a > b ? a : b;
}

// Floats of the block's sigma strip, even so that row_off stays 8-aligned.
__host__ __device__ inline int sigma_floats(int block_k) { return (block_k + 1) & ~1; }

inline size_t smem_bytes(const Geom& g) {
  return sizeof(float) *
             (static_cast<size_t>(kRows) * g.Dk +
              static_cast<size_t>(kRows) * g.block_k + stage_floats(g.Dv) +
              sigma_floats(g.block_k)) +
         sizeof(long long) * kStrip + sizeof(int) * kRows;
}

// The CTA's dynamic shared memory, carved.
struct Smem {
  float* q;             // kRows x Dk
  float* s;             // kRows x block_k
  float* stage;         // key strips
  float* sigma;         // block_k per-key dequant scales (int8 pages)
  long long* row_off;   // kStrip key-row offsets of the current strip
  int* q_pos;           // kRows
};

__device__ __forceinline__ Smem carve(unsigned char* raw, const Geom& g) {
  Smem sm;
  sm.q = reinterpret_cast<float*>(raw);
  sm.s = sm.q + kRows * g.Dk;
  sm.stage = sm.s + kRows * g.block_k;
  sm.sigma = sm.stage + stage_floats(g.Dv);
  sm.row_off = reinterpret_cast<long long*>(sm.sigma + sigma_floats(g.block_k));
  sm.q_pos = reinterpret_cast<int*>(sm.row_off + kStrip);
  return sm;
}

// Stage the tile's query rows (G rows of width Dk starting at `q`) and
// their positions; rows past G get position -1, so every key masks.
// Returns the largest position of the tile (-1 when it has no row).
template <typename TQ>
__device__ __forceinline__ int load_tile(const Smem& sm, const Geom& g,
                                         const TQ* q, const int* q_pos,
                                         int row0) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kRows * g.Dk; idx += kThreads) {
    const int r = row0 + idx / g.Dk;
    sm.q[idx] = r < g.G ? amla::to_float(q[static_cast<size_t>(r) * g.Dk + idx % g.Dk]) : 0.0f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sm.q_pos[r] = row0 + r < g.G ? q_pos[row0 + r] : -1;
  }
  __syncthreads();
  int qmax = -1;
  for (int r = 0; r < kRows; ++r) qmax = max(qmax, sm.q_pos[r]);
  return qmax;
}

// Online-softmax state of the warp's 4 rows, held redundantly by all its
// lanes, and their fp32 accumulators (16 value columns per lane).
template <bool kAmla>
struct RowState {
  float m[kRowsPerWarp], l[kRowsPerWarp], gamma[kRowsPerWarp], s16[kRowsPerWarp];
  int n[kRowsPerWarp];
  float acc[kRowsPerWarp][kColsPerLane];

  __device__ __forceinline__ void init() {
    int n0;
    float inv_r0;
    amla::round_scale_to_pow2(amla::kMInit, &n0, &inv_r0);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = amla::kMInit;
      l[i] = 0.0f;
      n[i] = n0;
      gamma[i] = 1.0f;
      s16[i] = amla::bf16_round(inv_r0);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;
    }
  }
};

// One state update of the tile over the keys [start, start + live) of a
// block (live > 0; the rest of the block is masked for every row).
// `key_off(pos)` is the element offset of key row `pos` in `kv`; with
// `scales` (int8 pages) the key's sigma is scales[key_off(pos) / Dk].
template <typename TQ, typename TP, bool kAmla, typename KeyOff>
__device__ __forceinline__ void block_update(RowState<kAmla>& st, const Smem& sm,
                                             const Geom& g, const TP* kv,
                                             int start, int live,
                                             KeyOff key_off,
                                             const float* scales = nullptr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // The block's sigma strip; 0 past live (p is 0 there), as the reference
  // zero-fills the scale strip past kv_len.  Every warp finished reading
  // the previous block's strip before that block's P.V barriers.
  if (scales != nullptr) {
    for (int col = tid; col < g.block_k; col += kThreads) {
      sm.sigma[col] = col < live ? scales[key_off(start + col) / g.Dk] : 0.0f;
    }
  }

  // ---- scores: s[r][col] = q_r . k_col over the live keys ----------------
  for (int ks = 0; ks < live; ks += kStrip) {
    __syncthreads();  // the previous strip is done with row_off / stage
    for (int key = tid; key < kStrip; key += kThreads) {
      sm.row_off[key] = ks + key < live ? key_off(start + ks + key) : -1;
    }
    float sacc[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = 0.0f;
    }
    for (int d0 = 0; d0 < g.Dk; d0 += kDChunk) {
      __syncthreads();  // row_off is written; the last chunk is consumed
      for (int idx = tid; idx < kStrip * kDChunk; idx += kThreads) {
        const int key = idx / kDChunk;
        const int dd = idx - key * kDChunk;
        const long long off = sm.row_off[key];
        float v = 0.0f;
        if (off >= 0 && d0 + dd < g.Dk) v = amla::round_to<TQ>(amla::to_float(kv[off + d0 + dd]));
        sm.stage[key * (kDChunk + 1) + dd] = v;
      }
      __syncthreads();
      const int dlim = min(kDChunk, g.Dk - d0);
      for (int dd = 0; dd < dlim; ++dd) {
        float qv[kRowsPerWarp], kv_[kKeysPerLane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) qv[i] = sm.q[(warp * kRowsPerWarp + i) * g.Dk + d0 + dd];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) kv_[j] = sm.stage[(lane + 32 * j) * (kDChunk + 1) + dd];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = fmaf(qv[i], kv_[j], sacc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int col = ks + lane + 32 * j;
        if (col < g.block_k) sm.s[(warp * kRowsPerWarp + i) * g.block_k + col] = sacc[i][j];
      }
    }
  }
  __syncwarp();  // each warp reads back only its own rows

  // ---- one online-softmax + AMLA state update per row per block ---------
  int inc[kRowsPerWarp];
  float alpha[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* srow = sm.s + (warp * kRowsPerWarp + i) * g.block_k;
    const int qp = sm.q_pos[warp * kRowsPerWarp + i];
    // scale, then softcap, then clamp, then mask to -inf
    float rmax = -INFINITY;
    for (int col = lane; col < g.block_k; col += 32) {
      float x = -INFINITY;
      if (col < live && start + col <= qp) {
        x = scales != nullptr ? __fmul_rn(srow[col], sm.sigma[col]) : srow[col];
        x = __fmul_rn(x, g.scale);
        if (g.softcap > 0.0f) x = __fmul_rn(g.softcap, tanhf(__fdiv_rn(x, g.softcap)));
        x = fminf(fmaxf(x, -amla::kMClamp), amla::kMClamp);
      }
      srow[col] = x;
      rmax = fmaxf(rmax, x);
    }
    rmax = amla::warp_max(rmax);
    const float m_prev = st.m[i];
    const float m_new = fmaxf(m_prev, rmax);
    float psum = 0.0f;
    for (int col = lane; col < g.block_k; col += 32) {
      const float e = expf(__fsub_rn(srow[col], m_new));
      srow[col] = e;
      psum += e;
    }
    psum = amla::warp_sum(psum);
    st.l[i] = __fadd_rn(__fmul_rn(st.l[i], expf(__fsub_rn(m_prev, m_new))), psum);
    st.m[i] = m_new;
    if (kAmla) {
      int n_new;
      float inv_r;
      amla::round_scale_to_pow2(m_new, &n_new, &inv_r);
      const float s = amla::bf16_round(inv_r);
      const float g_new = __fdiv_rn(inv_r, s);
      const float eps = __fsub_rn(__fdiv_rn(st.gamma[i], g_new), 1.0f);
      inc[i] = amla::pow2_int_increment(n_new - st.n[i], eps);
      st.n[i] = n_new;
      st.gamma[i] = g_new;
      st.s16[i] = s;
      // p_v = p * S16 (* sigma), rounded to the matmul dtype before P·V
      for (int col = lane; col < g.block_k; col += 32) {
        float pv = __fmul_rn(srow[col], s);
        if (scales != nullptr) pv = __fmul_rn(pv, sm.sigma[col]);
        srow[col] = amla::round_to<TQ>(pv);
      }
    } else {
      alpha[i] = expf(__fsub_rn(m_prev, m_new));
      for (int col = lane; col < g.block_k; col += 32) {
        const float pv = scales != nullptr ? __fmul_rn(srow[col], sm.sigma[col]) : srow[col];
        srow[col] = amla::round_to<TQ>(pv);
      }
    }
  }

  // ---- rescale: MUL-by-ADD, skipped per row where the increment is 0 ----
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (kAmla) {
      if (inc[i] != 0) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) st.acc[i][j] = amla::apply_int_increment(st.acc[i][j], inc[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) st.acc[i][j] = __fmul_rn(st.acc[i][j], alpha[i]);
    }
  }

  // ---- P·V with V = the first Dv columns of the same rows ---------------
  for (int kc = 0; kc < live; kc += kVKeys) {
    __syncthreads();  // every warp is done with the previous stage
    for (int idx = tid; idx < kVKeys * g.Dv; idx += kThreads) {
      const int key = idx / g.Dv;
      const int c = idx - key * g.Dv;
      float v = 0.0f;
      if (kc + key < live) v = amla::round_to<TQ>(amla::to_float(kv[key_off(start + kc + key) + c]));
      sm.stage[idx] = v;
    }
    __syncthreads();
    const int klim = min(kVKeys, live - kc);
    for (int key = 0; key < klim; ++key) {
      float pv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pv[i] = sm.s[(warp * kRowsPerWarp + i) * g.block_k + kc + key];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        const float v = c < g.Dv ? sm.stage[key * g.Dv + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) st.acc[i][j] = fmaf(pv[i], v, st.acc[i][j]);
      }
    }
  }
}

// Finalize the warp's rows: o = acc / (l * S16) (amla) or acc / l, 0 when
// empty, into `o` (rows of Dv starting at tile row 0); with `lse` (one
// float per row) also lse = m + log l (-inf when empty).
template <bool kAmla>
__device__ __forceinline__ void finalize(const RowState<kAmla>& st, const Geom& g,
                                         int row0, float* o, float* lse) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    if (r >= g.G) continue;
    const float denom = kAmla ? __fmul_rn(st.l[i], st.s16[i]) : st.l[i];
    float* orow = o + static_cast<size_t>(r) * g.Dv;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < g.Dv) orow[c] = denom > 0.0f ? __fdiv_rn(st.acc[i][j], denom) : 0.0f;
    }
    // lse in standard units (m is the true running max, l the plain mass).
    if (lse != nullptr && lane == 0) {
      lse[r] = st.l[i] > 0.0f ? __fadd_rn(st.m[i], logf(st.l[i])) : -INFINITY;
    }
  }
}

}  // namespace mla_rows
