// Work-queue paged AMLA decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mla_decode_paged.py:
// _mla_decode_queue_kernel / mla_decode_paged_queue_rows (K2), whose body is
// the AMLA state machine of repro/kernels/mla_decode.py (K1).
//
// What it computes.  A host-side schedule (kernels/decode_schedule.py) lists
// work items, one per (request, block_k-row KV block); the items of one
// destination slot are contiguous in the queue.  For each slot, the G query
// rows of its request (width Dk = 576) are scored against the slot's blocks,
// read page by page through the block table.  Scores are scaled, soft-capped,
// clamped to +-M_CLAMP and masked (k_pos < kv_len & k_pos <= q_pos); each
// block then takes ONE online-softmax update with the AMLA MUL-by-ADD rescale
// (an int32 add on the fp32 accumulator's bits, skipped where it is zero;
// "base" multiplies instead), and P·V accumulates with V = the first Dv = 512
// columns of the same rows.  Each slot writes a normalized partial o and
// lse = m + log l (-inf when empty), merged by mla_decode_combine.cu.
//
// What bounds it on an H100.  At decode (G = 128 rows per request) it is the
// bytes of the pages read: each live page once, 576 * 2 bytes a row in bf16,
// at 3.35 TB/s; a prefill chunk (G = 4096 rows) is bound by its operations,
// 2 * G * keys * (Dk + Dv).
//
// Design.  The TPU grid walks the queue in order and carries the state in
// VMEM; here one CTA takes (destination slot, tile of 32 query rows) and
// loops over the slot's items itself, so slots and row tiles run in
// parallel and large G (4096 on a prefill chunk) only adds tiles.  A
// 512 x 576 block does not fit in shared memory, so keys are staged in
// strips (128 keys x 32 dims for the scores, 16 keys x Dv for P·V) while the
// block's full 32 x 512 score strip stays in shared memory: the row max, and
// so the single per-block state update, is known before P·V.  Each warp owns
// 4 query rows end to end (scores, softmax, state, accumulator in
// registers), so the state update needs warp shuffles only.  Pages past
// kv_len are never read.  This first version uses plain loads and fp32 FMA
// loops; wgmma/TMA pipelining is later work.
#include <cuda_runtime.h>

#include "amla.cuh"

namespace {

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

struct Params {
  const void* q;              // (B, G, Dk) compute dtype
  const void* pages;          // (P, page_size, Dk) storage dtype
  const int* block_tables;    // (B, W)
  const int* kv_len;          // (B,)
  const int* q_pos;           // (B, G)
  const int* item_req;        // (N,) flat work queue
  const int* item_block;
  const int* item_dest;
  const int* item_first;
  const int* item_last;
  const int* item_valid;
  float* o_part;              // (D, G, Dv)
  float* lse;                 // (D, G)
  int G, Dk, Dv, num_pages, page_size, W, N, block_k;
  float scale, softcap;       // softcap <= 0: off
};

__host__ __device__ int stage_floats(int Dv) {
  const int a = kStrip * (kDChunk + 1), b = kVKeys * Dv;
  return a > b ? a : b;
}

size_t smem_bytes(const Params& p) {
  return sizeof(float) *
             (static_cast<size_t>(kRows) * p.Dk +
              static_cast<size_t>(kRows) * p.block_k + stage_floats(p.Dv)) +
         sizeof(long long) * kStrip + sizeof(int) * kRows;
}

template <typename TQ, typename TP, bool kAmla>
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_queue_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);        // kRows x Dk
  float* sS = sQ + kRows * p.Dk;                          // kRows x block_k
  float* sStage = sS + kRows * p.block_k;                 // key strips
  long long* sRowOff =
      reinterpret_cast<long long*>(sStage + stage_floats(p.Dv));  // kStrip
  int* sQPos = reinterpret_cast<int*>(sRowOff + kStrip);  // kRows
  __shared__ int s_first;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dest = blockIdx.x;
  const int row0 = blockIdx.y * kRows;

  // The slot's items are contiguous; find the first one.
  if (tid == 0) s_first = -1;
  __syncthreads();
  for (int t = tid; t < p.N; t += kThreads) {
    if (p.item_dest[t] == dest && p.item_valid[t] && p.item_first[t]) s_first = t;
  }
  __syncthreads();
  const int first = s_first;
  if (first < 0) {
    // No work for this slot (an empty request or the padding dump): the
    // combine never reads it, but leave a defined empty partial.
    for (int idx = tid; idx < kRows * p.Dv; idx += kThreads) {
      const int g = row0 + idx / p.Dv;
      if (g < p.G) p.o_part[(static_cast<size_t>(dest) * p.G + g) * p.Dv + idx % p.Dv] = 0.0f;
    }
    if (tid < kRows && row0 + tid < p.G) {
      p.lse[static_cast<size_t>(dest) * p.G + row0 + tid] = -INFINITY;
    }
    return;
  }

  const int req = p.item_req[first];
  const int k_len = p.kv_len[req];
  const TQ* q = static_cast<const TQ*>(p.q) + static_cast<size_t>(req) * p.G * p.Dk;
  const TP* pages = static_cast<const TP*>(p.pages);
  const int* bt = p.block_tables + static_cast<size_t>(req) * p.W;

  for (int idx = tid; idx < kRows * p.Dk; idx += kThreads) {
    const int g = row0 + idx / p.Dk;
    sQ[idx] = g < p.G ? amla::to_float(q[static_cast<size_t>(g) * p.Dk + idx % p.Dk]) : 0.0f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int g = row0 + r;
    // Rows past G (a ragged last tile) get position -1: every key masks.
    sQPos[r] = g < p.G ? p.q_pos[static_cast<size_t>(req) * p.G + g] : -1;
  }

  // Row state of the warp's 4 rows, held redundantly by all its lanes.
  int n0;
  float inv_r0;
  amla::round_scale_to_pow2(amla::kMInit, &n0, &inv_r0);
  float m[kRowsPerWarp], l[kRowsPerWarp], gamma[kRowsPerWarp], s16[kRowsPerWarp];
  int n[kRowsPerWarp];
  float acc[kRowsPerWarp][kColsPerLane];
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

  for (int t = first; t < p.N; ++t) {
    if (p.item_dest[t] != dest || !p.item_valid[t]) break;
    const int start = p.item_block[t] * p.block_k;
    // Keys of this block inside kv_len; the rest of the block is masked.
    const int live = min(p.block_k, k_len - start);

    // ---- scores: sS[r][col] = q_r . k_col over the live keys ----------
    for (int ks = 0; ks < live; ks += kStrip) {
      __syncthreads();  // the previous strip is done with sRowOff / sStage
      for (int key = tid; key < kStrip; key += kThreads) {
        long long off = -1;
        if (ks + key < live) {
          const int pos = start + ks + key;
          const int pid = min(max(bt[pos / p.page_size], 0), p.num_pages - 1);
          off = (static_cast<long long>(pid) * p.page_size + pos % p.page_size) * p.Dk;
        }
        sRowOff[key] = off;
      }
      float sacc[kRowsPerWarp][kKeysPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = 0.0f;
      }
      for (int d0 = 0; d0 < p.Dk; d0 += kDChunk) {
        __syncthreads();  // sRowOff is written; the last chunk is consumed
        for (int idx = tid; idx < kStrip * kDChunk; idx += kThreads) {
          const int key = idx / kDChunk;
          const int dd = idx - key * kDChunk;
          const long long off = sRowOff[key];
          float v = 0.0f;
          if (off >= 0 && d0 + dd < p.Dk) v = amla::round_to<TQ>(amla::to_float(pages[off + d0 + dd]));
          sStage[key * (kDChunk + 1) + dd] = v;
        }
        __syncthreads();
        const int dlim = min(kDChunk, p.Dk - d0);
        for (int dd = 0; dd < dlim; ++dd) {
          float qv[kRowsPerWarp], kv[kKeysPerLane];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) qv[i] = sQ[(warp * kRowsPerWarp + i) * p.Dk + d0 + dd];
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j) kv[j] = sStage[(lane + 32 * j) * (kDChunk + 1) + dd];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
            for (int j = 0; j < kKeysPerLane; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          const int col = ks + lane + 32 * j;
          if (col < p.block_k) sS[(warp * kRowsPerWarp + i) * p.block_k + col] = sacc[i][j];
        }
      }
    }
    __syncwarp();  // each warp reads back only its own rows

    // ---- one online-softmax + AMLA state update per row per block -----
    int inc[kRowsPerWarp];
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float* srow = sS + (warp * kRowsPerWarp + i) * p.block_k;
      const int qp = sQPos[warp * kRowsPerWarp + i];
      // scale, then softcap, then clamp, then mask to -inf
      float rmax = -INFINITY;
      for (int col = lane; col < p.block_k; col += 32) {
        float x = -INFINITY;
        if (col < live && start + col <= qp) {
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
      for (int col = lane; col < p.block_k; col += 32) {
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
        for (int col = lane; col < p.block_k; col += 32) {
          srow[col] = amla::round_to<TQ>(__fmul_rn(srow[col], s));
        }
      } else {
        alpha[i] = expf(__fsub_rn(m_prev, m_new));
        for (int col = lane; col < p.block_k; col += 32) srow[col] = amla::round_to<TQ>(srow[col]);
      }
    }

    // ---- rescale: MUL-by-ADD, skipped per row where the increment is 0 --
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
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

    // ---- P·V with V = the first Dv columns of the same rows ------------
    for (int kc = 0; kc < live; kc += kVKeys) {
      __syncthreads();  // every warp is done with the previous stage
      for (int idx = tid; idx < kVKeys * p.Dv; idx += kThreads) {
        const int key = idx / p.Dv;
        const int c = idx - key * p.Dv;
        float v = 0.0f;
        if (kc + key < live) {
          const int pos = start + kc + key;
          const int pid = min(max(bt[pos / p.page_size], 0), p.num_pages - 1);
          v = amla::round_to<TQ>(amla::to_float(
              pages[(static_cast<long long>(pid) * p.page_size + pos % p.page_size) * p.Dk + c]));
        }
        sStage[idx] = v;
      }
      __syncthreads();
      const int klim = min(kVKeys, live - kc);
      for (int key = 0; key < klim; ++key) {
        float pv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) pv[i] = sS[(warp * kRowsPerWarp + i) * p.block_k + kc + key];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = lane + 32 * j;
          const float v = c < p.Dv ? sStage[key * p.Dv + c] : 0.0f;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] = fmaf(pv[i], v, acc[i][j]);
        }
      }
    }
    if (p.item_last[t]) break;
  }

  // ---- finalize: o = acc / (l * S16) (amla) or acc / l, 0 when empty -----
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int g = row0 + warp * kRowsPerWarp + i;
    if (g >= p.G) continue;
    const float denom = kAmla ? __fmul_rn(l[i], s16[i]) : l[i];
    float* o = p.o_part + (static_cast<size_t>(dest) * p.G + g) * p.Dv;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < p.Dv) o[c] = denom > 0.0f ? __fdiv_rn(acc[i][j], denom) : 0.0f;
    }
    // lse in standard units (m is the true running max, l the plain mass).
    if (lane == 0) {
      p.lse[static_cast<size_t>(dest) * p.G + g] = l[i] > 0.0f ? __fadd_rn(m[i], logf(l[i])) : -INFINITY;
    }
  }
}

// ---- host launcher ----

template <typename TQ, typename TP, bool kAmla>
cudaError_t launch(const Params& p, int num_dest_slots, cudaStream_t stream) {
  const size_t smem = smem_bytes(p);
  auto kernel = mla_decode_queue_kernel<TQ, TP, kAmla>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(num_dest_slots, (p.G + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TP>
cudaError_t launch_variant(const Params& p, int num_dest_slots, int amla,
                           cudaStream_t stream) {
  return amla ? launch<TQ, TP, true>(p, num_dest_slots, stream)
              : launch<TQ, TP, false>(p, num_dest_slots, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.
extern "C" int amla_mla_decode_paged_queue(
    const void* q, const void* pages, const int* block_tables, const int* kv_len,
    const int* q_pos, const int* item_req, const int* item_block,
    const int* item_dest, const int* item_first, const int* item_last,
    const int* item_valid, float* o_part, float* lse, int G, int Dk, int Dv,
    int num_pages, int page_size, int W, int N, int num_dest_slots,
    int block_k, float scale, float softcap, int amla, int q_bf16,
    int pages_bf16, void* stream) {
  if (Dv > kDvMax || block_k > kBlockKMax || block_k < 1 || page_size < 1 ||
      G < 1 || Dk < 1 || num_dest_slots < 1 || (G + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, pages, block_tables, kv_len, q_pos, item_req, item_block,
           item_dest, item_first, item_last, item_valid, o_part, lse,
           G, Dk, Dv, num_pages, page_size, W, N, block_k, scale, softcap};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = pages_bf16 ? launch_variant<__nv_bfloat16, __nv_bfloat16>(p, num_dest_slots, amla, s)
                     : launch_variant<__nv_bfloat16, float>(p, num_dest_slots, amla, s);
  } else {
    err = pages_bf16 ? launch_variant<float, __nv_bfloat16>(p, num_dest_slots, amla, s)
                     : launch_variant<float, float>(p, num_dest_slots, amla, s);
  }
  return static_cast<int>(err);
}
