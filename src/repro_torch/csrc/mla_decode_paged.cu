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
// int8 pools (K2-int8): pages hold symmetric per-row int8 latents and a
// (P, page_size) fp32 scale pool; the kernel reads the int8 rows as they
// are and applies each row's sigma to its score and to its probability
// (mla_rows.cuh), as the reference's quantized queue kernel does.  The
// group-prefix pass (K2', ops.mla_decode_paged with prefix sharing) is
// this same kernel launched on stacked member queries.
//
// What bounds it on an H100.  At decode (G = 128 rows per request) it is the
// bytes of the pages read: each live page once, 576 * 2 bytes a row in bf16,
// at 3.35 TB/s; a prefill chunk (G = 4096 rows) is bound by its operations,
// 2 * G * keys * (Dk + Dv).
//
// Design.  The TPU grid walks the queue in order and carries the state in
// VMEM; here one CTA takes (destination slot, tile of 32 query rows) and
// loops over the slot's items itself, so slots and row tiles run in
// parallel and large G (4096 on a prefill chunk) only adds tiles.  The
// per-block work (strip staging, the one state update per block, P·V) is
// the row body in mla_rows.cuh, shared with the contiguous kernel K4; this
// file adds the block-table addressing.  Pages past kv_len are never read.
// This first version uses plain loads and fp32 FMA loops; wgmma/TMA
// pipelining is later work.
#include <cuda_runtime.h>

#include "mla_rows.cuh"

namespace {

using namespace mla_rows;

struct Params {
  const void* q;              // (B, G, Dk) compute dtype
  const void* pages;          // (P, page_size, Dk) storage dtype
  const float* scales;        // (P, page_size) int8 dequant scales, or null
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
  Geom g;
  int num_pages, page_size, W, N;
};

template <typename TQ, typename TP, bool kAmla>
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_queue_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p.g);
  __shared__ int s_first;

  const int tid = threadIdx.x;
  const int dest = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int G = p.g.G, Dv = p.g.Dv;

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
    for (int idx = tid; idx < kRows * Dv; idx += kThreads) {
      const int g = row0 + idx / Dv;
      if (g < G) p.o_part[(static_cast<size_t>(dest) * G + g) * Dv + idx % Dv] = 0.0f;
    }
    if (tid < kRows && row0 + tid < G) {
      p.lse[static_cast<size_t>(dest) * G + row0 + tid] = -INFINITY;
    }
    return;
  }

  const int req = p.item_req[first];
  const int k_len = p.kv_len[req];
  const TQ* q = static_cast<const TQ*>(p.q) + static_cast<size_t>(req) * G * p.g.Dk;
  const int qmax = load_tile(sm, p.g, q, p.q_pos + static_cast<size_t>(req) * G, row0);
  const TP* pages = static_cast<const TP*>(p.pages);
  const int* bt = p.block_tables + static_cast<size_t>(req) * p.W;
  const int page_size = p.page_size, num_pages = p.num_pages, Dk = p.g.Dk;
  auto key_off = [=](int pos) -> long long {
    const int pid = min(max(bt[pos / page_size], 0), num_pages - 1);
    return (static_cast<long long>(pid) * page_size + pos % page_size) * Dk;
  };

  RowState<kAmla> st;
  st.init();
  // Keys at or past min(kv_len, largest q_pos + 1) mask in every row.
  const int end = min(k_len, qmax + 1);
  for (int t = first; t < p.N; ++t) {
    if (p.item_dest[t] != dest || !p.item_valid[t]) break;
    const int start = p.item_block[t] * p.g.block_k;
    const int live = min(p.g.block_k, end - start);
    if (live > 0) {
      block_update<TQ, TP, kAmla>(st, sm, p.g, pages, start, live, key_off, p.scales);
    }
    if (p.item_last[t]) break;
  }
  finalize(st, p.g, row0, p.o_part + static_cast<size_t>(dest) * G * Dv,
           p.lse + static_cast<size_t>(dest) * G);
}

// ---- host launcher ----

template <typename TQ, typename TP, bool kAmla>
cudaError_t launch(const Params& p, int num_dest_slots, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.g);
  auto kernel = mla_decode_queue_kernel<TQ, TP, kAmla>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(num_dest_slots, (p.g.G + kRows - 1) / kRows);
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
//
// pages_kind: 0 fp32, 1 bf16, 2 int8 (then `scales` is the scale pool).
extern "C" int amla_mla_decode_paged_queue(
    const void* q, const void* pages, const float* scales,
    const int* block_tables, const int* kv_len,
    const int* q_pos, const int* item_req, const int* item_block,
    const int* item_dest, const int* item_first, const int* item_last,
    const int* item_valid, float* o_part, float* lse, int G, int Dk, int Dv,
    int num_pages, int page_size, int W, int N, int num_dest_slots,
    int block_k, float scale, float softcap, int amla, int q_bf16,
    int pages_kind, void* stream) {
  if (Dv > kDvMax || block_k > kBlockKMax || block_k < 1 || page_size < 1 ||
      G < 1 || Dk < 1 || num_dest_slots < 1 || (G + kRows - 1) / kRows > 65535 ||
      pages_kind < 0 || pages_kind > 2 || ((pages_kind == 2) != (scales != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, pages, scales, block_tables, kv_len, q_pos, item_req, item_block,
           item_dest, item_first, item_last, item_valid, o_part, lse,
           Geom{G, Dk, Dv, block_k, scale, softcap}, num_pages, page_size, W, N};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int n = num_dest_slots;
  if (q_bf16) {
    err = pages_kind == 2 ? launch_variant<__nv_bfloat16, int8_t>(p, n, amla, s)
        : pages_kind == 1 ? launch_variant<__nv_bfloat16, __nv_bfloat16>(p, n, amla, s)
                          : launch_variant<__nv_bfloat16, float>(p, n, amla, s);
  } else {
    err = pages_kind == 2 ? launch_variant<float, int8_t>(p, n, amla, s)
        : pages_kind == 1 ? launch_variant<float, __nv_bfloat16>(p, n, amla, s)
                          : launch_variant<float, float>(p, n, amla, s);
  }
  return static_cast<int>(err);
}
