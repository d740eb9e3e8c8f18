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
// (mla_rows.cuh, mla_rows_mma.cuh), as the reference's quantized queue
// kernel does.  The group-prefix pass (K2', ops.mla_decode_paged with
// prefix sharing) is this same kernel launched on stacked member queries.
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
// a row body shared with the padded kernel K5 and the contiguous kernel K4;
// this file adds the work queue (the block-table addressing is
// paged_rows.cuh, shared with K5).  Pages past kv_len are never read.
// bf16 queries over a bf16 or an int8 pool take the tensor-core,
// cp.async-pipelined row body of mla_rows_mma.cuh (16- or 32-row tiles);
// fp32 queries and fp32 pools keep the scalar body of mla_rows.cuh (plain
// loads, fp32 FMA loops).
#include <cuda_runtime.h>

#include "mla_rows.cuh"
#include "mla_rows_mma.cuh"
#include "paged_rows.cuh"

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

// The first queue item of slot `dest` (its items are contiguous), or -1.
__device__ __forceinline__ int slot_first(const Params& p, int dest, int* s_first) {
  if (threadIdx.x == 0) *s_first = -1;
  __syncthreads();
  for (int t = threadIdx.x; t < p.N; t += blockDim.x) {
    if (p.item_dest[t] == dest && p.item_valid[t] && p.item_first[t]) *s_first = t;
  }
  __syncthreads();
  return *s_first;
}

// No work for this slot (an empty request or the padding dump): the
// combine never reads it, but leave a defined empty partial.
__device__ __forceinline__ void empty_partial(const Params& p, int dest, int row0, int rows) {
  const int G = p.g.G, Dv = p.g.Dv;
  for (int idx = threadIdx.x; idx < rows * Dv; idx += blockDim.x) {
    const int g = row0 + idx / Dv;
    if (g < G) p.o_part[(static_cast<size_t>(dest) * G + g) * Dv + idx % Dv] = 0.0f;
  }
  if (static_cast<int>(threadIdx.x) < rows && row0 + static_cast<int>(threadIdx.x) < G) {
    p.lse[static_cast<size_t>(dest) * G + row0 + threadIdx.x] = -INFINITY;
  }
}

// The slot's items in queue order, from its first: each item's KV block
// with the keys below min(kv_len, cap) that it holds (live > 0 only).
struct QueueBlocks {
  const int *block, *dest, *last, *valid;
  int t, n, slot, k_len, block_k;
  __device__ __forceinline__ bool next(int cap, int& start, int& live) {
    while (t < n) {
      if (dest[t] != slot || !valid[t]) break;
      start = block[t] * block_k;
      live = min(block_k, min(k_len, cap) - start);
      t = last[t] ? n : t + 1;
      if (live > 0) return true;
    }
    t = n;
    return false;
  }
};

template <typename TQ, typename TP, bool kAmla>
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_queue_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p.g);
  __shared__ int s_first;

  const int dest = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int G = p.g.G, Dv = p.g.Dv;

  const int first = slot_first(p, dest, &s_first);
  if (first < 0) {
    empty_partial(p, dest, row0, kRows);
    return;
  }

  const int req = p.item_req[first];
  const TQ* q = static_cast<const TQ*>(p.q) + static_cast<size_t>(req) * G * p.g.Dk;
  const int qmax = load_tile(sm, p.g, q, p.q_pos + static_cast<size_t>(req) * G, row0);
  const TP* pages = static_cast<const TP*>(p.pages);
  const PagedKeys key_off{
      {p.block_tables + static_cast<size_t>(req) * p.W, p.page_size, p.num_pages}, p.g.Dk};

  RowState<kAmla> st;
  st.init();
  // Keys at or past min(kv_len, largest q_pos + 1) mask in every row.
  QueueBlocks blocks{p.item_block, p.item_dest, p.item_last, p.item_valid, first, p.N, dest,
                     p.kv_len[req], p.g.block_k};
  int start, live;
  while (blocks.next(qmax + 1, start, live)) {
    block_update<TQ, TP, kAmla>(st, sm, p.g, pages, start, live, key_off, p.scales);
  }
  finalize(st, p.g, row0, p.o_part + static_cast<size_t>(dest) * G * Dv,
           p.lse + static_cast<size_t>(dest) * G);
}

// bf16 q over a pool of TP (bf16 or int8): the tensor-core row body,
// kRows = 16 * kM.
template <typename TP, int kM, bool kAmla>
__global__ void __launch_bounds__(mla_rows_mma::kThreads, 1)
    mla_decode_queue_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_first;
  constexpr int kTileRows = mla_rows_mma::Tile<kM>::kRows;
  const int dest = blockIdx.x;
  const int row0 = blockIdx.y * kTileRows;
  const int G = p.g.G;

  const int first = slot_first(p, dest, &s_first);
  if (first < 0) {
    empty_partial(p, dest, row0, kTileRows);
    return;
  }
  const int req = p.item_req[first];
  const mla_rows_mma::Geom g{G, p.g.Dk, p.g.Dv, p.g.block_k, p.g.scale, p.g.softcap};
  const QueueBlocks blocks{p.item_block, p.item_dest, p.item_last, p.item_valid, first,
                           p.N, dest, p.kv_len[req], p.g.block_k};
  mla_rows_mma::attend<TP, kM, kAmla>(
      smem_raw, g, static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(req) * G * p.g.Dk,
      p.q_pos + static_cast<size_t>(req) * G, row0, static_cast<const TP*>(p.pages), p.scales,
      blocks, PagedRows{p.block_tables + static_cast<size_t>(req) * p.W, p.page_size, p.num_pages},
      p.o_part + static_cast<size_t>(dest) * G * p.g.Dv, p.lse + static_cast<size_t>(dest) * G);
}

// ---- host launchers ----

// The tensor-core body over the pool, at the tile height wide_tiles picks.
template <typename TP>
cudaError_t launch_mma(const Params& p, int num_dest_slots, int amla, cudaStream_t stream) {
  using mla_rows_mma::launch_tiles;
  const mla_rows_mma::Geom g{p.g.G, p.g.Dk, p.g.Dv, p.g.block_k, p.g.scale, p.g.softcap};
  if (!mla_rows_mma::addressable<TP>(g, static_cast<long long>(p.num_pages) * p.page_size)) {
    return cudaErrorInvalidValue;
  }
  bool wide;
  const cudaError_t err = mla_rows_mma::wide_tiles(num_dest_slots, g.G, &wide);
  if (err != cudaSuccess) return err;
  const int n = num_dest_slots;
  if (wide) {
    return amla ? launch_tiles<TP, 2>(mla_decode_queue_mma_kernel<TP, 2, true>, p, g, n, stream)
                : launch_tiles<TP, 2>(mla_decode_queue_mma_kernel<TP, 2, false>, p, g, n, stream);
  }
  return amla ? launch_tiles<TP, 1>(mla_decode_queue_mma_kernel<TP, 1, true>, p, g, n, stream)
              : launch_tiles<TP, 1>(mla_decode_queue_mma_kernel<TP, 1, false>, p, g, n, stream);
}

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
    err = pages_kind == 2 ? launch_mma<int8_t>(p, n, amla, s)
        : pages_kind == 1 ? launch_mma<__nv_bfloat16>(p, n, amla, s)
                          : launch_variant<__nv_bfloat16, float>(p, n, amla, s);
  } else {
    err = pages_kind == 2 ? launch_variant<float, int8_t>(p, n, amla, s)
        : pages_kind == 1 ? launch_variant<float, __nv_bfloat16>(p, n, amla, s)
                          : launch_variant<float, float>(p, n, amla, s);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of a tensor-core MLA kernel (K2, K4 or K5: it
// depends on the rows' type, the tile and the geometry only) at a tile
// height of 16 * kM rows over bf16 (pages_kind 1) or int8 (2) rows, or -1.
extern "C" long long amla_mla_rows_mma_smem(int kM, int pages_kind, int G, int Dk, int Dv,
                                            int block_k) {
  const mla_rows_mma::Geom g{G, Dk, Dv, block_k, 1.0f, 0.0f};
  if (pages_kind == 1) {
    return static_cast<long long>(kM == 2 ? mla_rows_mma::smem_bytes<__nv_bfloat16, 2>(g)
                                          : mla_rows_mma::smem_bytes<__nv_bfloat16, 1>(g));
  }
  if (pages_kind == 2) {
    return static_cast<long long>(kM == 2 ? mla_rows_mma::smem_bytes<int8_t, 2>(g)
                                          : mla_rows_mma::smem_bytes<int8_t, 1>(g));
  }
  return -1;
}
