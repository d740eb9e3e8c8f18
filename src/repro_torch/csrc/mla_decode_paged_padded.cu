// Padded-grid paged AMLA decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mla_decode_paged.py:
// _mla_decode_paged_kernel / mla_decode_paged_rows (K5), the reference's
// padded (B, W) baseline behind ops.mla_decode_paged(scheduler="padded").
//
// What it computes.  For each request b, its G query rows (width Dk) attend
// over the request's own pages, resolved through its block-table row one
// page at a time: scores are scaled, soft-capped, clamped to +-M_CLAMP and
// masked (k_pos < kv_len & k_pos <= q_pos), and each PAGE takes one
// online-softmax update with the AMLA MUL-by-ADD rescale ("base"
// multiplies instead) followed by P·V with V = the first Dv columns.  The
// output is the normalized (B, G, Dv) result; a request with kv_len == 0
// gives exact zeros.  The reference updates the state once per page, not
// per 512-row block, and the int32 increments depend on that boundary, so
// the block here is one page (block_k = page_size).  Pages past kv_len are
// the reference's clamped tail (clamp_tail_pages): it fetches them and
// skips their compute; here they are not read at all.  bf16 and fp32
// pools only, as in the reference (its padded grid has no dequant path).
//
// What bounds it on an H100.  The bytes of the live pages (each read once
// per row tile of the request) at 3.35 TB/s at decode; operations,
// 2 * G * keys * (Dk + Dv), for long multi-row calls.
//
// Design.  One CTA per (request, row tile) walks that request's pages in
// order, through the block table (paged_rows.cuh, shared with K2), as
// blocks of one page each: the page's score strip stays in shared memory
// until its max is known, one state update per page, the accumulators in
// registers.  bf16 queries over a bf16 pool take the tensor-core,
// cp.async-pipelined row body of mla_rows_mma.cuh (shared with K2 and K4):
// mma.sync products, the next page's keys in flight while one is
// multiplied, 16-row tiles unless the grid of 32-row tiles fills the SMs.
// fp32 queries and fp32 pools keep the scalar body of mla_rows.cuh (plain
// loads, fp32 FMA loops, 32-row tiles).  There is no KV split: the grid
// has B x ceil(G / tile) CTAs.
#include <cuda_runtime.h>

#include "mla_rows.cuh"
#include "mla_rows_mma.cuh"
#include "paged_rows.cuh"

namespace {

using namespace mla_rows;

struct Params {
  const void* q;              // (B, G, Dk) compute dtype
  const void* pages;          // (P, page_size, Dk) storage dtype
  const int* block_tables;    // (B, W)
  const int* kv_len;          // (B,)
  const int* q_pos;           // (B, G)
  float* o;                   // (B, G, Dv)
  Geom g;                     // g.block_k == page_size
  int num_pages, W;
};

template <typename TQ, typename TP, bool kAmla>
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_padded_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p.g);
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int G = p.g.G, Dk = p.g.Dk, page_size = p.g.block_k;

  const TQ* q = static_cast<const TQ*>(p.q) + static_cast<size_t>(b) * G * Dk;
  const int qmax = load_tile(sm, p.g, q, p.q_pos + static_cast<size_t>(b) * G, row0);
  const TP* pages = static_cast<const TP*>(p.pages);
  const PagedKeys key_off{
      {p.block_tables + static_cast<size_t>(b) * p.W, page_size, p.num_pages}, Dk};

  RowState<kAmla> st;
  st.init();
  // Keys at or past min(kv_len, largest q_pos + 1) mask in every row: the
  // reference's updates over them leave the state unchanged.
  const int end = min(min(p.kv_len[b], p.W * page_size), qmax + 1);
  for (int start = 0; start < end; start += page_size) {
    block_update<TQ, TP, kAmla>(st, sm, p.g, pages, start, min(page_size, end - start), key_off);
  }
  finalize(st, p.g, row0, p.o + static_cast<size_t>(b) * G * p.g.Dv, nullptr);
}

// bf16 q over a pool of TP (bf16): the tensor-core row body, kRows = 16 *
// kM, one block per page below min(kv_len, W * page_size).
template <typename TP, int kM, bool kAmla>
__global__ void __launch_bounds__(mla_rows_mma::kThreads, 1)
    mla_decode_padded_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int G = p.g.G, Dk = p.g.Dk, page_size = p.g.block_k;
  const mla_rows_mma::Geom g{G, Dk, p.g.Dv, page_size, p.g.scale, p.g.softcap};
  const int k_len = static_cast<int>(
      min(static_cast<long long>(p.kv_len[b]), static_cast<long long>(p.W) * page_size));
  mla_rows_mma::attend<TP, kM, kAmla>(
      smem_raw, g, static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(b) * G * Dk,
      p.q_pos + static_cast<size_t>(b) * G, blockIdx.y * mla_rows_mma::Tile<kM>::kRows,
      static_cast<const TP*>(p.pages), nullptr, mla_rows_mma::EvenBlocks{0, k_len, page_size},
      PagedRows{p.block_tables + static_cast<size_t>(b) * p.W, page_size, p.num_pages},
      p.o + static_cast<size_t>(b) * G * p.g.Dv, nullptr);
}

// The tensor-core body over the pool, at the tile height wide_tiles picks.
template <typename TP>
cudaError_t launch_mma(const Params& p, int B, int amla, cudaStream_t stream) {
  using mla_rows_mma::launch_tiles;
  const mla_rows_mma::Geom g{p.g.G, p.g.Dk, p.g.Dv, p.g.block_k, p.g.scale, p.g.softcap};
  if (!mla_rows_mma::addressable<TP>(g, static_cast<long long>(p.num_pages) * p.g.block_k)) {
    return cudaErrorInvalidValue;
  }
  bool wide;
  const cudaError_t err = mla_rows_mma::wide_tiles(B, g.G, &wide);
  if (err != cudaSuccess) return err;
  if (wide) {
    return amla ? launch_tiles<TP, 2>(mla_decode_padded_mma_kernel<TP, 2, true>, p, g, B, stream)
                : launch_tiles<TP, 2>(mla_decode_padded_mma_kernel<TP, 2, false>, p, g, B, stream);
  }
  return amla ? launch_tiles<TP, 1>(mla_decode_padded_mma_kernel<TP, 1, true>, p, g, B, stream)
              : launch_tiles<TP, 1>(mla_decode_padded_mma_kernel<TP, 1, false>, p, g, B, stream);
}

template <typename TQ, typename TP, bool kAmla>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if ((p.g.G + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.g);
  auto kernel = mla_decode_padded_kernel<TQ, TP, kAmla>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (p.g.G + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TP>
cudaError_t launch_variant(const Params& p, int B, int amla, cudaStream_t stream) {
  return amla ? launch<TQ, TP, true>(p, B, stream) : launch<TQ, TP, false>(p, B, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.
extern "C" int amla_mla_decode_paged_padded(
    const void* q, const void* pages, const int* block_tables, const int* kv_len,
    const int* q_pos, float* o, int B, int G, int Dk, int Dv, int num_pages,
    int page_size, int W, float scale, float softcap, int amla, int q_bf16,
    int pages_bf16, void* stream) {
  if (Dv > kDvMax || Dv > Dk || page_size > kBlockKMax || page_size < 1 || B < 1 ||
      G < 1 || Dk < 1 || W < 1 || num_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, pages, block_tables, kv_len, q_pos, o,
           Geom{G, Dk, Dv, page_size, scale, softcap}, num_pages, W};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = pages_bf16 ? launch_mma<__nv_bfloat16>(p, B, amla, s)
                     : launch_variant<__nv_bfloat16, float>(p, B, amla, s);
  } else {
    err = pages_bf16 ? launch_variant<float, __nv_bfloat16>(p, B, amla, s)
                     : launch_variant<float, float>(p, B, amla, s);
  }
  return static_cast<int>(err);
}
