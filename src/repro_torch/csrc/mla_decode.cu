// Contiguous-cache AMLA MLA decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mla_decode.py:
// _mla_decode_kernel / mla_decode_rows (K4), whose body is the AMLA state
// machine of the same file (K1).
//
// What it computes.  q (B, G, Dk) query rows (G = Sq * Hq, every head of a
// token at that token's position q_pos) against a contiguous latent cache
// c (B, S, Dk), V = the first Dv columns of the same rows.  Blocks of
// block_k rows (the reference's min(512, ceil(S / 128) * 128)) below
// kv_len are walked in order; each takes one AMLA (or base) state update
// per row, masked by k_pos < kv_len & k_pos <= q_pos.  Out (B, G, Dv) fp32,
// exact zeros for rows that see no key.
//
// What bounds it on an H100.  At decode (G = 128 heads of one token) the
// bytes of the cache rows read, 576 * 2 bytes a row in bf16, at 3.35 TB/s;
// at prefill (G = bucket * 128 rows) the operations, 2 * (visible keys) *
// (Dk + Dv) per row at the bf16 tensor-core peak.
//
// Design.  It is K2 with contiguous addressing: one CTA per (request, row
// tile) runs a row body shared with K2 and K5 over the request's blocks,
// with key row `pos` at row `pos` instead of a block-table lookup, so the
// int-increment sequence is the same function of the block boundaries as
// in the reference.  Large G only adds tiles (grid.y); a tile stops at the
// block that holds its largest q_pos, which halves the work of a causal
// prefill without changing a number.  The cache is read where it lies:
// `c_sb` is its batch stride, so a slot of a larger cache needs no copy.
// bf16 queries over a bf16 cache take the tensor-core, cp.async-pipelined
// row body of mla_rows_mma.cuh: mma.sync products, the next keys in flight
// while a chunk is multiplied, 16-row tiles at decode (B x 8 CTAs at G =
// 128) and 32-row tiles once their grid fills the SMs (prefill).  It
// addresses a request's rows by 32-bit offsets in 16-byte pieces from c +
// b * c_sb, so c_sb and the base keep 16-byte alignment and S * Dk / 8 <
// 2^31.  fp32 queries, and bf16 queries over an fp32 cache, keep the
// scalar body of mla_rows.cuh (plain loads, fp32 FMA loops, 32-row tiles).
// There is no KV split, as in the reference.
#include <cuda_runtime.h>

#include <stdint.h>

#include "mla_rows.cuh"
#include "mla_rows_mma.cuh"

namespace {

using namespace mla_rows;

struct Params {
  const void* q;       // (B, G, Dk) compute dtype
  const void* c;       // (B, S, Dk) storage dtype, batch stride c_sb
  const int* kv_len;   // (B,)
  const int* q_pos;    // (B, G)
  float* o;            // (B, G, Dv)
  Geom g;
  int S;
  long long c_sb;
};

template <typename TQ, typename TP, bool kAmla>
__global__ void __launch_bounds__(kThreads, 1) mla_decode_rows_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p.g);
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int G = p.g.G, Dk = p.g.Dk;

  const TQ* q = static_cast<const TQ*>(p.q) + static_cast<size_t>(b) * G * Dk;
  const int qmax = load_tile(sm, p.g, q, p.q_pos + static_cast<size_t>(b) * G, row0);
  const TP* c = static_cast<const TP*>(p.c) + b * p.c_sb;
  auto key_off = [=](int pos) -> long long { return static_cast<long long>(pos) * Dk; };

  RowState<kAmla> st;
  st.init();
  // Keys at or past min(kv_len, largest q_pos + 1) mask in every row.
  const int end = min(min(p.kv_len[b], p.S), qmax + 1);
  for (int start = 0; start < end; start += p.g.block_k) {
    block_update<TQ, TP, kAmla>(st, sm, p.g, c, start, min(p.g.block_k, end - start), key_off);
  }
  finalize(st, p.g, row0, p.o + static_cast<size_t>(b) * G * p.g.Dv, nullptr);
}

// bf16 q over a cache of TP (bf16): the tensor-core row body, kRows = 16 *
// kM, blocks of block_k rows below min(kv_len, S).
template <typename TP, int kM, bool kAmla>
__global__ void __launch_bounds__(mla_rows_mma::kThreads, 1)
    mla_decode_rows_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int G = p.g.G, Dk = p.g.Dk;
  const mla_rows_mma::Geom g{G, Dk, p.g.Dv, p.g.block_k, p.g.scale, p.g.softcap};
  mla_rows_mma::attend<TP, kM, kAmla>(
      smem_raw, g, static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(b) * G * Dk,
      p.q_pos + static_cast<size_t>(b) * G, blockIdx.y * mla_rows_mma::Tile<kM>::kRows,
      static_cast<const TP*>(p.c) + b * p.c_sb, nullptr,
      mla_rows_mma::EvenBlocks{0, min(p.kv_len[b], p.S), p.g.block_k},
      mla_rows_mma::ContiguousRows{},
      p.o + static_cast<size_t>(b) * G * p.g.Dv, nullptr);
}

// The tensor-core body over the cache, at the tile height wide_tiles picks.
template <typename TP>
cudaError_t launch_mma(const Params& p, int B, int amla, cudaStream_t stream) {
  using mla_rows_mma::launch_tiles;
  const mla_rows_mma::Geom g{p.g.G, p.g.Dk, p.g.Dv, p.g.block_k, p.g.scale, p.g.softcap};
  constexpr int kPiece = mla_rows_mma::Pool<TP>::kPiece;
  if (!mla_rows_mma::addressable<TP>(g, p.S) || (B > 1 && p.c_sb % kPiece) ||
      reinterpret_cast<uintptr_t>(p.c) % 16 || reinterpret_cast<uintptr_t>(p.q) % 16) {
    return cudaErrorInvalidValue;
  }
  bool wide;
  const cudaError_t err = mla_rows_mma::wide_tiles(B, g.G, &wide);
  if (err != cudaSuccess) return err;
  if (wide) {
    return amla ? launch_tiles<TP, 2>(mla_decode_rows_mma_kernel<TP, 2, true>, p, g, B, stream)
                : launch_tiles<TP, 2>(mla_decode_rows_mma_kernel<TP, 2, false>, p, g, B, stream);
  }
  return amla ? launch_tiles<TP, 1>(mla_decode_rows_mma_kernel<TP, 1, true>, p, g, B, stream)
              : launch_tiles<TP, 1>(mla_decode_rows_mma_kernel<TP, 1, false>, p, g, B, stream);
}

template <typename TQ, typename TP, bool kAmla>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if ((p.g.G + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.g);
  auto kernel = mla_decode_rows_kernel<TQ, TP, kAmla>;
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
extern "C" int amla_mla_decode_rows(const void* q, const void* c, const int* kv_len,
                                    const int* q_pos, float* o, int B, int G, int Dk,
                                    int Dv, int S, int block_k, long long c_sb,
                                    float scale, float softcap, int amla, int q_bf16,
                                    int c_bf16, void* stream) {
  if (Dv > kDvMax || Dv > Dk || block_k > kBlockKMax || block_k < 1 || B < 1 ||
      G < 1 || Dk < 1 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, c, kv_len, q_pos, o, Geom{G, Dk, Dv, block_k, scale, softcap}, S, c_sb};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = c_bf16 ? launch_mma<__nv_bfloat16>(p, B, amla, s)
                 : launch_variant<__nv_bfloat16, float>(p, B, amla, s);
  } else {
    err = c_bf16 ? launch_variant<float, __nv_bfloat16>(p, B, amla, s)
                 : launch_variant<float, float>(p, B, amla, s);
  }
  return static_cast<int>(err);
}
