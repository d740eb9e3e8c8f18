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
// Design.  It is K2 with contiguous addressing: one CTA per (request, tile
// of 32 query rows) runs the shared row body of mla_rows.cuh over the
// request's blocks, with the key offset pos * Dk instead of a block-table
// lookup, so the int-increment sequence is the same function of the block
// boundaries as in the reference.  Large G only adds tiles (grid.y); a
// tile stops at the block that holds its largest q_pos, which halves the
// work of a causal prefill without changing a number.  The cache is read
// where it lies: `c_sb` is its batch stride, so a slot of a larger cache
// needs no copy.  Plain loads and fp32 FMA loops, as K2.
#include <cuda_runtime.h>

#include "mla_rows.cuh"

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

template <typename TQ, typename TP, bool kAmla>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
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
      G < 1 || Dk < 1 || S < 0 || (G + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, c, kv_len, q_pos, o, Geom{G, Dk, Dv, block_k, scale, softcap}, S, c_sb};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = c_bf16 ? launch_variant<__nv_bfloat16, __nv_bfloat16>(p, B, amla, s)
                 : launch_variant<__nv_bfloat16, float>(p, B, amla, s);
  } else {
    err = c_bf16 ? launch_variant<float, __nv_bfloat16>(p, B, amla, s)
                 : launch_variant<float, float>(p, B, amla, s);
  }
  return static_cast<int>(err);
}
