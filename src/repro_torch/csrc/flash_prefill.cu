// Causal flash prefill with the AMLA rescale, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill.py:
// _prefill_kernel / flash_prefill (K7).
//
// What it computes.  q (B, Hq, Sq, Dh) against k and v (B, Hkv, S, Dh),
// query head h reading KV head h / group (K and V are never repeated).
// Query positions count from 0 (the reference's flash_prefill takes no
// offset).  Blocks of block_k = min(512, max(S, 128)) keys; mask k_pos <
// kv_len, causal k_pos <= q_pos, window k_pos > q_pos - window; order
// scale -> softcap -> clamp +-M_CLAMP -> mask.  One AMLA (or base) state
// update per row per block.  Out (B, Hq, Sq, Dh) fp32.
//
// What bounds it on an H100.  The operations: 4 * Dh per (query, visible
// key) pair (QK and PV products) at the bf16 tensor-core peak; at a
// 2048-token prompt that is ~100x the bytes of q, k, v and the output.
//
// Design.  The TPU grid is (B, Hq, 256-row q blocks, 512-row k blocks)
// with a 256 x 512 score tile in VMEM; that tile in fp32 is 512 KB, beyond
// a CTA's 227 KB.  bf16 q over bf16 K/V runs the tensor-core row body of
// mla_rows_mma.cuh (HeadRows: K and V read where they lie through their
// strides, mma.sync products, a cp.async ring) on one CTA per (b, query
// head, tile of 16 rows, or 32 once that grid fills the SMs) over the same
// 512-key blocks, the tiles of the most blocks launched first.  Query rows
// are independent, so a smaller q tile changes no number; its causal skip
// (keys past the tile's last row) and window skip (blocks before the one
// that holds the window start of its first row) are at least the
// reference's.  In dense serving kv_len is the prompt's bucket length and
// the pad keys are hidden only by the causal mask, as in the reference.
// fp32 q or fp32 K/V keep the scalar body of gqa_rows.cuh (32-row tiles,
// fp32 FMA loops).
#include <cuda_runtime.h>

#include "gqa_rows.cuh"
#include "mla_rows_mma.cuh"

namespace {

using mla_rows_mma::bf16;

struct MmaParams {
  const bf16* q;       // (B, Hq, Sq, Dh) contiguous
  const bf16* k;       // (B, Hkv, S, Dh) strided, unit stride along Dh
  const bf16* v;
  const int* kv_len;   // (B,)
  float* o;            // (B, Hq, Sq, Dh)
  mla_rows_mma::Geom g;  // G = Sq rows of Dk = Dv = Dh, window, causal
  int Hq, group, S;
  long long k_sb, k_sh, v_sb, v_sh;  // elements
  int k_rs, v_rs;                    // sequence strides, in 16-byte pieces
};

template <int kM, bool kAmla>
__global__ void __launch_bounds__(mla_rows_mma::kThreads, 1) flash_prefill_mma_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = mla_rows_mma::Tile<kM>::kRows;
  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh - b * p.Hq;
  const int hkv = h / p.group;
  // the last tiles (most blocks under the causal mask) first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int bk = p.g.block_k;
  const int first = p.g.window > 0 ? max(0, row0 - p.g.window + 1) / bk * bk : 0;
  const size_t rows = static_cast<size_t>(bh) * p.g.G * p.g.Dk;
  mla_rows_mma::attend<bf16, kM, kAmla>(
      smem_raw, p.g, p.q + rows, mla_rows_mma::RowPositions{}, row0,
      p.k + b * p.k_sb + hkv * p.k_sh, nullptr,
      mla_rows_mma::EvenBlocks{first, min(p.kv_len[b], p.S), bk}, mla_rows_mma::ContiguousRows{},
      p.o + rows, nullptr,
      mla_rows_mma::HeadRows{p.v + b * p.v_sb + hkv * p.v_sh, p.k_rs, p.v_rs});
}

// The tensor-core body on B * Hq x tiles CTAs, at the tile height
// wide_tiles picks.
cudaError_t launch_mma(MmaParams p, int B, long long k_ss, long long v_ss, int amla,
                       cudaStream_t stream) {
  using mla_rows_mma::launch_tiles;
  constexpr int kPiece = mla_rows_mma::Pool<bf16>::kPiece;
  if (!mla_rows_mma::addressable(p.g, p.S, p.q, p.k, {p.k_sb, p.k_sh, k_ss}, p.v,
                                 {p.v_sb, p.v_sh, v_ss})) {
    return cudaErrorInvalidValue;
  }
  p.k_rs = static_cast<int>(k_ss / kPiece);
  p.v_rs = static_cast<int>(v_ss / kPiece);
  const int n = B * p.Hq;
  bool wide;
  const cudaError_t err = mla_rows_mma::wide_tiles(n, p.g.G, &wide);
  if (err != cudaSuccess) return err;
  if (wide) {
    return amla ? launch_tiles<bf16, 2, true>(flash_prefill_mma_kernel<2, true>, p, p.g, n, stream)
                : launch_tiles<bf16, 2, true>(flash_prefill_mma_kernel<2, false>, p, p.g, n, stream);
  }
  return amla ? launch_tiles<bf16, 1, true>(flash_prefill_mma_kernel<1, true>, p, p.g, n, stream)
              : launch_tiles<bf16, 1, true>(flash_prefill_mma_kernel<1, false>, p, p.g, n, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.  bf16
// (`is_bf16` != 0) runs the tensor-core body, fp32 the scalar one.
extern "C" int amla_flash_prefill(const void* q, const void* k, const void* v,
                                  const int* kv_len, float* o, int B, int Hq, int Hkv,
                                  int Sq, int Dh, int S, int block_k, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, float scale,
                                  float softcap, int window, int causal, int amla,
                                  int is_bf16, void* stream) {
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (Dh < 8 || Dh > mla_rows_mma::kDvMax || block_k < 1 ||
        block_k > mla_rows_mma::kBlockKMax || B < 1 || Sq < 1 || S < 0 ||
        static_cast<long long>(B) * Hq > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    mla_rows_mma::Geom g{Sq, Dh, Dh, block_k, scale, softcap};
    g.window = window;
    g.causal = causal;
    const MmaParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), kv_len, o, g, Hq, Hq / Hkv, S,
                      k_sb, k_sh, v_sb, v_sh, 0, 0};
    return static_cast<int>(launch_mma(p, B, k_ss, v_ss, amla, s));
  }
  const gqa::Params p{q, k, v, o, kv_len, nullptr, Hq, Sq, Hq / Hkv, Dh, S, block_k,
                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, softcap, window,
                      causal};
  return static_cast<int>(gqa::launch<4>(p, B, amla, s));
}
