// GQA/MQA/MHA decode attention with the AMLA rescale, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/gqa_decode.py:
// _gqa_decode_kernel / gqa_decode_rows (K6).
//
// What it computes.  q (B, Hkv, G, Dh) with G = Sq * group rows per KV head
// (every query head of the group, at its token's position q_pos (B, G)),
// against k and v (B, Hkv, S, Dh) in 512-key blocks (the reference's
// block_k = min(512, max(S, 128))).  Mask k_pos < kv_len & k_pos <= q_pos,
// and k_pos > q_pos - window on sliding-window layers; order scale ->
// softcap -> clamp +-M_CLAMP -> mask.  One AMLA (or base) state update per
// row per block.  Out (B, Hkv, G, Dh) fp32, exact zeros for a row with no
// visible key (kv_len 0).
//
// What bounds it on an H100.  The bytes of K and V below kv_len (inside the
// window) for every (b, h), read once at 3.35 TB/s: decode does 4 * G
// operations per key byte pair, far below the card's ~295 per byte.
//
// Design.  The TPU keeps one accumulator per (b, h) program and walks the
// blocks on its sequential grid axis.  A decode step has few (b, h) pairs
// (16 at gemma2-2b), so here the blocks are spread over the SMs instead:
// bf16 q over bf16 K/V runs the tensor-core row body of mla_rows_mma.cuh
// (HeadRows: K and V read where they lie through their strides, no copy)
// on one CTA per (b, h, tile of 16 or 32 rows, split).  The caller picks
// `splits` from host-known shapes; each CTA finds its (b, h)'s live blocks
// itself, from the block that holds the window start of the head's
// smallest q_pos (the reference's whole-block window skip) to the block
// that holds min(kv_len, S, largest q_pos + 1), and walks the `split`-th of
// `splits` contiguous runs of them, block edges multiples of block_k from
// key 0 as in the reference.  It writes a normalized partial and, with an
// lse buffer (required over more than one split; optional at one, for a
// caller that merges partials itself, such as the split-KV decode over a
// sequence-sharded cache), its lse (-inf when its run is empty) into slot
// split * B * Hkv + b * Hkv + h, which the combine (K3,
// mla_decode_combine.cu) merges; the split boundaries depend only on
// kv_len, the positions and the shapes, so the plain version walks the
// same splits.  fp32 q or fp32 K/V keep the scalar body of gqa_rows.cuh
// (one CTA per (b, h, 8 rows), fp32 FMA loops, no split, the lse on
// request).
#include <cuda_runtime.h>

#include "gqa_rows.cuh"
#include "mla_rows_mma.cuh"

namespace {

using mla_rows_mma::bf16;

struct MmaParams {
  const bf16* q;       // (B, Hkv, G, Dh) contiguous
  const bf16* k;       // (B, Hkv, S, Dh) strided, unit stride along Dh
  const bf16* v;
  const int* kv_len;   // (B,)
  const int* q_pos;    // (B, G)
  float* o;            // (B, Hkv, G, Dh), or (splits, B, Hkv, G, Dh) partials
  float* lse;          // null, or (splits, B, Hkv, G) partial lse
  mla_rows_mma::Geom g;  // Dk = Dv = Dh, window, causal
  int Hkv, S, splits;
  long long k_sb, k_sh, v_sb, v_sh;  // elements
  int k_rs, v_rs;                    // sequence strides, in 16-byte pieces
};

// Split `split` of (b, h)'s live blocks, as key positions [lo, hi).
__device__ __forceinline__ void split_range(const MmaParams& p, int b, int split, int& lo,
                                            int& hi) {
  const int lane = threadIdx.x & 31;
  const int* pos = p.q_pos + static_cast<size_t>(b) * p.g.G;
  int qmin = INT_MAX, qmax = -1;
  for (int r = lane; r < p.g.G; r += 32) {
    qmin = min(qmin, pos[r]);
    qmax = max(qmax, pos[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
  const int bk = p.g.block_k;
  const int end = min(min(p.kv_len[b], p.S), qmax + 1);
  const int first = p.g.window > 0 ? max(0, qmin - p.g.window + 1) / bk : 0;
  const int n = max(0, (end + bk - 1) / bk - first);
  lo = (first + static_cast<int>(static_cast<long long>(split) * n / p.splits)) * bk;
  hi = min(end, (first + static_cast<int>(static_cast<long long>(split + 1) * n / p.splits)) * bk);
}

template <int kM, bool kAmla>
__global__ void __launch_bounds__(mla_rows_mma::kThreads, 1) gqa_decode_mma_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = mla_rows_mma::Tile<kM>::kRows;
  const int bh = blockIdx.x;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int row0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int G = p.g.G, Dh = p.g.Dk;
  const size_t slot = static_cast<size_t>(split) * gridDim.x + bh;
  float* o = p.o + slot * G * Dh;
  float* lse = p.lse != nullptr ? p.lse + slot * G : nullptr;

  int lo, hi;
  split_range(p, b, split, lo, hi);
  if (lo >= hi) {  // an empty run: zeros, and lse -inf (weight 0 in the combine)
    const int rows = min(kRows, G - row0);
    for (int i = threadIdx.x; i < rows * Dh; i += blockDim.x) {
      o[static_cast<size_t>(row0) * Dh + i] = 0.0f;
    }
    if (lse != nullptr && threadIdx.x < rows) lse[row0 + threadIdx.x] = -INFINITY;
    return;
  }
  mla_rows_mma::attend<bf16, kM, kAmla>(
      smem_raw, p.g, p.q + static_cast<size_t>(bh) * G * Dh, p.q_pos + static_cast<size_t>(b) * G,
      row0, p.k + b * p.k_sb + h * p.k_sh, nullptr,
      mla_rows_mma::EvenBlocks{lo, hi, p.g.block_k}, mla_rows_mma::ContiguousRows{}, o, lse,
      mla_rows_mma::HeadRows{p.v + b * p.v_sb + h * p.v_sh, p.k_rs, p.v_rs});
}

// The tensor-core body on B * Hkv x tiles x splits CTAs, at the tile height
// wide_tiles picks.
cudaError_t launch_mma(MmaParams p, int B, long long k_ss, long long v_ss, int amla,
                       cudaStream_t stream) {
  using mla_rows_mma::launch_tiles;
  constexpr int kPiece = mla_rows_mma::Pool<bf16>::kPiece;
  if (!mla_rows_mma::addressable(p.g, p.S, p.q, p.k, {p.k_sb, p.k_sh, k_ss}, p.v,
                                 {p.v_sb, p.v_sh, v_ss}) ||
      p.splits < 1 || (p.splits > 1 && p.lse == nullptr)) {
    return cudaErrorInvalidValue;
  }
  p.k_rs = static_cast<int>(k_ss / kPiece);
  p.v_rs = static_cast<int>(v_ss / kPiece);
  const int n = B * p.Hkv;
  bool wide;
  const cudaError_t err = mla_rows_mma::wide_tiles(n, p.g.G, &wide);
  if (err != cudaSuccess) return err;
  const int s = p.splits;
  if (wide) {
    return amla ? launch_tiles<bf16, 2, true>(gqa_decode_mma_kernel<2, true>, p, p.g, n, stream, s)
                : launch_tiles<bf16, 2, true>(gqa_decode_mma_kernel<2, false>, p, p.g, n, stream, s);
  }
  return amla ? launch_tiles<bf16, 1, true>(gqa_decode_mma_kernel<1, true>, p, p.g, n, stream, s)
              : launch_tiles<bf16, 1, true>(gqa_decode_mma_kernel<1, false>, p, p.g, n, stream, s);
}

}  // namespace

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.  bf16
// (`is_bf16` != 0) runs the tensor-core body on `splits` splits: `o` and
// `lse` are the (splits, B, Hkv, G, Dh) and (splits, B, Hkv, G) partials,
// and with splits = 1 `lse` may be null (then `o` is the output).  fp32
// takes splits = 1 and writes `lse` (B, Hkv, G) when it is not null.  A
// partial's lse is m + log l, -inf where its rows saw no key.
extern "C" int amla_gqa_decode(const void* q, const void* k, const void* v,
                               const int* kv_len, const int* q_pos, float* o, float* lse,
                               int B, int Hkv, int G, int Dh, int S, int block_k, int splits,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               float scale, float softcap, int window, int amla,
                               int is_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (Dh < 8 || Dh > mla_rows_mma::kDvMax || block_k < 1 ||
        block_k > mla_rows_mma::kBlockKMax || B < 1 || Hkv < 1 || G < 1 || S < 0 ||
        static_cast<long long>(B) * Hkv > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    mla_rows_mma::Geom g{G, Dh, Dh, block_k, scale, softcap};
    g.window = window;
    const MmaParams p{static_cast<const mla_rows_mma::bf16*>(q),
                      static_cast<const mla_rows_mma::bf16*>(k),
                      static_cast<const mla_rows_mma::bf16*>(v),
                      kv_len, q_pos, o, lse, g, Hkv, S, splits, k_sb, k_sh, v_sb, v_sh, 0, 0};
    return static_cast<int>(launch_mma(p, B, k_ss, v_ss, amla, s));
  }
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const gqa::Params p{q, k, v, o, kv_len, q_pos, Hkv, G, 1, Dh, S, block_k,
                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, softcap, window, 1, lse};
  return static_cast<int>(gqa::launch<1>(p, B, amla, s));
}

// Dynamic shared memory of the tensor-core GQA kernels (K6, K7) at a tile
// height of 16 * kM rows, head dim Dh, block_k.
extern "C" long long amla_gqa_rows_mma_smem(int kM, int Dh, int block_k) {
  const mla_rows_mma::Geom g{1, Dh, Dh, block_k, 1.0f, 0.0f};
  return static_cast<long long>(kM == 2 ? mla_rows_mma::smem_bytes<mla_rows_mma::bf16, 2, true>(g)
                                        : mla_rows_mma::smem_bytes<mla_rows_mma::bf16, 1, true>(g));
}
