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
// blocks on its sequential grid axis; here one CTA per (b, h, tile of 8
// rows) walks them in a loop (gqa_rows.cuh, RPW = 1: one row per warp, so a
// decode step's G = 1..8 rows waste little), and reads the dense cache
// where it lies through its strides — no per-call transpose or copy.
// Blocks outside the window of the tile's smallest q_pos are skipped, as
// the reference skips them by the minimum q_pos.  Plain 16-byte loads and
// fp32 FMA loops; more CTAs per head (split-KV) and tensor-core products
// are later work.
#include "gqa_rows.cuh"

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.
extern "C" int amla_gqa_decode(const void* q, const void* k, const void* v,
                               const int* kv_len, const int* q_pos, float* o, int B,
                               int Hkv, int G, int Dh, int S, int block_k,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               float scale, float softcap, int window, int amla,
                               int bf16, void* stream) {
  const gqa::Params p{q, k, v, o, kv_len, q_pos, Hkv, G, 1, Dh, S, block_k,
                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, softcap, window, 1};
  return static_cast<int>(
      gqa::launch<1>(p, B, amla, bf16, static_cast<cudaStream_t>(stream)));
}
