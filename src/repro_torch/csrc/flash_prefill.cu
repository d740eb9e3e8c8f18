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
// a CTA's 227 KB.  Here one CTA takes 32 query rows (gqa_rows.cuh, RPW = 4)
// of one head over the same 512-key blocks: a 32 x 512 fp32 score strip is
// 64 KB.  Query rows are independent, so a smaller q tile changes no
// number; its causal and window skips are at least the reference's.  In
// dense serving kv_len is the prompt's bucket length and the pad keys are
// hidden only by the causal mask, as in the reference.  Plain 16-byte
// loads and fp32 FMA loops; tensor-core products are later work.
#include "gqa_rows.cuh"

// Returns a cudaError_t (0 on success).  Launches on `stream`, does not
// synchronize, allocates nothing: the caller owns every buffer.
extern "C" int amla_flash_prefill(const void* q, const void* k, const void* v,
                                  const int* kv_len, float* o, int B, int Hq, int Hkv,
                                  int Sq, int Dh, int S, int block_k, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, float scale,
                                  float softcap, int window, int causal, int amla,
                                  int bf16, void* stream) {
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const gqa::Params p{q, k, v, o, kv_len, nullptr, Hq, Sq, Hq / Hkv, Dh, S, block_k,
                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, softcap, window,
                      causal};
  return static_cast<int>(
      gqa::launch<4>(p, B, amla, bf16, static_cast<cudaStream_t>(stream)));
}
