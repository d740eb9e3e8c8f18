// Tensor-core AMLA row body for bf16 queries over bf16 or int8 latent rows,
// or over bf16 K and V rows of their own.
//
// Replaces, for bf16 q over bf16 or int8 latent rows, the scalar row body of
// mla_rows.cuh in three kernels:
// * the work-queue paged kernel (mla_decode_paged.cu), i.e. the Pallas TPU
//   kernels repro/kernels/mla_decode_paged.py:490 mla_decode_paged_queue_rows
//   (K2, and K2-int8 over int8 pages) and :618 mla_decode_paged_group_prefix
//   (K2', the same launch on stacked member queries);
// * the padded-grid paged kernel (mla_decode_paged_padded.cu), i.e.
//   mla_decode_paged.py:261 mla_decode_paged_rows (K5: bf16 pages, one block
//   per page);
// * the contiguous-cache kernel (mla_decode.cu), i.e. repro/kernels/
//   mla_decode.py:401 mla_decode_rows (K4: bf16 cache, block_k-row blocks);
// and, for bf16 q over bf16 K/V, the scalar body of gqa_rows.cuh in two:
// * the GQA decode kernel (gqa_decode.cu), i.e. repro/kernels/
//   gqa_decode.py:147 gqa_decode_rows (K6, split over its KV blocks);
// * the flash prefill (flash_prefill.cu), i.e. repro/kernels/
//   flash_prefill.py:149 flash_prefill (K7).
// Over HeadRows (K6, K7) V has rows of its own, K and V rows lie at their
// own strides, and a sliding window or non-causal rows may mask.
// It computes what mla_rows.cuh (gqa_rows.cuh) computes: per KV block of
// block_k rows ONE online-softmax update per query row with the AMLA
// MUL-by-ADD rescale (an int32 add on the fp32 accumulator's bits, skipped
// where it is 0; "base" multiplies), in the same order: scale, softcap,
// clamp, mask; expf; round_scale_to_pow2; p * S16 rounded to bf16 before
// P.V.  Only the order of the fp32 sums inside the two products differs
// (tensor cores).
//
// int8 pools hold symmetric per-row int8 latents and one fp32 sigma per
// row.  The int8 values feed both products unscaled, cast to bf16 (exact
// for -127..127); a score is multiplied by its key's sigma right after
// q.k, before scale, softcap and clamp, and sigma is folded into p as
// (p * S16) * sigma (amla) or p * sigma (base) before the bf16 rounding:
// the reference's order (repro/kernels/mla_decode.py:169-182, :261-283).
//
// What bounds it on an H100.  The bytes of the live latent rows, each read
// once (1152 bytes a row in bf16, 580 in int8 with its sigma, at
// 3.35 TB/s): ~0.002 ms at the paged serve phase's decode step.  Its
// operations, 2 * rows * keys * (Dk + Dv), take about 1 us at 989 TFLOP/s
// there.  What cost the scalar body ~1 ms per 512-row block was latency:
// scalar FMA loops, and staging with two barriers per 32-dim strip and
// nothing in flight.
//
// Design.
// * Both products on tensor cores: mma.sync m16n8k16 (bf16 in, fp32
//   accumulate).  Over bf16 rows the B operands come from ldmatrix (.trans
//   for V, which is key-major), every staged row padded by 16 bytes so each
//   ldmatrix phase touches 32 distinct banks.  Over int8 rows ldmatrix
//   (b16 rows) does not apply: each lane builds its B fragments in
//   registers from the staged bytes and converts them exactly (i8x4_to_bf16).
//   - q.k: a lane's fragment is 2 consecutive dims of one key, at k = 2(l%4)
//     and 2(l%4) + 8.  The query tile is staged with its dims permuted in
//     4-byte pairs (q_dim), so that k-slot 2q + e of step kk is dim
//     16q + 4kk + e and k-slot 8 + 2q + e is dim 16q + 4kk + 2 + e: one
//     16-byte read of a key row then holds a lane's fragments for all four
//     steps of a 64-dim chunk, 64-byte rows need no padding.
//   - P.V: a lane's fragment is 2 consecutive keys of one column.  The
//     columns of each warp's 64 are relabelled (n-tile j, n) -> 8n + j, so
//     that one 8-byte read of a key row holds the lane's column n of all 8
//     n-tiles; two rows are interleaved byte by byte (prmt), and the
//     output is written back through the same relabelling, 16 contiguous
//     columns per lane.  Rows are padded by 16 bytes (528), so the 8-byte
//     reads of rows 2 apart fall 8 banks apart.
// * One stream of chunks per CTA through a ring of kStages buffers filled
//   by 16-byte cp.async copies: per block its score chunks (128 keys x 64
//   dims, strip by strip), then its value chunks (16 keys x Dv; over
//   HeadRows as many 16-key steps as a stage holds, v_keys).  A block's
//   key-row offsets, in 16-byte pieces (and, over int8, the rows' sigma),
//   are looked up through `key_row` (the block table) once, when the
//   producer reaches the block, into shared memory, so a copy costs no
//   lookup, division or multiply by Dk (a 64-bit multiply by Dk in each
//   copy's address slowed K2 by about a tenth on the H100, PERF.md).  The producer
//   runs kStages - 1 chunks ahead of the consumer, across the softmax and
//   across block boundaries, so the next strip, the block's values and the
//   next block's keys are in flight while a chunk is multiplied; one
//   barrier per chunk.  Key rows past `live`, query rows past G and
//   columns past Dk are zero-filled by the copy (src-size 0): a masked key
//   has p = 0, and 0 times stale bytes may be NaN; sigma is 0 past `live`.
// * A CTA takes kRows = 16 * kM query rows (kM = 1 or 2, chosen by the
//   launcher: 16-row tiles double a small decode grid, 32-row tiles halve
//   the key traffic of a large prefill grid).  Warp w scores keys
//   [16w, 16w + 16) of each strip for all rows into the block's fp32 score
//   strip in shared memory, so the row max, and with it the single state
//   update, is known before P.V.  Warp w then owns 2 * kM rows for the
//   softmax and the state (as in mla_rows.cuh), and for P.V the value
//   columns [64w, 64w + 64) of every row: its fp32 accumulators stay in
//   registers across blocks (kM x 8 fragments of 4 floats a thread), and
//   each rescales its own fragment rows (lane / 4 and lane / 4 + 8).
//
// On the H100 (PERF.md) the copies are in place when a chunk is consumed:
// what remains is each chunk's copy issue, operand loads (and, over int8,
// conversions) and mma work, which every warp runs one after the other
// while its CTA streams a block's keys and then its values.  Producer warps
// and TMA multicast across the row tiles of a slot are the next steps.
//
// The body is independent of the paging: the caller hands it an iterator
// over its KV blocks and a `key_row(pos)` functor (the row index of key
// position `pos` from the rows' base pointer; `addressable` keeps the
// pieces below 2^31): K2 walks its queue items through the block table,
// K5 one page at a time through the block table, K4 block_k-row blocks of
// contiguous rows, K6 its split's run of block_k-key blocks, K7 the blocks
// from its window start (EvenBlocks for the last four).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "amla.cuh"

namespace mla_rows_mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStripKeys = 16 * kWarps;          // 128 keys per score strip
constexpr int kDChunk = 64;                       // key dims per score chunk
constexpr int kVKeys = 16;                        // keys per value chunk
constexpr int kDvMax = 512;
constexpr int kBlockKMax = 512;
constexpr int kWarpNTiles = kDvMax / 8 / kWarps;  // value n-tiles per warp

// How a pool's rows are staged: elements per 16-byte copy, and elements per
// staged key row (score chunk) and value row.
template <typename TP>
struct Pool;
template <>
struct Pool<bf16> {
  static constexpr int kPiece = 8;
  static constexpr int kKStride = kDChunk + 8;
  static constexpr int kVStride = kDvMax + 8;
};
template <>
struct Pool<int8_t> {
  static constexpr int kPiece = 16;
  static constexpr int kKStride = kDChunk;
  static constexpr int kVStride = kDvMax + 16;
};

template <typename TP>
__host__ __device__ constexpr int stage_bytes() {
  return static_cast<int>(sizeof(TP)) *
         (kStripKeys * Pool<TP>::kKStride > kVKeys * Pool<TP>::kVStride
              ? kStripKeys * Pool<TP>::kKStride
              : kVKeys * Pool<TP>::kVStride);
}

template <int kM>
struct Tile {
  static constexpr int kRows = 16 * kM;
  static constexpr int kRowsPerWarp = kRows / kWarps;
  // as many bf16 ring stages as fit beside the tile at Dk 576, block_k 512
  static constexpr int kStages = kM == 1 ? 8 : 4;
};

// Row geometry and score transform of one launch (Dk, Dv multiples of the
// pool's 16-byte piece).  `window` and `causal` are read over HeadRows only:
// the MLA kernels are causal and have no window.
struct Geom {
  int G, Dk, Dv, block_k;
  float scale, softcap;  // softcap <= 0: off
  int window = 0;        // > 0: key k is visible to a row at q_pos iff k > q_pos - window
  int causal = 1;        // 0: keys past q_pos are visible too
};

// Where a launch's value rows lie.  LatentRows (K2, K4, K5): V is the first
// Dv columns of each key row, and key rows lie Dk elements apart.
// HeadRows (K6, K7): bf16 V rows of their own from `v`, key and value rows
// `k_rs` and `v_rs` 16-byte pieces apart (a (b, head) of a dense cache, or a
// transposed view of one), and the window and non-causal masks of Geom.
struct LatentRows {};
struct HeadRows {
  const bf16* v;
  int k_rs, v_rs;
};
template <typename Rows>
constexpr bool kHeadRows = std::is_same<Rows, HeadRows>::value;

// The positions of query rows that count from 0 (K7's prefill rows).
struct RowPositions {
  __device__ __forceinline__ int operator[](int r) const { return r; }
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Keys per value chunk and bf16 per staged value row: 16 keys of
// Pool::kVStride over LatentRows; over HeadRows (Dv <= 256) as many 16-key
// steps of Dv + 8 as one stage and the producer's copy passes hold (64 keys
// at Dv 128, 32 at 256), so a narrow head takes fewer, fuller chunks.
template <typename TP, bool kHead>
__host__ __device__ inline int v_keys(const Geom& g) {
  if (!kHead) return kVKeys;
  const int fit = stage_bytes<TP>() / (2 * (g.Dv + 8));
  const int copies = kVKeys * (kDvMax / Pool<TP>::kPiece) / (g.Dv / Pool<TP>::kPiece);
  const int keys = (fit < copies ? fit : copies) / kVKeys * kVKeys;
  return keys < kVKeys ? kVKeys : keys > kStripKeys ? kStripKeys : keys;
}
template <typename TP, bool kHead>
__host__ __device__ inline int v_stride(const Geom& g) {
  return kHead ? g.Dv + 8 : Pool<TP>::kVStride;
}
// bf16 per staged query row, per P row; floats per score row.
__host__ __device__ inline int q_stride(const Geom& g) { return round_up(g.Dk, kDChunk) + 8; }
__host__ __device__ inline int p_cols(const Geom& g) { return round_up(g.block_k, kVKeys); }
__host__ __device__ inline int p_stride(const Geom& g) { return p_cols(g) + 8; }

// Buffers of per-block key rows (and sigma).  The producer runs kStages - 1
// chunks ahead and a block takes at least n_dc + 1 chunks, so while the
// consumer still reads block X's sigma (its softmax) the producer may have
// entered block X + 1 + (kStages - 2) / (n_dc + 1).
template <int kM>
__host__ __device__ inline int key_bufs(const Geom& g) {
  return 2 + (Tile<kM>::kStages - 2) / (round_up(g.Dk, kDChunk) / kDChunk + 1);
}

template <typename TP, int kM, bool kHead = false>
inline size_t smem_bytes(const Geom& g) {
  constexpr int kRows = Tile<kM>::kRows;
  // key row (+ sigma over int8, + value row over HeadRows)
  constexpr size_t kKeyBytes = std::is_same<TP, int8_t>::value || kHead ? 8 : 4;
  return static_cast<size_t>(Tile<kM>::kStages) * stage_bytes<TP>() +
         2 * static_cast<size_t>(kRows) * (q_stride(g) + p_stride(g)) +
         4 * static_cast<size_t>(kRows) * (p_stride(g) + 2) +
         kKeyBytes * key_bufs<kM>(g) * p_cols(g);
}

// The CTA's dynamic shared memory, carved (every piece 16-byte aligned).
struct Smem {
  unsigned char* ring;  // kStages x stage_bytes
  bf16* q;              // kRows x q_stride
  bf16* p;              // kRows x p_stride: the block's p (* S16 (* sigma)), bf16
  float* s;             // kRows x p_stride: the block's scores
  float* rowf;          // kRows: alpha per block (base), then the denominators
  int* rowi;            // kRows: the int increment per block (amla)
  int* keys;            // key_bufs x p_cols: key-row offsets, in 16-byte pieces
  float* sigma;         // key_bufs x p_cols: their sigma (int8 pools)
  int* vals;            // the same place: value-row offsets in pieces (HeadRows)
};

template <typename TP, int kM>
__device__ __forceinline__ Smem carve(unsigned char* raw, const Geom& g) {
  constexpr int kRows = Tile<kM>::kRows;
  Smem sm;
  sm.ring = raw;
  sm.q = reinterpret_cast<bf16*>(raw + Tile<kM>::kStages * stage_bytes<TP>());
  sm.p = sm.q + kRows * q_stride(g);
  sm.s = reinterpret_cast<float*>(sm.p + kRows * p_stride(g));
  sm.rowf = sm.s + kRows * p_stride(g);
  sm.rowi = reinterpret_cast<int*>(sm.rowf + kRows);
  sm.keys = sm.rowi + kRows;
  sm.sigma = reinterpret_cast<float*>(sm.keys + key_bufs<kM>(g) * p_cols(g));
  sm.vals = reinterpret_cast<int*>(sm.sigma);
  return sm;
}

// Staged position of the query dims over int8 keys: pair pr (two dims) of
// a 64-dim chunk holds dims 16q + 4t + 2h, + 1 with pr = 8t + 4h + q.
__device__ __forceinline__ int q_dim(int pr) {
  return 16 * (pr & 3) + 4 * (pr >> 3) + 2 * ((pr >> 2) & 1);
}

// Four int8 (bytes of w, low first) as two bf16 pairs, exactly: each byte
// + 128 becomes the low mantissa byte of 2^23 + 128 + x, which minus
// 2^23 + 128 is x in fp32 with its low 16 bits zero, i.e. a bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; copies `src_bytes` (16 or 0)
// and zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// The same for 4 bytes (4 or 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of PTX wrappers ----------------------------------------------------

// The chunk stream's producer: walks the same blocks as the consumer, in
// the same order, kStages - 1 chunks ahead.  Every call commits one copy
// group (empty once the stream has ended), so the consumer's wait count
// stays fixed.  Entering a block writes its key rows (and sigma, 0 past
// live) into the next of `nb` shared buffers, the one block b uses being
// b % nb (the others may still feed the previous block's last copies, or
// the consumer's softmax): a CTA barrier must separate a call that may
// enter a block from the next call.  Over HeadRows each block's value-row
// offsets go into `vals` beside its key-row offsets.
template <typename TP, typename Blocks, typename KeyRow, typename Rows>
struct Producer {
  using P = Pool<TP>;
  static constexpr bool kScaled = std::is_same<TP, int8_t>::value;
  static constexpr bool kHead = kHeadRows<Rows>;
  static constexpr int kRowPieces = kDChunk / P::kPiece;  // copies per staged key row
  static constexpr int kKeyStep = kThreads / kRowPieces;  // key rows per pass
  static constexpr int kKeyPasses = kStripKeys / kKeyStep;
  static constexpr int kVPasses = kVKeys * (kDvMax / P::kPiece) / kThreads;
  Blocks blocks;
  KeyRow key_row;
  const TP* kv;
  const float* scales;  // int8 pools: sigma per pool row
  int* keys;            // nb x kcap key-row offsets, in 16-byte pieces
  float* sigma;         // nb x kcap sigma (int8 pools)
  Rows src;
  int* vals;            // nb x kcap value-row offsets, in 16-byte pieces (HeadRows)
  int kcap, nb, cap, Dk, Dv, n_dc, vkeys, vstride;
  bool valid;
  int buf, start, live, phase, ks, dc, kc;  // phase 0: score chunks, 1: value chunks
  int krow[kKeyPasses];                     // this thread's key rows in the strip
  int vkey[kVPasses], vseg[kVPasses];       // this thread's pieces of a value chunk

  __device__ __forceinline__ void init() {
    const int segs = Dv / P::kPiece;
#pragma unroll
    for (int j = 0; j < kVPasses; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      vkey[j] = idx < vkeys * segs ? idx / segs : -1;
      vseg[j] = idx < vkeys * segs ? idx - vkey[j] * segs : 0;
    }
    buf = nb - 1;
    begin();
  }

  __device__ __forceinline__ void begin() {
    valid = blocks.next(cap, start, live);
    phase = ks = dc = kc = 0;
    if (valid) {
      buf = buf + 1 == nb ? 0 : buf + 1;
      for (int k = threadIdx.x; k < (kScaled ? kcap : live); k += kThreads) {
        const int row = k < live ? static_cast<int>(key_row(start + k)) : 0;
        if constexpr (kHead) {
          keys[buf * kcap + k] = row * src.k_rs;
          vals[buf * kcap + k] = row * src.v_rs;
        } else {
          keys[buf * kcap + k] = row * (Dk / P::kPiece);
        }
        if (kScaled) sigma[buf * kcap + k] = k < live ? scales[row] : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void issue(unsigned char* stage_raw) {
    const int tid = threadIdx.x;
    TP* stage = reinterpret_cast<TP*>(stage_raw);
    const int* rows = keys + buf * kcap;
    if (valid && phase == 0) {
      // keys ks + tid / kRowPieces + kKeyStep i, dims dc * 64 + piece (tid % kRowPieces)
      if (dc == 0) {
#pragma unroll
        for (int i = 0; i < kKeyPasses; ++i) {
          const int key = ks + tid / kRowPieces + kKeyStep * i;
          krow[i] = key < live ? rows[key] : -1;
        }
      }
      const int col = (tid % kRowPieces) * P::kPiece;
      const int dim = dc * kDChunk + col;
#pragma unroll
      for (int i = 0; i < kKeyPasses; ++i) {
        const bool ok = krow[i] >= 0 && dim < Dk;
        cp_async16(stage + (tid / kRowPieces + kKeyStep * i) * P::kKStride + col,
                   ok ? kv + P::kPiece * static_cast<long long>(krow[i]) + dim : kv, ok ? 16 : 0);
      }
      if (++dc == n_dc) {
        dc = 0;
        ks += kStripKeys;
        if (ks >= live) phase = 1;
      }
    } else if (valid) {
      // keys kc .. kc + 15, all Dv columns
      const TP* vb = kv;
      const int* vrows = rows;
      if constexpr (kHead) {
        vb = src.v;
        vrows = vals + buf * kcap;
      }
#pragma unroll
      for (int j = 0; j < kVPasses; ++j) {
        if (vkey[j] >= 0) {
          const bool ok = kc + vkey[j] < live;
          const int col = vseg[j] * P::kPiece;
          cp_async16(stage + vkey[j] * vstride + col,
                     ok ? vb + P::kPiece * static_cast<long long>(vrows[kc + vkey[j]]) + col : vb,
                     ok ? 16 : 0);
        }
      }
      kc += vkeys;
      if (kc >= live) begin();
    }
    cp_async_commit();
  }
};

// Blocks of `size` keys from key 0, the last one cut at min(k_len, cap):
// K5's pages (size = page_size, k_len = min(kv_len, W * page_size)) and
// K4's blocks (size = block_k, k_len = min(kv_len, S)).
struct EvenBlocks {
  int start, k_len, size;
  __device__ __forceinline__ bool next(int cap, int& first, int& live) {
    const int end = min(k_len, cap);
    if (start >= end) return false;
    first = start;
    live = min(size, end - start);
    start += size;
    return true;
  }
};

// Key position `pos` is row `pos` from the rows' base (K4's cache of a
// request, K6's and K7's K and V of a (b, head)).
struct ContiguousRows {
  __device__ __forceinline__ long long operator()(int pos) const { return pos; }
};

// Online-softmax state of the warp's rows, held by all its lanes.
template <int kM>
struct RowState {
  static constexpr int R = Tile<kM>::kRowsPerWarp;
  float m[R], l[R], gamma[R], s16[R];
  int n[R], qp[R];
};

// Attend the tile of query rows [row0, row0 + kRows) of one request (q: its
// G rows of width Dk; q_pos[r]: their positions) over the KV blocks that
// `blocks` yields, and write the normalized rows into `o` (G x Dv) and,
// with `lse`, lse = m + log l (-inf when empty).
//
// `blocks.next(cap, start, live)` yields, in order, each block's first key
// position and its count of live keys (> 0), keys at or past `cap` (the
// tile's largest position + 1, or no cap over non-causal HeadRows) left
// out; `key_row(pos)` is the index of key row `pos` in `kv` (rows of Dk
// elements over LatentRows, `src.k_rs` pieces over HeadRows, whose value
// rows are the same indices in `src.v`), and over int8 rows
// `scales[key_row(pos)]` its sigma.  Every thread of the CTA calls this.
template <typename TP, int kM, bool kAmla, typename Blocks, typename KeyRow, typename QPos,
          typename Rows = LatentRows>
__device__ __forceinline__ void attend(unsigned char* raw, const Geom& g, const bf16* q,
                                       QPos q_pos, int row0, const TP* kv,
                                       const float* scales, const Blocks& blocks,
                                       KeyRow key_row, float* o, float* lse,
                                       Rows src = Rows{}) {
  constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  constexpr bool kHead = kHeadRows<Rows>;
  static_assert(!kHead || std::is_same<TP, bf16>::value, "HeadRows are bf16");
  constexpr int kRows = Tile<kM>::kRows;
  constexpr int R = Tile<kM>::kRowsPerWarp;
  constexpr int S = Tile<kM>::kStages;
  constexpr int kStage = stage_bytes<TP>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fr = lane >> 2;         // fragment row (and + 8)
  const int fc = 2 * (lane & 3);    // fragment column pair
  const Smem sm = carve<TP, kM>(raw, g);
  const int qs = q_stride(g), ps = p_stride(g);
  const int n_dc = (qs - 8) / kDChunk;
  const int kcap = p_cols(g), nb = key_bufs<kM>(g);
  const int vkeys = v_keys<TP, kHead>(g), vstride = v_stride<TP, kHead>(g);

  // The tile's largest position (-1 past G): keys past it mask every row.
  int qmax = lane < kRows && row0 + lane < g.G ? q_pos[row0 + lane] : -1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  const int cap = kHead && !g.causal ? INT_MAX : qmax + 1;

  // Query rows into shared memory (zero past G and past Dk), in the first
  // copy group with the first chunk: as they are over bf16 keys, with the
  // dims of each 64-dim chunk permuted by pairs (q_dim) over int8 keys.
  if (kInt8) {
    const int q_pairs = (qs - 8) / 2;
    for (int idx = tid; idx < kRows * q_pairs; idx += kThreads) {
      const int r = idx / q_pairs;
      const int pr = idx - r * q_pairs;
      const int dim = (pr >> 5) * kDChunk + q_dim(pr & 31);
      const bool ok = row0 + r < g.G && dim < g.Dk;
      cp_async4(sm.q + r * qs + 2 * pr,
                ok ? q + static_cast<size_t>(row0 + r) * g.Dk + dim : q, ok ? 4 : 0);
    }
  } else {
    const int q_segs = (qs - 8) / 8;
    for (int idx = tid; idx < kRows * q_segs; idx += kThreads) {
      const int r = idx / q_segs;
      const int seg = idx - r * q_segs;
      const bool ok = row0 + r < g.G && seg * 8 < g.Dk;
      cp_async16(sm.q + r * qs + seg * 8,
                 ok ? q + static_cast<size_t>(row0 + r) * g.Dk + seg * 8 : q, ok ? 16 : 0);
    }
  }
  Producer<TP, Blocks, KeyRow, Rows> prod{blocks, key_row, kv, scales, sm.keys, sm.sigma, src,
                                          sm.vals, kcap, nb, cap, g.Dk, g.Dv, n_dc, vkeys,
                                          vstride};
  prod.init();
  for (int s = 0; s < S - 1; ++s) {
    __syncthreads();  // the block entered last has its key rows in place
    prod.issue(sm.ring + s * kStage);
  }

  RowState<kM> st;
  {
    int n0;
    float inv_r0;
    amla::round_scale_to_pow2(amla::kMInit, &n0, &inv_r0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = row0 + warp * R + i;
      st.m[i] = amla::kMInit;
      st.l[i] = 0.0f;
      st.n[i] = n0;
      st.gamma[i] = 1.0f;
      st.s16[i] = amla::bf16_round(inv_r0);
      st.qp[i] = r < g.G ? q_pos[r] : -1;
    }
  }
  // This warp's value n-tiles: [nt0, nt0 + cnt) of Dv / 8 over bf16 rows;
  // over int8 rows the 8 relabelled n-tiles of columns [64w, 64w + 64).
  const int wnt = (g.Dv / 8 + kWarps - 1) / kWarps;
  const int nt0 = warp * wnt;
  const int cnt = kInt8 ? (warp * 64 < g.Dv ? kWarpNTiles : 0)
                        : max(0, min(g.Dv / 8, nt0 + wnt) - nt0);
  float acc[kM][kWarpNTiles][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int j = 0; j < kWarpNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

  Blocks it = blocks;
  int start, live, chunk = 0;
  for (int bi = 0; it.next(cap, start, live); ++bi) {
    const float* sig = sm.sigma + (bi % nb) * kcap;
    // ---- scores: s[r][col] = q_r . k_col over the live keys -------------
    for (int ks = 0; ks < live; ks += kStripKeys) {
      float sacc[kM][2][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mi][nj][e] = 0.0f;
      for (int dc = 0; dc < n_dc; ++dc, ++chunk) {
        cp_async_wait<S - 2>();
        __syncthreads();  // chunk landed for all; the stage refilled next is consumed
        prod.issue(sm.ring + ((chunk + S - 1) % S) * kStage);
        const unsigned char* kst = sm.ring + (chunk % S) * kStage;
        uint4 kw[2];  // int8: keys 16w + 8nj + lane / 4, dims 16 (lane % 4) .. + 15
        if (kInt8) {
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int key = warp * 16 + nj * 8 + (lane >> 2);
            kw[nj] = *reinterpret_cast<const uint4*>(kst + key * Pool<int8_t>::kKStride +
                                                     16 * (lane & 3));
          }
        }
#pragma unroll
        for (int kk = 0; kk < kDChunk / 16; ++kk) {
          uint32_t b[4];  // keys 16w .. +7 and +8 .. +15, dims kk*16 .. +15
          if (kInt8) {
            const uint32_t w0[4] = {kw[0].x, kw[0].y, kw[0].z, kw[0].w};
            const uint32_t w1[4] = {kw[1].x, kw[1].y, kw[1].z, kw[1].w};
            i8x4_to_bf16(w0[kk], b[0], b[1]);
            i8x4_to_bf16(w1[kk], b[2], b[3]);
          } else {
            ldsm_x4(b, reinterpret_cast<const bf16*>(kst) +
                           (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * Pool<bf16>::kKStride +
                           kk * 16 + ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, sm.q + (mi * 16 + (lane & 15)) * qs + dc * kDChunk + kk * 16 +
                           (lane >> 4) * 8);
            mma_bf16(sacc[mi][0], a, b[0], b[1]);
            mma_bf16(sacc[mi][1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int col = ks + warp * 16 + nj * 8 + fc;
          if (col < live) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              *reinterpret_cast<float2*>(sm.s + (mi * 16 + h * 8 + fr) * ps + col) =
                  make_float2(sacc[mi][nj][2 * h], sacc[mi][nj][2 * h + 1]);
            }
          }
        }
    }
    __syncthreads();  // the block's scores are in place

    // ---- one online-softmax + AMLA state update per row per block -------
    const int pcols = round_up(live, kVKeys);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp * R + i;
      float* srow = sm.s + r * ps;
      bf16* prow = sm.p + r * ps;
      // (sigma,) scale, then softcap, then clamp, then mask to -inf
      float rmax = -INFINITY;
      for (int col = lane; col < live; col += 32) {
        float x = -INFINITY;
        const int kpos = start + col;
        bool visible = kpos <= st.qp[i];
        if constexpr (kHead) {
          visible = (!g.causal || visible) && (g.window <= 0 || kpos > st.qp[i] - g.window);
        }
        if (visible) {
          x = kInt8 ? __fmul_rn(srow[col], sig[col]) : srow[col];
          x = __fmul_rn(x, g.scale);
          if (g.softcap > 0.0f) x = __fmul_rn(g.softcap, tanhf(__fdiv_rn(x, g.softcap)));
          x = fminf(fmaxf(x, -amla::kMClamp), amla::kMClamp);
        }
        srow[col] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = amla::warp_max(rmax);
      const float m_prev = st.m[i];
      const float m_new = fmaxf(m_prev, rmax);
      float psum = 0.0f;
      for (int col = lane; col < live; col += 32) {
        const float e = expf(__fsub_rn(srow[col], m_new));
        srow[col] = e;
        psum += e;
      }
      psum = amla::warp_sum(psum);
      st.l[i] = __fadd_rn(__fmul_rn(st.l[i], expf(__fsub_rn(m_prev, m_new))), psum);
      st.m[i] = m_new;
      float pscale = 1.0f;
      if (kAmla) {
        int n_new;
        float inv_r;
        amla::round_scale_to_pow2(m_new, &n_new, &inv_r);
        const float s = amla::bf16_round(inv_r);
        const float g_new = __fdiv_rn(inv_r, s);
        const float eps = __fsub_rn(__fdiv_rn(st.gamma[i], g_new), 1.0f);
        if (lane == 0) sm.rowi[r] = amla::pow2_int_increment(n_new - st.n[i], eps);
        st.n[i] = n_new;
        st.gamma[i] = g_new;
        st.s16[i] = s;
        pscale = s;
      } else if (lane == 0) {
        sm.rowf[r] = expf(__fsub_rn(m_prev, m_new));
      }
      // p_v = p * S16 (amla) or p, then * sigma over int8 rows, rounded to
      // bf16 before P.V; 0 past live
      for (int col = lane; col < pcols; col += 32) {
        float pv = 0.0f;
        if (col < live) {
          pv = kAmla ? __fmul_rn(srow[col], pscale) : srow[col];
          if (kInt8) pv = __fmul_rn(pv, sig[col]);
        }
        prow[col] = __float2bfloat16_rn(pv);
      }
    }
    __syncthreads();  // p and the per-row increments are in place

    // ---- rescale: MUL-by-ADD on the warp's fragment rows, skipped at 0 ---
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + h * 8 + fr;
        if (kAmla) {
          const int inc = sm.rowi[r];
          if (inc != 0) {
#pragma unroll
            for (int j = 0; j < kWarpNTiles; ++j) {
              if (j < cnt) {
                acc[mi][j][2 * h] = amla::apply_int_increment(acc[mi][j][2 * h], inc);
                acc[mi][j][2 * h + 1] = amla::apply_int_increment(acc[mi][j][2 * h + 1], inc);
              }
            }
          }
        } else {
          const float alpha = sm.rowf[r];
#pragma unroll
          for (int j = 0; j < kWarpNTiles; ++j) {
            acc[mi][j][2 * h] = __fmul_rn(acc[mi][j][2 * h], alpha);
            acc[mi][j][2 * h + 1] = __fmul_rn(acc[mi][j][2 * h + 1], alpha);
          }
        }
      }

    // ---- P.V, V the first Dv columns of the key rows (LatentRows) or the
    // value rows (HeadRows), vkeys keys a chunk in steps of 16 -------------
    for (int kc = 0; kc < live; kc += vkeys, ++chunk) {
      cp_async_wait<S - 2>();
      __syncthreads();
      prod.issue(sm.ring + ((chunk + S - 1) % S) * kStage);
      const unsigned char* vst = sm.ring + (chunk % S) * kStage;
      if (kInt8) {
        uint32_t a[kM][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          ldsm_x4(a[mi], sm.p + (mi * 16 + (lane & 15)) * ps + kc + (lane >> 4) * 8);
        }
        if (cnt == 0) continue;
        // keys 2(l%4), +1, +8, +9; columns 64w + 8(l/4) .. + 7 = n-tiles 0..7
        constexpr int kVS = Pool<int8_t>::kVStride;
        const unsigned char* vp = vst + 2 * (lane & 3) * kVS + warp * 64 + 8 * (lane >> 2);
        const bool ok = warp * 64 + 8 * (lane >> 2) < g.Dv;
        uint2 w[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          w[rr] = ok ? *reinterpret_cast<const uint2*>(vp + ((rr & 1) + 8 * (rr >> 1)) * kVS)
                     : make_uint2(0u, 0u);
        }
        uint32_t b[2][kWarpNTiles];  // [keys +0/+1 or +8/+9][n-tile]
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const uint2 x = w[2 * hk], y = w[2 * hk + 1];
          i8x4_to_bf16(__byte_perm(x.x, y.x, 0x5140), b[hk][0], b[hk][1]);
          i8x4_to_bf16(__byte_perm(x.x, y.x, 0x7362), b[hk][2], b[hk][3]);
          i8x4_to_bf16(__byte_perm(x.y, y.y, 0x5140), b[hk][4], b[hk][5]);
          i8x4_to_bf16(__byte_perm(x.y, y.y, 0x7362), b[hk][6], b[hk][7]);
        }
#pragma unroll
        for (int j = 0; j < kWarpNTiles; ++j)
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) mma_bf16(acc[mi][j], a[mi], b[0][j], b[1][j]);
      } else {
        // 16-key steps of the chunk that hold live keys (one over LatentRows)
        const int steps = kHead ? (min(vkeys, live - kc) + kVKeys - 1) / kVKeys : 1;
        for (int step = 0; step < steps; ++step) {
          const int ks = step * kVKeys;
          uint32_t a[kM][4];
#pragma unroll
          for (int mi = 0; mi < kM; ++mi) {
            ldsm_x4(a[mi], sm.p + (mi * 16 + (lane & 15)) * ps + kc + ks + (lane >> 4) * 8);
          }
          const bf16* vb = reinterpret_cast<const bf16*>(vst) + ks * vstride;
#pragma unroll
          for (int j = 0; j < kWarpNTiles; j += 2) {
            if (j + 1 < cnt) {
              uint32_t b[4];  // n-tiles j and j + 1, keys kc + ks .. +7 and +8 .. +15
              ldsm_x4_trans(b, vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * vstride +
                                   (nt0 + j) * 8 + (lane >> 4) * 8);
#pragma unroll
              for (int mi = 0; mi < kM; ++mi) {
                mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
                mma_bf16(acc[mi][j + 1], a[mi], b[2], b[3]);
              }
            } else if (j < cnt) {
              uint32_t b[2];
              ldsm_x2_trans(b, vb + (lane & 15) * vstride + (nt0 + j) * 8);
#pragma unroll
              for (int mi = 0; mi < kM; ++mi) mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- finalize: o = acc / (l * S16) (amla) or acc / l, 0 when empty ----
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp * R + i;
    if (lane == 0) {
      sm.rowf[r] = kAmla ? __fmul_rn(st.l[i], st.s16[i]) : st.l[i];
      // lse in standard units (m is the true running max, l the plain mass)
      if (lse != nullptr && row0 + r < g.G) {
        lse[row0 + r] = st.l[i] > 0.0f ? __fadd_rn(st.m[i], logf(st.l[i])) : -INFINITY;
      }
    }
  }
  __syncthreads();
  const auto fin = [](float x, float denom) { return denom > 0.0f ? __fdiv_rn(x, denom) : 0.0f; };
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mi * 16 + h * 8 + fr;
      if (row0 + r >= g.G) continue;
      const float denom = sm.rowf[r];
      float* orow = o + static_cast<size_t>(row0 + r) * g.Dv;
      if (kInt8) {
        // fragment column 2(l%4) + e of n-tile j is column 64w + 16(l%4) + 8e + j
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = warp * 64 + 16 * (lane & 3) + 8 * e;
          if (col < g.Dv) {
            float v[kWarpNTiles];
#pragma unroll
            for (int j = 0; j < kWarpNTiles; ++j) v[j] = fin(acc[mi][j][2 * h + e], denom);
            *reinterpret_cast<float4*>(orow + col) = make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(orow + col + 4) = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWarpNTiles; ++j) {
          if (j < cnt) {
            *reinterpret_cast<float2*>(orow + (nt0 + j) * 8 + fc) =
                make_float2(fin(acc[mi][j][2 * h], denom), fin(acc[mi][j][2 * h + 1], denom));
          }
        }
      }
    }
}

// ---- host side, shared by the launchers -------------------------------------

// Whether the body can address these rows: Dk and Dv whole 16-byte pieces,
// and `rows` rows of Dk elements (all that one base pointer reaches) below
// 2^31 pieces, since key offsets are kept as 32-bit piece counts.
template <typename TP>
inline bool addressable(const Geom& g, long long rows) {
  constexpr int kPiece = Pool<TP>::kPiece;
  return g.Dk % kPiece == 0 && g.Dv % kPiece == 0 && rows * (g.Dk / kPiece) < (1LL << 31);
}

// Element strides of a (B, H, S, D) tensor.
struct Strides {
  long long b, h, s;
};

// The same for HeadRows: q, k and v on 16-byte boundaries, k's and v's
// strides whole 16-byte pieces, and the offsets of the last of `rows` rows
// of a (b, head) below 2^31 pieces.
inline bool addressable(const Geom& g, long long rows, const void* q, const void* k,
                        Strides ks, const void* v, Strides vs) {
  constexpr int kPiece = Pool<bf16>::kPiece;
  const auto ok = [&](const void* t, Strides st) {
    return reinterpret_cast<uintptr_t>(t) % 16 == 0 && st.b % kPiece == 0 &&
           st.h % kPiece == 0 && st.s % kPiece == 0 && st.s >= 0 &&
           rows * (st.s / kPiece) < (1LL << 31);
  };
  return g.Dk % kPiece == 0 && g.Dv % kPiece == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         ok(k, ks) && ok(v, vs);
}

// 32-row tiles once their grid (`columns` x ceil(G / 32) CTAs) fills the
// card's SMs: they halve a large grid's key traffic; below that 16-row
// tiles double a decode step's few CTAs.
inline cudaError_t wide_tiles(long long columns, int G, bool* wide) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *wide = columns * ((G + 31) / 32) >= sms;
  return err;
}

// Launch `kernel(p)` on columns x ceil(G / (16 kM)) x splits CTAs of
// kThreads with the body's dynamic shared memory (over HeadRows: kHead).
template <typename TP, int kM, bool kHead = false, typename P>
inline cudaError_t launch_tiles(void (*kernel)(P), const P& p, const Geom& g, int columns,
                                cudaStream_t stream, int splits = 1) {
  constexpr int kRows = Tile<kM>::kRows;
  const int tiles = (g.G + kRows - 1) / kRows;
  if (tiles > 65535 || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<TP, kM, kHead>(g);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(columns, tiles, splits), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mla_rows_mma
