// Split-KV combine for work-queue AMLA decode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mla_decode_combine.py:
// _combine_kernel / combine_split_partials (K3), and its heterogeneous form
// combine_hetero_partials.
//
// What it computes.  For each request b and query row g, the LSE-weighted
// merge of the first n_splits[b] partial slots named in dest_table[b]:
//   out = sum_j exp(lse_j - M) o_j / sum_j exp(lse_j - M),  M = max_j lse_j,
// as a running (acc, m, w) merge over j = 0 .. n_splits[b] - 1 in that
// order, whose max starts at BIG_NEG, so an empty partial (lse = -inf)
// weighs exactly 0 and a request with no live split gives exact zeros.
// The partials that padding columns of dest_table name are never read (the
// entries themselves may be loaded with the live ones, as the reference's
// scalar prefetch loads the whole table).  The partials may lie in two
// sources (the shared-prefix path's suffix and prefix passes): slot s < D0
// is row s of source 0, any other slot row s - D0 of source 1, so that
// merge needs no concatenated copy.
//
// What bounds it on an H100: bytes at the prefill chunk (the live partial
// rows, Dv fp32 + one lse each, read once and the (B, G, Dv) output written
// once, at 3.35 TB/s); at the decode shapes and K6's splits, where the
// bytes take well under a microsecond, the launch and the chain of
// dependent loads: the slot id, then the lse and the partial row it names.
//
// Design.  One group of lanes takes one piece of one row (b, g): each lane
// owns one float4 of Dv (one float where Dv or an address is not 16-byte
// aligned), 8, 16 or 32 lanes a group, so a row of Dv 64 is one 16-lane
// group and a row of Dv 512 four 32-lane groups, and no lane idles at the
// serve shapes.  A group loads the slot ids of up to one group-width of its
// row's splits, one lane per split, beside the row's split count; then
// every lane starts the lse load of its split and the group the partial
// rows of U splits at once (U from the table's width, at most 16), before
// the merge consumes them in order.  So a row of up to U splits costs two
// dependent memory round trips.  Partials and output are touched once:
// streaming loads and stores.  The grid runs over the B x G rows along x (no cap on B) and over
// the pieces of a row along y; a row's request comes from a multiply-high,
// not a division.  CTAs shrink to one warp when the groups would not fill
// the SMs twice, so the few rows of K6's splits spread over the card.  No
// shared memory, no allocation.
#include <cuda_runtime.h>

namespace {

constexpr float kBigNeg = -3.0e38f;
constexpr int kMaxUnroll = 16;   // partial rows in flight per lane
constexpr int kMaxThreads = 128;  // a CTA: 32 threads when the grid is small

// Where the partials of a slot lie.
struct Sources {
  const float* o0;
  const float* lse0;
  const float* o1;
  const float* lse1;
  int d0;  // slots of source 0
};

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T merge(T acc, float alpha, float wj, T o) {
    return make_float4(acc.x * alpha + wj * o.x, acc.y * alpha + wj * o.y,
                       acc.z * alpha + wj * o.z, acc.w * alpha + wj * o.w);
  }
  static __device__ __forceinline__ T finish(T acc, float w) {
    return w > 0.0f ? make_float4(acc.x / w, acc.y / w, acc.z / w, acc.w / w) : zero();
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T merge(T acc, float alpha, float wj, T o) {
    return acc * alpha + wj * o;
  }
  static __device__ __forceinline__ T finish(T acc, float w) { return w > 0.0f ? acc / w : 0.0f; }
};

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the round-up
// method): the row's request is known a few cycles after the launch, not
// after an integer division.
struct FastDiv {
  unsigned magic;
  int shift;
  explicit FastDiv(int d) : shift(0) {
    while ((1u << shift) < static_cast<unsigned>(d)) ++shift;
    magic = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), magic) + n) >> shift);
  }
};

// How the rows are cut: a group of `lanes` = 1 << lane_shift threads (8, 16
// or 32, aligned in the warp) takes VEC floats a lane, i.e. one piece of
// lanes * VEC floats of a row.  blockIdx.y is the piece; along x, group u
// takes row u = b * G + g.  The launcher holds rows * lanes below 2^31, so
// the index math is 32-bit.
struct Geometry {
  int G, Dv, S, lane_shift, rows;
  FastDiv by_g;
};

template <int VEC, int U>
__global__ void __launch_bounds__(kMaxThreads)
    combine_kernel(Sources src, const int* __restrict__ dest_table,
                   const int* __restrict__ n_splits, float* __restrict__ out, Geometry geo) {
  using V = typename Vec<VEC>::T;
  const int lanes = 1 << geo.lane_shift;
  const int row = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) >> geo.lane_shift);
  if (row >= geo.rows) return;  // uniform within a group
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const unsigned mask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  const int b = geo.by_g(row);
  const int g = row - b * geo.G;
  const int col = (static_cast<int>(blockIdx.y) * lanes + sub) * VEC;
  const bool owns = col < geo.Dv;
  const int* slots = dest_table + static_cast<long long>(b) * geo.S;
  const int first_slot = sub < geo.S ? slots[sub] : 0;  // loaded beside n_splits[b]
  const int live = min(n_splits[b], geo.S);

  V acc = Vec<VEC>::zero();
  float m = kBigNeg, w = 0.0f;
  for (int base = 0; base < live; base += lanes) {
    const int cnt = min(lanes, live - base);
    // Step 1: this lane's split of the chunk: its slot, then (in flight with
    // the partial rows below) its lse.
    const float* my_row = nullptr;
    float my_lse = 0.0f;
    if (sub < cnt) {
      const int slot = base == 0 ? first_slot : slots[base + sub];
      const bool first = slot < src.d0;
      const long long r = static_cast<long long>(first ? slot : slot - src.d0) * geo.G + g;
      my_lse = (first ? src.lse0 : src.lse1)[r];
      my_row = (first ? src.o0 : src.o1) + r * geo.Dv;
    }
    // Step 2: the partial rows of U splits in flight together (read once:
    // streaming loads), then the merge in split order.
    for (int j0 = 0; j0 < cnt; j0 += U) {
      V v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* row_u = reinterpret_cast<const float*>(__shfl_sync(
            mask, reinterpret_cast<unsigned long long>(my_row), (j0 + u) & (lanes - 1), lanes));
        v[u] = owns && j0 + u < cnt ? __ldcs(reinterpret_cast<const V*>(row_u + col))
                                    : Vec<VEC>::zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float lj = __shfl_sync(mask, my_lse, (j0 + u) & (lanes - 1), lanes);
        if (j0 + u < cnt) {
          const float m_new = fmaxf(m, lj);
          const float alpha = expf(m - m_new);
          const float wj = expf(lj - m_new);  // 0 for an empty partial (lse = -inf)
          acc = Vec<VEC>::merge(acc, alpha, wj, v[u]);
          w = w * alpha + wj;
          m = m_new;
        }
      }
    }
  }
  if (owns) {
    __stcs(reinterpret_cast<V*>(out + static_cast<long long>(row) * geo.Dv + col),
           Vec<VEC>::finish(acc, w));
  }
}

template <int VEC, int U>
cudaError_t launch(const Sources& src, const int* dest_table, const int* n_splits, float* out,
                   const Geometry& geo, dim3 grid, int threads, cudaStream_t stream) {
  combine_kernel<VEC, U><<<grid, threads, 0, stream>>>(src, dest_table, n_splits, out, geo);
  return cudaGetLastError();
}

// The instantiations: U partial rows in flight, 2, 4, 8 or 16.
template <int VEC>
cudaError_t launch_unrolled(int unroll, const Sources& src, const int* dest_table,
                            const int* n_splits, float* out, const Geometry& geo, dim3 grid,
                            int threads, cudaStream_t stream) {
  switch (unroll) {
    case 2: return launch<VEC, 2>(src, dest_table, n_splits, out, geo, grid, threads, stream);
    case 4: return launch<VEC, 4>(src, dest_table, n_splits, out, geo, grid, threads, stream);
    case 8: return launch<VEC, 8>(src, dest_table, n_splits, out, geo, grid, threads, stream);
    default:
      return launch<VEC, kMaxUnroll>(src, dest_table, n_splits, out, geo, grid, threads, stream);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15u) == 0; }

}  // namespace

// ---- host launcher ----

// Merges partials from source 0 (o0, lse0: slots 0 .. d0 - 1) and, where
// o1 is not null, source 1 (o1, lse1: slots d0 ..), both (Di, G, Dv) and
// (Di, G, 1) fp32, into out (B, G, Dv).  Returns a cudaError_t (0 on
// success); launches on `stream`, no sync.
extern "C" int amla_combine_split_partials(const float* o0, const float* lse0, const float* o1,
                                           const float* lse1, const int* dest_table,
                                           const int* n_splits, float* out, int d0, int B, int G,
                                           int Dv, int S, void* stream) {
  if (B < 1 || G < 1 || Dv < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Sources src{o0, lse0, o1 ? o1 : o0, o1 ? lse1 : lse0, o1 ? d0 : 0x7fffffff};
  const int vec = Dv % 4 == 0 && aligned16(o0) && aligned16(src.o1) && aligned16(out) ? 4 : 1;
  const int cols = Dv / vec;
  int unroll = 2;
  while (unroll < S && unroll < kMaxUnroll) unroll *= 2;
  int lane_shift = 3;
  while ((1 << lane_shift) < cols && lane_shift < 5) ++lane_shift;
  const int lanes = 1 << lane_shift;
  unroll = min(unroll, lanes);
  const int pieces = (cols + lanes - 1) / lanes;
  const long long row_threads = static_cast<long long>(B) * G * lanes;
  if (row_threads > 0x7fffffffLL || pieces > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{G, Dv, S, lane_shift, B * G, FastDiv(G)};
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = row_threads * pieces >= 2LL * sms * kMaxThreads ? kMaxThreads : 32;
  const dim3 grid(static_cast<unsigned>((row_threads + threads - 1) / threads), pieces);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec == 4 ? launch_unrolled<4>(unroll, src, dest_table, n_splits, out, geo, grid, threads, st)
               : launch_unrolled<1>(unroll, src, dest_table, n_splits, out, geo, grid, threads, st));
}

extern "C" const char* amla_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
