// Block-table addressing shared by the paged MLA kernels: the work-queue
// kernel (K2, mla_decode_paged.cu) and the padded-grid kernel (K5,
// mla_decode_paged_padded.cu), on either row body.
#pragma once

#include <cuda_runtime.h>

// Index of key row `pos` of a request in the page pool, through its block
// table (ids clamped into the pool, as the reference's tail redirect).
struct PagedRows {
  const int* bt;
  int page_size, num_pages;
  __device__ __forceinline__ long long operator()(int pos) const {
    const int pid = min(max(bt[pos / page_size], 0), num_pages - 1);
    return static_cast<long long>(pid) * page_size + pos % page_size;
  }
};

// Element offset of key row `pos` of a request (the scalar body's key_off).
struct PagedKeys {
  PagedRows rows;
  int Dk;
  __device__ __forceinline__ long long operator()(int pos) const { return rows(pos) * Dk; }
};
