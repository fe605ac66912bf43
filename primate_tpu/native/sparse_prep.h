// C ABI of the primate_tpu native sparse-prep runtime (see sparse_prep.cpp).
//
// Role parity: the reference ships C++ headers for downstream extensions
// (`primate.get_include()`, src/primate/__init__.py:17-38). In this build
// the extension point for *compute* is the Python operator protocol (any
// jittable callable); this header covers the host-side data-path ABI so
// external loaders can feed device-ready BSR/DIA layouts directly.
//
// All sizing is two-call: a *_count function returns allocation sizes, then a
// *_fill function populates caller-owned, zero-initialised buffers. Index
// arrays are int64 (nnz-safe); data is float32 or float64 via the suffixed
// entry points.

#pragma once
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// CSR -> tiled BSR on the ceil-padded block grid; one zero "coverage" block
// per empty block-row so every block-row owns at least one stored block. Returns total stored blocks (nnzb).
int64_t bsr_count(int64_t n_rows, int64_t n_cols, int64_t bm, int64_t bn,
                  const int64_t* indptr, const int32_t* indices,
                  int64_t* brow_counts /* ceil(n_rows/bm) */);

void bsr_fill_f32(int64_t n_rows, int64_t n_cols, int64_t bm, int64_t bn,
                  const int64_t* indptr, const int32_t* indices,
                  const float* data, const int64_t* brow_counts,
                  float* blocks /* nnzb*bm*bn, zeroed */, int32_t* colids,
                  int64_t* indptr_b);
void bsr_fill_f64(int64_t n_rows, int64_t n_cols, int64_t bm, int64_t bn,
                  const int64_t* indptr, const int32_t* indices,
                  const double* data, const int64_t* brow_counts,
                  double* blocks, int32_t* colids, int64_t* indptr_b);

// CSR -> row-aligned DIA bands: band[k][r] = A[r, r + offsets[k]].
int64_t dia_count(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                  const int32_t* indices,
                  int64_t* offsets_out /* n_rows+n_cols-1 */);

void dia_fill_f32(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                  const int32_t* indices, const float* data, int64_t n_d,
                  const int64_t* offsets, float* bands /* n_d*n_rows, zeroed */);
void dia_fill_f64(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                  const int32_t* indices, const double* data, int64_t n_d,
                  const int64_t* offsets, double* bands);

#ifdef __cplusplus
}  // extern "C"
#endif
