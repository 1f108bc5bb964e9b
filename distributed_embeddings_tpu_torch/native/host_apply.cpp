// Host-memory sparse row optimizers for offloaded embedding buckets.
//
// The port's copy of distributed_embeddings_tpu/native/host_apply.cpp.
// The reference keeps over-budget tables on the CPU and updates them with
// host TF ops (dist_model_parallel.py:449-476, :829-831, :971-1017). Here
// the deduplicated update rows (rep/sums/valid, from prepare_safe_grad)
// are copied off the card, and these loops update the pinned host table
// and its optimizer state in place.
//
// Contract (ops/sparse_update.py host_apply_rows_inplace):
//  * rep[i] is in-bounds; slots with valid[i] == 0 are padding that aliases
//    row 0 with all-zero sums and are skipped (zero delta by construction).
//  * valid rows are unique (deduplicated), so a plain serial loop is exact;
//    the numerics are the float32 rules of host_apply_rows_plain, product
//    for product.

#include <cmath>
#include <cstdint>

extern "C" {

void ha_sgd(float* table, int64_t w, const int32_t* rep, const float* sums,
            const float* valid, int64_t n, float lr) {
  for (int64_t i = 0; i < n; ++i) {
    if (valid[i] == 0.0f) continue;
    float* t = table + (int64_t)rep[i] * w;
    const float* s = sums + i * w;
    for (int64_t j = 0; j < w; ++j) t[j] -= lr * s[j];
  }
}

void ha_adagrad(float* table, float* acc, int64_t w, const int32_t* rep,
                const float* sums, const float* valid, int64_t n, float lr,
                float eps) {
  for (int64_t i = 0; i < n; ++i) {
    if (valid[i] == 0.0f) continue;
    const int64_t r = (int64_t)rep[i] * w;
    float* t = table + r;
    float* a = acc + r;
    const float* s = sums + i * w;
    for (int64_t j = 0; j < w; ++j) {
      a[j] += s[j] * s[j];
      t[j] -= lr * s[j] / std::sqrt(a[j] + eps);
    }
  }
}

// c1/c2 are the bias corrections 1-b1^t / 1-b2^t for the ALREADY
// incremented step count (the caller owns the scalar count update).
void ha_adam(float* table, float* mu, float* nu, int64_t w,
             const int32_t* rep, const float* sums, const float* valid,
             int64_t n, float lr, float b1, float b2, float c1, float c2,
             float eps) {
  for (int64_t i = 0; i < n; ++i) {
    if (valid[i] == 0.0f) continue;
    const int64_t r = (int64_t)rep[i] * w;
    float* t = table + r;
    float* m = mu + r;
    float* v = nu + r;
    const float* s = sums + i * w;
    for (int64_t j = 0; j < w; ++j) {
      m[j] = b1 * m[j] + (1.0f - b1) * s[j];
      v[j] = b2 * v[j] + (1.0f - b2) * s[j] * s[j];
      t[j] -= lr * (m[j] / c1) / (std::sqrt(v[j] / c2) + eps);
    }
  }
}

}  // extern "C"
