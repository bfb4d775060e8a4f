// Native host-side collation: ragged graphs -> padded batch arrays.
//
// The port's own copy of dgmc_tpu/native/collate.cpp (the JAX package's
// C++ collation engine), with one change to its interface: each field of
// the whole batch arrives as one contiguous buffer (the graphs' arrays
// concatenated, with offsets), so the binding hands over a batch in a few
// NumPy calls instead of a pointer per graph and field. One pass fills the
// batch's padded arrays, memcpy-bound.
//
// Loaded via ctypes (dgmc_tpu_torch/native/__init__.py), which builds it
// at first use with the system g++ into dgmc_tpu_torch/_build/:
//   g++ -O3 -shared -fPIC -o libcollate_<hash>.so collate.cpp
// with a NumPy fallback when no compiler is available.

#include <cstdint>
#include <cstring>

extern "C" {

// All output buffers are caller-allocated and zero-initialised by the
// caller contract EXCEPT masks, which this function fully writes.
//   B: batch size; N/E: padded node/edge counts; C: feature dim;
//   D: edge-attr dim (0 = none).
//   node_off/edge_off: [B + 1] offsets of graph b's nodes / edges in the
//     concatenated inputs.
//   x:         [node_off[B], C] float32 node features (may be null -> zeros)
//   senders/receivers: [edge_off[B]] int64 graph-local edge endpoints
//   eattr:     [edge_off[B], D] float32 edge attributes (may be null)
// Returns 0 on success, b+1 if graph b exceeds the padding.
int pad_graph_batch(
    int64_t B, int64_t N, int64_t E, int64_t C, int64_t D,
    const int64_t* node_off, const int64_t* edge_off,
    const float* x, const int64_t* senders, const int64_t* receivers,
    const float* eattr,
    float* x_out,            // [B, N, C]
    int32_t* senders_out,    // [B, E]
    int32_t* receivers_out,  // [B, E]
    uint8_t* node_mask_out,  // [B, N]
    uint8_t* edge_mask_out,  // [B, E]
    float* eattr_out) {      // [B, E, D] or null
  for (int64_t b = 0; b < B; ++b) {
    const int64_t n = node_off[b + 1] - node_off[b];
    const int64_t e = edge_off[b + 1] - edge_off[b];
    if (n > N || e > E) return static_cast<int>(b + 1);

    if (x != nullptr) {
      std::memcpy(x_out + b * N * C, x + node_off[b] * C,
                  sizeof(float) * n * C);
    }
    const int64_t* s_in = senders + edge_off[b];
    const int64_t* r_in = receivers + edge_off[b];
    int32_t* s_row = senders_out + b * E;
    int32_t* r_row = receivers_out + b * E;
    for (int64_t i = 0; i < e; ++i) {
      s_row[i] = static_cast<int32_t>(s_in[i]);
      r_row[i] = static_cast<int32_t>(r_in[i]);
    }
    uint8_t* nm = node_mask_out + b * N;
    std::memset(nm, 1, n);
    std::memset(nm + n, 0, N - n);
    uint8_t* em = edge_mask_out + b * E;
    std::memset(em, 1, e);
    std::memset(em + e, 0, E - e);
    if (eattr_out != nullptr && eattr != nullptr) {
      std::memcpy(eattr_out + b * E * D, eattr + edge_off[b] * D,
                  sizeof(float) * e * D);
    }
  }
  return 0;
}

// Dense ground-truth padding: pair b's target columns are
// y_cols[off[b] .. off[b + 1]) (int64, -1 invalid); writes y_out [B, N]
// int32 (-1 padded) and y_mask_out [B, N] uint8.
void pad_ground_truth(
    int64_t B, int64_t N, const int64_t* off, const int64_t* y_cols,
    int32_t* y_out, uint8_t* y_mask_out) {
  for (int64_t b = 0; b < B; ++b) {
    int32_t* y_row = y_out + b * N;
    uint8_t* m_row = y_mask_out + b * N;
    const int64_t* col = y_cols + off[b];
    const int64_t len = off[b + 1] - off[b];
    for (int64_t i = 0; i < len; ++i) {
      const int64_t v = col[i];
      y_row[i] = static_cast<int32_t>(v);
      m_row[i] = v >= 0 ? 1 : 0;
    }
    for (int64_t i = len; i < N; ++i) {
      y_row[i] = -1;
      m_row[i] = 0;
    }
  }
}

}  // extern "C"
