// Host data plane: the per-rollout host loops of the trainer in C++.
//
// Three functions with plain C entry points, loaded with ctypes by
// trlx_tpu_torch/native/__init__.py, which builds this file with
// `g++ -O3 -shared -fPIC` at first use. Their semantics are those of the
// numpy versions in that module (plain_pad_collate_i32, plain_pad_collate_f32,
// plain_find_stop_positions), against which the tests hold them.

#include <cstdint>
#include <cstring>

extern "C" {

// Pad a ragged batch of int32 rows into out[batch, target_len] and write the
// 0/1 mask. Row i is rows[offsets[i] : offsets[i] + lengths[i]]. A row longer
// than target_len keeps its tail when pad_left != 0 and its head otherwise.
void pad_collate_i32(const int32_t* rows, const int64_t* offsets,
                     const int64_t* lengths, int64_t batch, int64_t target_len,
                     int32_t pad_value, int pad_left, int32_t* out,
                     int32_t* mask) {
  for (int64_t i = 0; i < batch; ++i) {
    int32_t* out_row = out + i * target_len;
    int32_t* mask_row = mask + i * target_len;
    for (int64_t j = 0; j < target_len; ++j) {
      out_row[j] = pad_value;
      mask_row[j] = 0;
    }
    int64_t len = lengths[i];
    const int32_t* src = rows + offsets[i];
    if (len > target_len) {
      if (pad_left) src += len - target_len;
      len = target_len;
    }
    const int64_t start = pad_left ? target_len - len : 0;
    if (len > 0) std::memcpy(out_row + start, src, len * sizeof(int32_t));
    for (int64_t j = 0; j < len; ++j) mask_row[start + j] = 1;
  }
}

// The same for float32 rows (logprobs, values, rewards), without a mask.
void pad_collate_f32(const float* rows, const int64_t* offsets,
                     const int64_t* lengths, int64_t batch, int64_t target_len,
                     float pad_value, int pad_left, float* out) {
  for (int64_t i = 0; i < batch; ++i) {
    float* out_row = out + i * target_len;
    for (int64_t j = 0; j < target_len; ++j) out_row[j] = pad_value;
    int64_t len = lengths[i];
    const float* src = rows + offsets[i];
    if (len > target_len) {
      if (pad_left) src += len - target_len;
      len = target_len;
    }
    const int64_t start = pad_left ? target_len - len : 0;
    if (len > 0) std::memcpy(out_row + start, src, len * sizeof(float));
  }
}

// For each row of seqs[batch, seq_len], the start of the first occurrence of
// any stop sequence, or seq_len when none occurs. Stop s is
// stops[stop_offsets[s] : stop_offsets[s] + stop_lens[s]]; an empty stop, or
// one longer than the row, never matches.
void find_stop_positions(const int32_t* seqs, int64_t batch, int64_t seq_len,
                         const int32_t* stops, const int64_t* stop_offsets,
                         const int64_t* stop_lens, int64_t n_stops,
                         int64_t* out) {
  for (int64_t i = 0; i < batch; ++i) {
    const int32_t* row = seqs + i * seq_len;
    int64_t best = seq_len;
    for (int64_t s = 0; s < n_stops; ++s) {
      const int32_t* pat = stops + stop_offsets[s];
      const int64_t m = stop_lens[s];
      if (m == 0 || m > seq_len) continue;
      for (int64_t j = 0; j + m <= seq_len && j < best; ++j) {
        if (std::memcmp(row + j, pat, m * sizeof(int32_t)) == 0) {
          best = j;
          break;
        }
      }
    }
    out[i] = best;
  }
}

}  // extern "C"
