// Native feature packer: batch tokenization into fixed-shape tensors.
//
// The offline tokenization stage (recsys_tpu_torch/data/dataset.py
// tokenize_items) is a Python loop over items x fields x words; at
// production catalog scale (millions of items, hourly refresh) it becomes
// the ETL hot path — the same loop the reference ran per-STEP through
// HuggingFace tokenizers (its worst CPU hot loop, SURVEY.md §3.2). This
// C++ implementation packs the whole batch in one call:
//
//   * normalize: lowercase, split on non-alphanumeric runs;
//   * CRC32-bucket each word into [1, vocab_size)  (identical ids to
//     recsys_tpu_torch/data/tokenizer.py — same crc32 of the UTF-8 bytes);
//   * write left-aligned ids + mask (+ per-token value index for the RE
//     value-dropout augmentation) into caller-provided numpy buffers.
//
// Strings cross the ctypes boundary as one concatenated UTF-8 blob plus an
// int64 offsets array (no per-string marshalling).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// CRC-32 (IEEE 802.3, zlib-compatible) — table generated at first use so
// ids match Python's zlib.crc32 exactly.
const uint32_t* crc_table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  return table;
}

uint32_t crc32_of(const char* data, size_t len) {
  const uint32_t* t = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = t[(c ^ (uint8_t)data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline bool is_word_char(char ch) {
  return (ch >= 'a' && ch <= 'z') || (ch >= '0' && ch <= '9');
}

inline char lower(char ch) {
  return (ch >= 'A' && ch <= 'Z') ? ch - 'A' + 'a' : ch;
}

// Tokenize one string: lowercase words of [a-z0-9]+, crc32-bucketed.
// Returns number of tokens written (<= max_len).
int tokenize_into(const char* s, int64_t len, int vocab_size, int max_len,
                  int32_t* ids, int32_t* mask) {
  int n = 0;
  int64_t i = 0;
  std::vector<char> word;
  while (i < len && n < max_len) {
    char ch = lower(s[i]);
    if (is_word_char(ch)) {
      word.clear();
      while (i < len) {
        char c2 = lower(s[i]);
        if (!is_word_char(c2)) break;
        word.push_back(c2);
        ++i;
      }
      uint32_t h = crc32_of(word.data(), word.size());
      ids[n] = 1 + (int32_t)(h % (uint32_t)(vocab_size - 1));
      mask[n] = 1;
      ++n;
    } else {
      ++i;
    }
  }
  return n;
}

}  // namespace

extern "C" {

// Batch text encode: m strings (blob + offsets[m+1]) -> ids/mask (m, max_len).
void featurepack_encode_batch(const char* blob, const int64_t* offsets,
                              int64_t m, int vocab_size, int max_len,
                              int32_t* out_ids, int32_t* out_mask,
                              int num_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int32_t* ids = out_ids + r * max_len;
      int32_t* mask = out_mask + r * max_len;
      std::memset(ids, 0, sizeof(int32_t) * max_len);
      std::memset(mask, 0, sizeof(int32_t) * max_len);
      tokenize_into(blob + offsets[r], offsets[r + 1] - offsets[r],
                    vocab_size, max_len, ids, mask);
    }
  };
  if (num_threads <= 1 || m < 256) {
    work(0, m);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (m + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(m, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// RE-field packing: for each (item, field) cell a LIST of value strings.
// Inputs: value blob + offsets (V+1) over all values, plus cell_starts
// ((n*f)+1) giving each cell's [start, end) range into the value list.
// Outputs (n, f, max_tokens): token ids, mask, and 1-based value index of
// each token (for value-level dropout).
void featurepack_encode_fields(const char* blob, const int64_t* offsets,
                               const int64_t* cell_starts, int64_t n_cells,
                               int vocab_size, int max_tokens,
                               int32_t* out_ids, int32_t* out_mask,
                               int32_t* out_value, int num_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> tmp_ids(max_tokens), tmp_mask(max_tokens);
    for (int64_t c = lo; c < hi; ++c) {
      int32_t* ids = out_ids + c * max_tokens;
      int32_t* mask = out_mask + c * max_tokens;
      int32_t* val = out_value + c * max_tokens;
      std::memset(ids, 0, sizeof(int32_t) * max_tokens);
      std::memset(mask, 0, sizeof(int32_t) * max_tokens);
      std::memset(val, 0, sizeof(int32_t) * max_tokens);
      int pos = 0;
      for (int64_t v = cell_starts[c]; v < cell_starts[c + 1] && pos < max_tokens; ++v) {
        int got = tokenize_into(blob + offsets[v], offsets[v + 1] - offsets[v],
                                vocab_size, max_tokens - pos,
                                tmp_ids.data(), tmp_mask.data());
        for (int k = 0; k < got; ++k) {
          ids[pos] = tmp_ids[k];
          mask[pos] = 1;
          val[pos] = (int32_t)(v - cell_starts[c]) + 1;
          ++pos;
        }
      }
    }
  };
  if (num_threads <= 1 || n_cells < 256) {
    work(0, n_cells);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n_cells + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(n_cells, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
