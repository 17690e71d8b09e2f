// Native BPE tokenizer encoder/decoder for the text serving path (a copy
// of gofr_tpu/native/tokenizer.cpp): text -> token ids sits in front of
// every /generate request, and a Python inner loop there costs more than
// a decode step at high request rates. Host code, not a device kernel.
//
// Model: byte-level BPE. Token ids 0..255 are raw bytes; merge i produces
// id 256+i from (left, right). Encoding repeatedly applies the
// lowest-rank adjacent merge (classic BPE, priority by rank); decode
// concatenates recursively-expanded byte strings.
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   gofr_tok_new(pairs, n)            -> handle   (pairs: 2*n int32)
//   gofr_tok_encode(h, text, len, out, cap) -> n_tokens (or -1)
//   gofr_tok_decode(h, ids, n, out, cap)    -> n_bytes  (or -1)
//   gofr_tok_free(h)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
    // merge (left<<32|right) -> rank
    std::unordered_map<uint64_t, int32_t> ranks;
    // token id -> produced pair (for decode); bytes have no entry
    std::vector<std::pair<int32_t, int32_t>> pairs;
    // token id -> expanded byte string, built lazily at decode
    std::vector<std::string> bytes_cache;

    const std::string& expand(int32_t id) {
        std::string& slot = bytes_cache[id];
        if (slot.empty() && id >= 256) {
            const auto& pr = pairs[id - 256];
            slot = expand(pr.first) + expand(pr.second);
        }
        return slot;
    }
};

inline uint64_t pack(int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32)
         | static_cast<uint32_t>(b);
}

}  // namespace

extern "C" {

void* gofr_tok_new(const int32_t* merge_pairs, int32_t n_merges) {
    auto* tok = new Tokenizer();
    tok->pairs.reserve(n_merges);
    tok->ranks.reserve(n_merges * 2);
    for (int32_t i = 0; i < n_merges; ++i) {
        int32_t left = merge_pairs[2 * i];
        int32_t right = merge_pairs[2 * i + 1];
        tok->pairs.emplace_back(left, right);
        tok->ranks.emplace(pack(left, right), i);
    }
    tok->bytes_cache.resize(256 + n_merges);
    for (int32_t b = 0; b < 256; ++b)
        tok->bytes_cache[b] = std::string(1, static_cast<char>(b));
    return tok;
}

int32_t gofr_tok_encode(void* handle, const uint8_t* text, int32_t len,
                        int32_t* out, int32_t cap) {
    auto* tok = static_cast<Tokenizer*>(handle);
    std::vector<int32_t> ids(text, text + len);
    // classic BPE: merge the lowest-rank adjacent pair until none applies.
    // O(n * n_merges_applied) with early exit; fine for request-sized text.
    while (ids.size() >= 2) {
        int32_t best_rank = INT32_MAX;
        size_t best_pos = 0;
        for (size_t i = 0; i + 1 < ids.size(); ++i) {
            auto it = tok->ranks.find(pack(ids[i], ids[i + 1]));
            if (it != tok->ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_pos = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        ids[best_pos] = 256 + best_rank;
        ids.erase(ids.begin() + best_pos + 1);
    }
    if (static_cast<int32_t>(ids.size()) > cap) return -1;
    std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
    return static_cast<int32_t>(ids.size());
}

int32_t gofr_tok_decode(void* handle, const int32_t* ids, int32_t n,
                        uint8_t* out, int32_t cap) {
    auto* tok = static_cast<Tokenizer*>(handle);
    std::string result;
    for (int32_t i = 0; i < n; ++i) {
        int32_t id = ids[i];
        if (id < 0 || id >= static_cast<int32_t>(tok->bytes_cache.size()))
            return -1;
        result += tok->expand(id);
    }
    if (static_cast<int32_t>(result.size()) > cap) return -1;
    std::memcpy(out, result.data(), result.size());
    return static_cast<int32_t>(result.size());
}

void gofr_tok_free(void* handle) {
    delete static_cast<Tokenizer*>(handle);
}

}  // extern "C"
