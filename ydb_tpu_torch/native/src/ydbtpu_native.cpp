// Native host runtime kernels (C ABI, loaded via ctypes).
//
// The reference implements its host hot paths in C++: the vectorized
// block hash partitioner (dq_output_consumer.cpp:338,500), the K-way
// PK merge of sorted portion streams (plain_reader/iterator/merge.cpp,
// NArrow::NMerger) and bloom filters on local-DB parts
// (tablet_flat flat_part_*). The port's own copy of the JAX package's
// host library: the CUDA device never sees these functions. They run on
// the host between device programs, as plain C++ with a stable C ABI,
// and each has a numpy twin in ydb_tpu_torch/native/__init__.py that
// gives the same bits, so routing and merges agree between processes
// with and without the toolchain, and with the JAX package's library.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (ydb_tpu_torch/native/build.py).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---- row hashing (splitmix64 mix, identical to the numpy twin) ----

void ydbtpu_hash_rows(const int64_t **keys, const uint8_t **valids,
                      int32_t nkeys, int64_t nrows, uint64_t *out) {
    for (int64_t i = 0; i < nrows; ++i)
        out[i] = 0x9E3779B97F4A7C15ULL;
    for (int32_t k = 0; k < nkeys; ++k) {
        const int64_t *kv = keys[k];
        const uint8_t *ok = valids[k];
        for (int64_t i = 0; i < nrows; ++i) {
            uint64_t v = (uint64_t)kv[i] ^ ((uint64_t)(ok[i] != 0) << 63);
            uint64_t x = out[i] ^ v;
            x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
            x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
            out[i] = x ^ (x >> 31);
        }
    }
}

// ---- K-way merge of sorted runs ----
//
// Emits (run_index, row_index) pairs in globally sorted key order.
// Stable across runs: equal keys emit in run order (run 0 first), so
// with runs ordered oldest -> newest, "keep the LAST duplicate" is
// newest-wins MVCC dedup. Returns the output length (== total rows, or
// fewer when dedup=1).
int64_t ydbtpu_kway_merge(const int64_t **runs, const int64_t *lens,
                          int32_t nruns, int32_t dedup,
                          int32_t *out_run, int64_t *out_idx) {
    struct Head {
        int64_t key;
        int32_t run;
        int64_t idx;
    };
    struct Cmp {
        bool operator()(const Head &a, const Head &b) const {
            if (a.key != b.key) return a.key > b.key;
            return a.run > b.run;  // stable: lower run first
        }
    };
    std::priority_queue<Head, std::vector<Head>, Cmp> heap;
    for (int32_t r = 0; r < nruns; ++r)
        if (lens[r] > 0) heap.push({runs[r][0], r, 0});
    int64_t n_out = 0;
    bool have_prev = false;
    int64_t prev_key = 0;
    while (!heap.empty()) {
        Head h = heap.top();
        heap.pop();
        if (dedup && have_prev && h.key == prev_key) {
            // newer duplicate replaces the previously emitted row
            out_run[n_out - 1] = h.run;
            out_idx[n_out - 1] = h.idx;
        } else {
            out_run[n_out] = h.run;
            out_idx[n_out] = h.idx;
            ++n_out;
            prev_key = h.key;
            have_prev = true;
        }
        if (h.idx + 1 < lens[h.run])
            heap.push({runs[h.run][h.idx + 1], h.run, h.idx + 1});
    }
    return n_out;
}

// ---- bloom filter over u64 hashes (k probes via double hashing) ----

static inline uint64_t mix64(uint64_t x) {
    x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
    x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
    return x ^ (x >> 33);
}

void ydbtpu_bloom_build(const uint64_t *hashes, int64_t n, uint8_t *bits,
                        int64_t nbits, int32_t nprobes) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h1 = hashes[i], h2 = mix64(hashes[i]) | 1ULL;
        for (int32_t p = 0; p < nprobes; ++p) {
            uint64_t bit = (h1 + (uint64_t)p * h2) % (uint64_t)nbits;
            bits[bit >> 3] |= (uint8_t)(1u << (bit & 7));
        }
    }
}

void ydbtpu_bloom_query(const uint64_t *hashes, int64_t n,
                        const uint8_t *bits, int64_t nbits,
                        int32_t nprobes, uint8_t *out) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h1 = hashes[i], h2 = mix64(hashes[i]) | 1ULL;
        uint8_t hit = 1;
        for (int32_t p = 0; p < nprobes && hit; ++p) {
            uint64_t bit = (h1 + (uint64_t)p * h2) % (uint64_t)nbits;
            hit = (bits[bit >> 3] >> (bit & 7)) & 1u;
        }
        out[i] = hit;
    }
}

// ---- gather: out[i] = src[idx[i]] (merge materialization core) ----

void ydbtpu_gather_i64(const int64_t *src, const int64_t *idx, int64_t n,
                       int64_t *out) {
    for (int64_t i = 0; i < n; ++i) out[i] = src[idx[i]];
}

}  // extern "C"
