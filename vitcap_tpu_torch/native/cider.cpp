// Native CIDEr-D scorer (corpus-df mode), used for the SCST reward hot path.
//
// Replaces the JVM/external metric tooling the reference shells out to
// (SURVEY.md §2 "Languages": coco-caption/cider are external downloads) with
// an in-repo C++ implementation, exposed to Python via ctypes
// (vitcap_tpu_torch/evals/native_cider.py; built by
// vitcap_tpu_torch/native/__init__.py).  Algorithm identical to the cider
// repo's pyciderevalcap/ciderD/ciderD_scorer.py: 1..4-gram tf-idf vectors
// with idf = log(N) - log(df), per-n cosine similarity with count clipping,
// gaussian length penalty (sigma), mean over n and refs, x10.
//
// Sentences arrive as int32 word-id sequences (the Python wrapper interns
// words); n-grams are hashed to 64-bit keys (offset-FNV over ids), which is
// collision-safe in practice for caption-scale corpora.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int MAX_N = 4;

struct NGramCounts {
    // per n: hash -> count
    std::unordered_map<uint64_t, double> c[MAX_N];
    int length = 0;  // number of unigrams (tokens)
};

static inline uint64_t hash_ngram(const int32_t* w, int n) {
    uint64_t h = 1469598103934665603ull;  // FNV offset basis
    for (int i = 0; i < n; ++i) {
        h ^= static_cast<uint64_t>(static_cast<uint32_t>(w[i])) + 0x9e3779b97f4a7c15ull;
        h *= 1099511628211ull;  // FNV prime
    }
    // mix in n so ("a","b") != trigram prefix collisions across n are moot
    return h * 31 + static_cast<uint64_t>(n);
}

static void count_ngrams(const int32_t* words, int len, NGramCounts& out) {
    out.length = len;
    for (int n = 1; n <= MAX_N; ++n) {
        for (int i = 0; i + n <= len; ++i) {
            out.c[n - 1][hash_ngram(words + i, n)] += 1.0;
        }
    }
}

struct Vec {
    std::unordered_map<uint64_t, double> v[MAX_N];
    double norm[MAX_N] = {0, 0, 0, 0};
    int length = 0;
};

static void counts_to_vec(const NGramCounts& cnts,
                          const std::unordered_map<uint64_t, double>& df,
                          double log_ref_len, Vec& out) {
    out.length = cnts.length;
    for (int n = 0; n < MAX_N; ++n) {
        double norm = 0.0;
        for (const auto& kv : cnts.c[n]) {
            auto it = df.find(kv.first);
            double d = std::log(std::max(1.0, it == df.end() ? 0.0 : it->second));
            double val = kv.second * (log_ref_len - d);
            out.v[n][kv.first] = val;
            norm += val * val;
        }
        out.norm[n] = std::sqrt(norm);
    }
}

static void sim(const Vec& hyp, const Vec& ref, double sigma, double* val) {
    double delta = static_cast<double>(hyp.length - ref.length);
    double pen = std::exp(-(delta * delta) / (2.0 * sigma * sigma));
    for (int n = 0; n < MAX_N; ++n) {
        double s = 0.0;
        for (const auto& kv : hyp.v[n]) {
            auto it = ref.v[n].find(kv.first);
            if (it != ref.v[n].end()) {
                s += std::min(kv.second, it->second) * it->second;
            }
        }
        if (hyp.norm[n] != 0.0 && ref.norm[n] != 0.0) {
            s /= hyp.norm[n] * ref.norm[n];
        }
        val[n] = s * pen;
    }
}

}  // namespace

extern "C" {

// hyps: n_img hypothesis sentences; refs: ragged per image.
// words: flat int32 ids; *_off: offsets (len n+1) into words arrays.
// ref_img_off: offsets (n_img+1) into the refs list.
// scores_out: n_img doubles.
void ciderd_corpus(const int32_t* hyp_words, const int64_t* hyp_off,
                   const int32_t* ref_words, const int64_t* ref_off,
                   const int64_t* ref_img_off, int64_t n_img,
                   double sigma, double* scores_out) {
    int64_t n_refs = ref_img_off[n_img];

    std::vector<NGramCounts> ref_counts(n_refs);
    for (int64_t r = 0; r < n_refs; ++r) {
        count_ngrams(ref_words + ref_off[r],
                     static_cast<int>(ref_off[r + 1] - ref_off[r]),
                     ref_counts[r]);
    }
    std::vector<NGramCounts> hyp_counts(n_img);
    for (int64_t i = 0; i < n_img; ++i) {
        count_ngrams(hyp_words + hyp_off[i],
                     static_cast<int>(hyp_off[i + 1] - hyp_off[i]),
                     hyp_counts[i]);
    }

    // document frequency over ref GROUPS (each image counts an ngram once)
    std::unordered_map<uint64_t, double> df;
    for (int64_t i = 0; i < n_img; ++i) {
        std::unordered_map<uint64_t, char> seen;
        for (int64_t r = ref_img_off[i]; r < ref_img_off[i + 1]; ++r) {
            for (int n = 0; n < MAX_N; ++n) {
                for (const auto& kv : ref_counts[r].c[n]) {
                    seen.emplace(kv.first, 1);
                }
            }
        }
        for (const auto& kv : seen) df[kv.first] += 1.0;
    }
    double log_ref_len = std::log(static_cast<double>(n_img));

    std::vector<Vec> ref_vecs(n_refs);
    for (int64_t r = 0; r < n_refs; ++r) {
        counts_to_vec(ref_counts[r], df, log_ref_len, ref_vecs[r]);
    }

    for (int64_t i = 0; i < n_img; ++i) {
        Vec hv;
        counts_to_vec(hyp_counts[i], df, log_ref_len, hv);
        double acc[MAX_N] = {0, 0, 0, 0};
        int64_t nr = ref_img_off[i + 1] - ref_img_off[i];
        for (int64_t r = ref_img_off[i]; r < ref_img_off[i + 1]; ++r) {
            double val[MAX_N];
            sim(hv, ref_vecs[r], sigma, val);
            for (int n = 0; n < MAX_N; ++n) acc[n] += val[n];
        }
        double score = 0.0;
        for (int n = 0; n < MAX_N; ++n) score += acc[n] / MAX_N;
        scores_out[i] = score / static_cast<double>(nr) * 10.0;
    }
}

}  // extern "C"
