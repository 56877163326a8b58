// text_native — native host-path runtime for the TPU RAG framework.
//
// The device path is JAX/XLA/Pallas; this library owns the host hot loops
// around it: tokenization, hash featurization (the mock/feature encoder's
// host stage), BM25 corpus statistics, and vocabulary term-id lookup.
// Python binds via ctypes (see a_modular_rag_framework_tpu/native).
//
// Tokenization semantics must match the Python reference exactly:
// lowercase, split on any byte outside [a-zA-Z0-9] (the `[^a-zA-Z0-9]+`
// regex); feature hashing uses zlib crc32 over token bytes, with bigrams
// joined by '_' — identical to models/hash_embed.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <zlib.h>

namespace {

inline bool is_alnum(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9');
}

inline char lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c - 'A' + 'a')
                                : static_cast<char>(c);
}

// Tokenize into lowercase alnum runs appended to `out`.
void tokenize(const char* text, std::vector<std::string>& out) {
  if (!text) return;
  std::string cur;
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (is_alnum(c)) {
      cur.push_back(lower(c));
    } else if (!cur.empty()) {
      out.push_back(cur);
      cur.clear();
    }
  }
  if (!cur.empty()) out.push_back(cur);
}

inline uint32_t crc(const std::string& s) {
  return static_cast<uint32_t>(
      crc32(0L, reinterpret_cast<const Bytef*>(s.data()), s.size()));
}

}  // namespace

extern "C" {

// Hash-featurize a batch: unigrams + '_'-joined bigrams, bucket = crc % dim,
// sign = +1/-1 from bit 16 of the crc. buckets/signs are [n, max_features],
// zero-padded. Matches hash_embed.featurize().
void featurize_batch(const char* const* texts, int n, int dim,
                     int max_features, int32_t* buckets, float* signs) {
  std::vector<std::string> toks;
  std::vector<std::string> feats;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    feats.clear();
    tokenize(texts[i], toks);
    feats = toks;
    for (size_t j = 0; j + 1 < toks.size(); ++j) {
      feats.push_back(toks[j] + "_" + toks[j + 1]);
    }
    int32_t* brow = buckets + static_cast<int64_t>(i) * max_features;
    float* srow = signs + static_cast<int64_t>(i) * max_features;
    int m = static_cast<int>(feats.size());
    if (m > max_features) m = max_features;
    for (int j = 0; j < m; ++j) {
      uint32_t h = crc(feats[j]);
      brow[j] = static_cast<int32_t>(h % static_cast<uint32_t>(dim));
      srow[j] = ((h >> 16) & 1u) ? 1.0f : -1.0f;
    }
    for (int j = m; j < max_features; ++j) {
      brow[j] = 0;
      srow[j] = 0.0f;
    }
  }
}

// Fused hash-embed: featurize + signed-bucket accumulate + L2 normalize
// in one pass (out is [n, dim] f32). Equals encode_token_batch(featurize())
// without materializing the [n, max_features] intermediates — the
// index-build embed stage in one C call. Matches hash_embed semantics:
// features are truncated at max_features BEFORE accumulation.
void hash_embed_batch(const char* const* texts, int n, int dim,
                      int max_features, float* out) {
  std::vector<std::string> toks;
  std::string bigram;
  std::vector<float> acc((size_t)dim);
  for (int i = 0; i < n; ++i) {
    toks.clear();
    tokenize(texts[i], toks);
    std::fill(acc.begin(), acc.end(), 0.0f);
    // feature stream = unigrams then '_'-joined bigrams, truncated at
    // max_features BEFORE accumulation (hash_embed._features semantics);
    // hashed straight from toks — no feature-vector materialization
    int budget = max_features;
    int m = static_cast<int>(toks.size());
    int take = m < budget ? m : budget;
    for (int j = 0; j < take; ++j) {
      uint32_t h = crc(toks[j]);
      acc[h % static_cast<uint32_t>(dim)] +=
          ((h >> 16) & 1u) ? 1.0f : -1.0f;
    }
    budget -= take;
    for (int j = 0; j + 1 < m && budget > 0; ++j, --budget) {
      bigram.assign(toks[j]);
      bigram.push_back('_');
      bigram.append(toks[j + 1]);
      uint32_t h = crc(bigram);
      acc[h % static_cast<uint32_t>(dim)] +=
          ((h >> 16) & 1u) ? 1.0f : -1.0f;
    }
    double sq = 0.0;
    for (int d = 0; d < dim; ++d) sq += (double)acc[d] * acc[d];
    float norm = (float)std::sqrt(sq);
    if (norm < 1e-9f) norm = 1e-9f;
    float* row = out + (int64_t)i * dim;
    for (int d = 0; d < dim; ++d) row[d] = acc[d] / norm;
  }
}

// Count tokens per text (doc_lens for BM25).
void token_counts(const char* const* texts, int n, int32_t* counts) {
  std::vector<std::string> toks;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    tokenize(texts[i], toks);
    counts[i] = static_cast<int32_t>(toks.size());
  }
}

// ---- BM25 corpus build (two-phase: size query, then fill) ----
//
// Builds term postings with per-posting precomputed BM25 contributions,
// sorted contribution-descending within each term (the engine's capacity
// window then keeps the strongest docs). The vocabulary is returned as a
// single '\n'-joined byte blob in first-seen term order (term id = line).

struct Bm25Handle {
  std::unordered_map<std::string, int32_t> vocab;  // term -> id
  std::vector<std::string> terms;                  // id -> term
  std::vector<std::vector<std::pair<int32_t, float>>> postings;  // id -> (doc, tf)
  std::vector<float> doc_lens;
  std::string vocab_blob;
  // flattened (filled by bm25_finalize)
  std::vector<int32_t> doc_ids;
  std::vector<float> tfs;
  std::vector<float> scores;
  std::vector<int32_t> row_ptr;
  std::vector<float> df;
};

void* bm25_create() { return new Bm25Handle(); }

void bm25_destroy(void* h) { delete static_cast<Bm25Handle*>(h); }

// Append one document's tokens to the handle: vocab ids assigned in
// token-occurrence order (matches the Python builder's setdefault-per-
// occurrence id assignment), tf accumulation, postings append. Shared by
// the plain and phrase-augmented feeds so the insertion semantics cannot
// drift between them.
void bm25_add_doc_tokens(Bm25Handle* h, const std::vector<std::string>& toks,
                         std::unordered_map<int32_t, float>& tf_by_id,
                         std::vector<int32_t>& seen_order) {
  auto& vm = h->vocab;
  int32_t doc = static_cast<int32_t>(h->doc_lens.size());
  h->doc_lens.push_back(static_cast<float>(toks.size()));
  tf_by_id.clear();
  seen_order.clear();
  for (auto& t : toks) {
    auto it = vm.find(t);
    int32_t tid;
    if (it == vm.end()) {
      tid = static_cast<int32_t>(h->terms.size());
      vm.emplace(t, tid);
      h->terms.push_back(t);
      h->postings.emplace_back();
    } else {
      tid = it->second;
    }
    auto ins = tf_by_id.emplace(tid, 0.0f);
    if (ins.second) seen_order.push_back(tid);
    ins.first->second += 1.0f;
  }
  for (int32_t tid : seen_order) {
    h->postings[tid].emplace_back(doc, tf_by_id[tid]);
  }
}

// Feed a chunk of documents (streaming-friendly).
void bm25_add_docs(void* hptr, const char* const* texts, int n) {
  auto* h = static_cast<Bm25Handle*>(hptr);
  std::vector<std::string> toks;
  std::unordered_map<int32_t, float> tf_by_id;
  std::vector<int32_t> seen_order;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    tokenize(texts[i], toks);
    bm25_add_doc_tokens(h, toks, tf_by_id, seen_order);
  }
}

// Compute contributions + flatten. Returns total postings count.
int64_t bm25_finalize(void* hptr, float k1, float b) {
  auto* h = static_cast<Bm25Handle*>(hptr);
  const int64_t n_docs = static_cast<int64_t>(h->doc_lens.size());
  double sum_len = 0;
  for (float l : h->doc_lens) sum_len += l;
  const double avgdl = n_docs ? (sum_len / n_docs) : 1.0;
  const double avg = avgdl > 0 ? avgdl : 1.0;

  const size_t V = h->terms.size();
  h->row_ptr.assign(V + 1, 0);
  h->df.assign(V, 0.0f);
  int64_t total = 0;
  for (size_t t = 0; t < V; ++t) {
    h->df[t] = static_cast<float>(h->postings[t].size());
    total += static_cast<int64_t>(h->postings[t].size());
    h->row_ptr[t + 1] = static_cast<int32_t>(total);
  }
  h->doc_ids.resize(total);
  h->tfs.resize(total);
  h->scores.resize(total);

  std::vector<std::pair<float, std::pair<int32_t, float>>> scored;
  for (size_t t = 0; t < V; ++t) {
    const double dfv = h->df[t];
    const double idf = std::log((n_docs - dfv + 0.5) / (dfv + 0.5) + 1.0);
    scored.clear();
    scored.reserve(h->postings[t].size());
    for (auto& p : h->postings[t]) {
      const double tf = p.second;
      const double dl = h->doc_lens[p.first];
      double denom = tf + k1 * (1.0 - b + b * dl / avg);
      if (denom == 0) denom = 1.0;
      const float c = static_cast<float>(idf * tf * (k1 + 1.0) / denom);
      scored.emplace_back(c, p);
    }
    std::sort(scored.begin(), scored.end(), [](const auto& a, const auto& b2) {
      if (a.first != b2.first) return a.first > b2.first;
      return a.second.first < b2.second.first;  // doc-ascending tiebreak
    });
    int64_t base = h->row_ptr[t];
    for (size_t j = 0; j < scored.size(); ++j) {
      h->doc_ids[base + j] = scored[j].second.first;
      h->tfs[base + j] = scored[j].second.second;
      h->scores[base + j] = scored[j].first;
    }
  }

  h->vocab_blob.clear();
  for (size_t t = 0; t < V; ++t) {
    h->vocab_blob += h->terms[t];
    h->vocab_blob += '\n';
  }
  return total;
}

int64_t bm25_vocab_size(void* hptr) {
  return static_cast<int64_t>(static_cast<Bm25Handle*>(hptr)->terms.size());
}

int64_t bm25_vocab_blob_size(void* hptr) {
  return static_cast<int64_t>(static_cast<Bm25Handle*>(hptr)->vocab_blob.size());
}

int64_t bm25_n_docs(void* hptr) {
  return static_cast<int64_t>(static_cast<Bm25Handle*>(hptr)->doc_lens.size());
}

// Copy the flattened arrays out (buffers allocated by the caller).
void bm25_export(void* hptr, int32_t* doc_ids, float* tfs, float* scores,
                 int32_t* row_ptr, float* df, float* doc_lens,
                 char* vocab_blob) {
  auto* h = static_cast<Bm25Handle*>(hptr);
  std::memcpy(doc_ids, h->doc_ids.data(), h->doc_ids.size() * sizeof(int32_t));
  std::memcpy(tfs, h->tfs.data(), h->tfs.size() * sizeof(float));
  std::memcpy(scores, h->scores.data(), h->scores.size() * sizeof(float));
  std::memcpy(row_ptr, h->row_ptr.data(), h->row_ptr.size() * sizeof(int32_t));
  std::memcpy(df, h->df.data(), h->df.size() * sizeof(float));
  std::memcpy(doc_lens, h->doc_lens.data(), h->doc_lens.size() * sizeof(float));
  std::memcpy(vocab_blob, h->vocab_blob.data(), h->vocab_blob.size());
}

// ---- vocabulary lookup (query encoding hot path) ----

struct VocabHandle {
  std::unordered_map<std::string, int32_t> map;
};

void* vocab_create(const char* blob, int64_t size) {
  auto* h = new VocabHandle();
  int32_t id = 0;
  const char* p = blob;
  const char* end = blob + size;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) nl = end;
    h->map.emplace(std::string(p, nl - p), id++);
    p = nl + 1;
  }
  return h;
}

void vocab_destroy(void* h) { delete static_cast<VocabHandle*>(h); }

// Tokenize each text and emit its term ids (occurrence order, -1 padded to
// max_terms; unknown terms skipped — query-encoding semantics).
void vocab_lookup_batch(void* hptr, const char* const* texts, int n,
                        int max_terms, int32_t* out_ids) {
  auto* h = static_cast<VocabHandle*>(hptr);
  std::vector<std::string> toks;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    tokenize(texts[i], toks);
    int32_t* row = out_ids + static_cast<int64_t>(i) * max_terms;
    int filled = 0;
    for (auto& t : toks) {
      if (filled >= max_terms) break;
      auto it = h->map.find(t);
      if (it != h->map.end()) row[filled++] = it->second;
    }
    for (int j = filled; j < max_terms; ++j) row[j] = -1;
  }
}

}  // extern "C"

// ---- iterative-mode bridge extraction (hop-2 query prep) ----
//
// Mirrors modules/retrieval/multihop.py exactly for "simple" texts —
// pure-ASCII without apostrophes or hyphens, where the Python
// capitalized-run fast path applies (utils/textspan.py). Queries touching
// any non-simple text are flagged for the Python fallback instead of
// being approximated: byte-level isupper/islower cannot reproduce
// Python's Unicode tables, and a quote char is a token BREAK before a
// word but a JOINER inside one.
//
// Not thread-safe: one handle is driven by the single prep thread of the
// pipelined iterative loop.

namespace {

inline bool is_alpha(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

bool simple_text(const char* s) {
  for (const unsigned char* p = (const unsigned char*)s; *p; ++p) {
    if (*p >= 0x80 || *p == '\'' || *p == '-') return false;
  }
  return true;
}

// Maximal runs of adjacent capitalized words (textspan._runs_general
// restricted to simple texts): words = maximal [A-Za-z]+ runs; cap word =
// upper initial, len >= 2, at least one lowercase; single-uppercase
// initials ride along ("John D. Rockefeller") over " " or ". " gaps; any
// other token or gap breaks the run. min_words = 1.
void capitalized_runs_ascii_c(const char* s, int n,
                              std::vector<std::string>& out) {
  int run_start = -1, run_end = -1;
  int caps_in_run = 0;
  bool prev_initial = false;
  int prev_end = -1;
  auto flush = [&]() {
    if (caps_in_run >= 1 && run_start >= 0)
      out.emplace_back(s + run_start, s + run_end);
    run_start = run_end = -1;
    caps_in_run = 0;
    prev_initial = false;
  };
  int i = 0;
  while (i < n) {
    if (!is_alpha((unsigned char)s[i])) { ++i; continue; }
    int start = i;
    bool has_lower = false;
    while (i < n && is_alpha((unsigned char)s[i])) {
      if (s[i] >= 'a' && s[i] <= 'z') has_lower = true;
      ++i;
    }
    int end = i;
    int len = end - start;
    bool adjacent = run_start >= 0 && prev_end >= 0 &&
        ((start - prev_end == 1 && s[prev_end] == ' ') ||
         (prev_initial && start - prev_end == 2 && s[prev_end] == '.' &&
          s[prev_end + 1] == ' '));
    bool cap_word = len >= 2 && s[start] >= 'A' && s[start] <= 'Z' &&
                    has_lower;
    bool is_initial = len == 1 && s[start] >= 'A' && s[start] <= 'Z';
    if (cap_word) {
      if (!adjacent) { flush(); run_start = start; caps_in_run = 0; }
      run_end = end;
      ++caps_in_run;
      prev_initial = false;
    } else if (adjacent && is_initial) {
      prev_initial = true;
    } else {
      flush();
    }
    prev_end = end;
  }
  flush();
}

inline void capitalized_runs_ascii(const std::string& text,
                                   std::vector<std::string>& out) {
  capitalized_runs_ascii_c(text.c_str(), (int)text.size(), out);
}

struct BridgeRun {
  std::string text;                 // the run, raw capitalization
  std::vector<std::string> tokens;  // sorted unique lowercase tokens
};

struct BridgeDoc {
  std::string text;
  std::string title;  // the doc's own title: anchor fallback for natural
                      // discourse where later sentences drop their subject
  bool simple = true;
  bool runs_ready = false;
  std::vector<BridgeRun> runs;
};

struct BridgeHandle {
  std::unordered_set<std::string> qwords;
  std::unordered_set<std::string> titles;
  std::vector<BridgeDoc> docs;
  // guards the lazy doc-run materialization: concurrent hop2_batch calls
  // (two engines sharing one index, or server + batch loops) must not
  // observe a half-filled BridgeDoc.runs
  std::mutex runs_mu;
};

// lowercase tokens of a simple text, sorted + deduped
void token_set(const std::string& text, std::vector<std::string>& out) {
  out.clear();
  std::vector<std::string> toks;
  tokenize(text.c_str(), toks);
  std::sort(toks.begin(), toks.end());
  toks.erase(std::unique(toks.begin(), toks.end()), toks.end());
  out = std::move(toks);
}

void ensure_doc_runs(BridgeHandle* h, BridgeDoc& d) {
  if (d.runs_ready) return;
  d.runs_ready = true;
  std::vector<std::string> runs;
  capitalized_runs_ascii(d.text, runs);
  for (auto& e : runs) {
    if (h->qwords.count(e)) continue;
    if (!h->titles.count(e)) continue;
    BridgeRun r;
    token_set(e, r.tokens);
    r.text = std::move(e);
    d.runs.push_back(std::move(r));
  }
}

inline bool subset_of(const std::vector<std::string>& sorted_unique,
                      const std::unordered_set<std::string>& super) {
  for (auto& t : sorted_unique)
    if (!super.count(t)) return false;
  return true;
}

}  // namespace

extern "C" {

void* bridge_create(const char* qwords_blob, int64_t blob_len) {
  auto* h = new BridgeHandle();
  const char* p = qwords_blob;
  const char* end = qwords_blob + blob_len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    if (nl > p) h->qwords.emplace(p, nl - p);
    p = nl + 1;
  }
  return h;
}

void bridge_destroy(void* h) { delete static_cast<BridgeHandle*>(h); }

// Register corpus rows in order (row id = arrival order). Raw text and
// titles — capitalization is the signal here, unlike the lowercased BM25
// feeds. Runs are extracted lazily on first inspection so registration
// stays O(bytes) even at fullwiki scale.
void bridge_add_docs(void* hptr, const char* const* texts,
                     const char* const* titles, int n) {
  auto* h = static_cast<BridgeHandle*>(hptr);
  h->docs.reserve(h->docs.size() + n);
  for (int i = 0; i < n; ++i) {
    BridgeDoc d;
    d.text = texts[i] ? texts[i] : "";
    d.title = (titles && titles[i]) ? titles[i] : "";
    // a non-simple title would make the byte-level anchor test below
    // diverge from Python's Unicode semantics — punt the row to Python
    d.simple = simple_text(d.text.c_str()) && simple_text(d.title.c_str());
    if (!d.title.empty()) h->titles.emplace(d.title);
    h->docs.push_back(std::move(d));
  }
}

// Hop-2 query construction for a batch. ids is [B, K] row ids (-1 pad).
// out is a [B, stride] char buffer receiving '\n'-joined hop-2 variants
// per query ("" = no bridges / inactive). status[b]: 0 = ok, 1 = needs
// the Python fallback (non-simple query or inspected doc, id out of
// range, or output exceeded stride).
//
// When high_df_blob is non-empty ('\n'-joined lowercase terms), each
// emitted variant is already PRUNED exactly like the engine's
// prune_query (query_engine.py): tokens not in the high-df set, in
// tokenize order, then the "00"-joined phrase pseudo-token of the
// (multi-word) bridge name when it too survives the set; if everything
// would drop, the raw variant is emitted. The caller then dispatches
// with prepruned=True, taking the per-batch re-prune off the host
// critical path of the iterative mode.
void bridge_hop2_batch(void* hptr, const char* const* queries, int B,
                       const int32_t* ids, int K, int max_entities,
                       int max_variants, char* out, int stride,
                       int8_t* status,
                       const char* high_df_blob, int64_t high_df_len) {
  auto* h = static_cast<BridgeHandle*>(hptr);
  std::unordered_set<std::string> high_df;
  if (high_df_blob && high_df_len > 0) {
    const char* p = high_df_blob;
    const char* end = high_df_blob + high_df_len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) nl = end;
      if (nl > p) high_df.emplace(p, nl - p);
      p = nl + 1;
    }
  }
  const bool prune = !high_df.empty();

  // Pre-materialize the lazily-extracted doc runs for every inspected row
  // (single-threaded: each doc is touched once, and the per-doc cache is
  // warm across batches anyway). The per-query scan below then reads the
  // corpus strictly read-only, so it parallelizes over queries.
  {
    std::lock_guard<std::mutex> lock(h->runs_mu);
    std::unordered_set<int32_t> uniq;
    const int64_t nd = (int64_t)h->docs.size();
    for (int64_t i = 0; i < (int64_t)B * K; ++i) {
      int32_t id = ids[i];
      if (id >= 0 && id < nd && !h->docs[id].runs_ready) uniq.insert(id);
    }
    for (int32_t id : uniq) ensure_doc_runs(h, h->docs[id]);
  }

  // Per-query scan: independent rows writing disjoint out/status slots
  // over a read-only corpus — each worker thread owns its scratch and
  // walks queries with stride T.
  auto worker = [&](int t0, int T) {
    std::vector<std::string> q_ents;
    std::vector<std::string> raw_runs, toks, btoks, kept_pred;
    std::unordered_set<std::string> q_tokens, ent_tokens;
    struct Cand { int count; int first; int order; const std::string* text; };
    std::unordered_map<std::string, Cand> counts;
    std::vector<const std::string*> cand_order;

  for (int b = t0; b < B; b += T) {
    char* row = out + (int64_t)b * stride;
    row[0] = '\0';
    status[b] = 0;
    const char* q = queries[b] ? queries[b] : "";
    if (!simple_text(q)) { status[b] = 1; continue; }

    // ---- per-query derivations ----
    std::string qs(q);
    raw_runs.clear();
    capitalized_runs_ascii(qs, raw_runs);
    q_ents.clear();
    for (auto& e : raw_runs)
      if (!h->qwords.count(e)) q_ents.push_back(e);
    toks.clear();
    tokenize(q, toks);
    q_tokens.clear();
    q_tokens.insert(toks.begin(), toks.end());

    // ---- candidate scan over inspected docs ----
    counts.clear();
    cand_order.clear();
    int rank = 0;
    bool fallback = false;
    for (int k = 0; k < K; ++k) {
      int32_t id = ids[(int64_t)b * K + k];
      if (id < 0) continue;
      if (id >= (int64_t)h->docs.size()) { fallback = true; break; }
      const BridgeDoc& d = h->docs[id];
      if (!d.simple) { fallback = true; break; }
      // runs were pre-materialized above; this loop is read-only
      int my_rank = rank++;
      if (!q_ents.empty()) {
        // anchored = the sentence names a question entity, or its own
        // document title overlaps one (bridge_entities' hit_titles
        // clause: natural discourse drops the subject after sentence 1)
        bool mentioned = false;
        for (auto& qe : q_ents)
          if (d.text.find(qe) != std::string::npos) { mentioned = true; break; }
        if (!mentioned && !d.title.empty()) {
          for (auto& qe : q_ents)
            if (d.title.find(qe) != std::string::npos ||
                qe.find(d.title) != std::string::npos) {
              mentioned = true; break;
            }
        }
        if (!mentioned) continue;
      }
      for (auto& r : d.runs) {
        bool is_q_ent = false, sub = false;
        for (auto& qe : q_ents) {
          if (r.text == qe) { is_q_ent = true; break; }
          if (r.text.find(qe) != std::string::npos ||
              qe.find(r.text) != std::string::npos) { sub = true; break; }
        }
        if (is_q_ent || sub) continue;
        if (subset_of(r.tokens, q_tokens)) continue;
        auto it = counts.find(r.text);
        if (it == counts.end()) {
          auto& c = counts[r.text];
          c.count = 1; c.first = my_rank;
          c.order = (int)cand_order.size(); c.text = &r.text;
          cand_order.push_back(&r.text);
        } else {
          it->second.count += 1;
        }
      }
    }
    if (fallback) { status[b] = 1; continue; }
    if (cand_order.empty()) continue;  // inactive, empty output

    // rank by (-count, first_seen), stable in insertion order — matches
    // Python's sorted() over dict-insertion-ordered keys
    std::vector<int> order((size_t)cand_order.size());
    for (size_t i2 = 0; i2 < order.size(); ++i2) order[i2] = (int)i2;
    std::stable_sort(order.begin(), order.end(), [&](int a2, int b2) {
      const Cand& ca = counts.at(*cand_order[a2]);
      const Cand& cb = counts.at(*cand_order[b2]);
      if (ca.count != cb.count) return ca.count > cb.count;
      return ca.first < cb.first;
    });
    int n_bridges = std::min<int>(max_entities, (int)order.size());

    // ---- hop-2 query construction (hop2_queries_for) ----
    std::string joined;
    for (auto& e : q_ents) {
      if (!joined.empty()) joined += ' ';
      joined += e;
    }
    toks.clear();
    tokenize(joined.c_str(), toks);
    ent_tokens.clear();
    ent_tokens.insert(toks.begin(), toks.end());
    toks.clear();
    tokenize(q, toks);
    std::string pred;
    kept_pred.clear();
    for (auto& t : toks) {
      if (t.size() > 2 && !ent_tokens.count(t)) {
        if (!pred.empty()) pred += ' ';
        pred += t;
        if (prune && !high_df.count(t)) kept_pred.push_back(t);
      }
    }
    std::string result;
    int n_out = std::min<int>(n_bridges, max_variants);
    for (int v = 0; v < n_out; ++v) {
      const std::string& bname = *cand_order[order[v]];
      std::string variant = bname;
      if (!pred.empty()) { variant += ' '; variant += pred; }
      if (prune) {
        // prune_query(variant): tokenize(variant) = tokenize(bname) ++
        // pred tokens (pred tokens are tokenize() output, so the re-split
        // is exact); the only capitalized run in the variant is the
        // bridge name itself (preds are lowercase), so the phrase
        // pseudo-token is derived from bname directly.
        btoks.clear();
        tokenize(bname.c_str(), btoks);
        std::string pv;
        for (auto& t : btoks) {
          if (high_df.count(t)) continue;
          if (!pv.empty()) pv += ' ';
          pv += t;
        }
        for (auto& t : kept_pred) {
          if (!pv.empty()) pv += ' ';
          pv += t;
        }
        if (bname.find(' ') != std::string::npos) {
          std::string phrase;
          for (size_t ti = 0; ti < btoks.size(); ++ti) {
            if (ti) phrase += "00";
            phrase += btoks[ti];
          }
          if (!high_df.count(phrase)) {
            if (!pv.empty()) pv += ' ';
            pv += phrase;
          }
        }
        if (!pv.empty()) variant = std::move(pv);
      }
      if (v) result += '\n';
      result += variant;
    }
    if ((int)result.size() + 1 > stride) { status[b] = 1; continue; }
    memcpy(row, result.c_str(), result.size() + 1);
  }
  };  // worker

  int T = (int)std::thread::hardware_concurrency() / 2;
  if (T > 8) T = 8;
  if (T < 1 || B < 256) T = 1;  // small batches: thread spawn > scan cost
  if (T == 1) {
    worker(0, 1);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(T - 1);
    for (int t = 1; t < T; ++t) threads.emplace_back(worker, t, T);
    worker(0, T);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---- index-build host stages: phrase-augmented BM25 feed + entity graph ----
//
// Both stages mirror the Python builder exactly for "simple" texts
// (pure-ASCII, no apostrophe/hyphen — the same gate as the bridge stage
// above); rows failing the gate take per-row Python-prepared inputs so
// Unicode semantics stay with Python's str tables.

namespace {

// Append phrase pseudo-tokens for multi-word capitalized runs to `toks`
// (models/hash_embed.py phrase_augment: "00".join(tokenize(run)) per run
// containing a space; tokenize(text + " " + extras) == tokenize(text) +
// extras because each extra is one alnum token).
void append_phrase_tokens(const char* text,
                          std::vector<std::string>& toks) {
  std::vector<std::string> runs;
  capitalized_runs_ascii_c(text, (int)strlen(text), runs);
  std::vector<std::string> rt;
  for (auto& r : runs) {
    if (r.find(' ') == std::string::npos) continue;
    rt.clear();
    tokenize(r.c_str(), rt);
    std::string joined;
    for (auto& t : rt) {
      if (!joined.empty()) joined += "00";
      joined += t;
    }
    if (!joined.empty()) toks.push_back(std::move(joined));
  }
}

}  // namespace

extern "C" {

// Mark rows needing the Python path (non-simple text). status[i]: 0 | 1.
void simple_scan(const char* const* texts, int n, int8_t* status) {
  for (int i = 0; i < n; ++i)
    status[i] = simple_text(texts[i] ? texts[i] : "") ? 0 : 1;
}

// bm25_add_docs with in-loop phrase augmentation. Rows with use_repl[i]=1
// tokenize repl[i] (the Python-side phrase_augment output) verbatim.
void bm25_add_docs_phrase(void* hptr, const char* const* texts, int n,
                          const int8_t* use_repl,
                          const char* const* repl) {
  auto* h = static_cast<Bm25Handle*>(hptr);
  std::vector<std::string> toks;
  std::unordered_map<int32_t, float> tf_by_id;
  std::vector<int32_t> seen_order;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    if (use_repl && use_repl[i]) {
      tokenize(repl[i], toks);
    } else {
      const char* t = texts[i] ? texts[i] : "";
      tokenize(t, toks);
      append_phrase_tokens(t, toks);
    }
    bm25_add_doc_tokens(h, toks, tf_by_id, seen_order);
  }
}

// Entity-link adjacency (index/builder.py build_sentence_graph's entity
// table): per row, first-appearance-deduped capitalized runs; per entity
// (first-appearance order, rows capped at chain_cap): hub star + a
// consecutive chain, inserted through the same capped dedup add() as the
// Python builder. Rows with use_repl[i]=1 read their entities from
// repl[i] ('\n'-joined, possibly empty) instead of extracting.
// out_nbrs is [n * max_degree] int32, caller-filled with -1.
void entity_graph_build(const char* const* texts, int n,
                        const int8_t* use_repl, const char* const* repl,
                        int max_degree, int chain_cap, int32_t* out_nbrs) {
  std::vector<int32_t> counts((size_t)n, 0);
  std::unordered_map<std::string, int32_t> ent_idx;
  std::vector<std::vector<int32_t>> ent_rows;
  std::vector<std::string> runs;
  std::vector<std::string> ents;

  for (int row = 0; row < n; ++row) {
    runs.clear();
    ents.clear();
    if (use_repl && use_repl[row]) {
      const char* p = repl[row] ? repl[row] : "";
      std::string cur;
      for (; *p; ++p) {
        if (*p == '\n') { if (!cur.empty()) runs.push_back(cur); cur.clear(); }
        else cur.push_back(*p);
      }
      if (!cur.empty()) runs.push_back(cur);
    } else {
      const char* t = texts[row] ? texts[row] : "";
      capitalized_runs_ascii_c(t, (int)strlen(t), runs);
    }
    // ordered dedup (few entities per sentence: linear scan)
    for (auto& e : runs) {
      bool dup = false;
      for (auto& seen : ents)
        if (seen == e) { dup = true; break; }
      if (!dup) ents.push_back(e);
    }
    for (auto& e : ents) {
      auto it = ent_idx.find(e);
      int32_t idx;
      if (it == ent_idx.end()) {
        idx = static_cast<int32_t>(ent_rows.size());
        ent_idx.emplace(e, idx);
        ent_rows.emplace_back();
      } else {
        idx = it->second;
      }
      if ((int)ent_rows[idx].size() < chain_cap)
        ent_rows[idx].push_back(row);
    }
  }

  auto add = [&](int32_t a, int32_t b) {
    if (a == b) return;
    int32_t* ra = out_nbrs + (int64_t)a * max_degree;
    if (counts[a] < max_degree) {
      bool dup = false;
      for (int32_t j = 0; j < counts[a]; ++j)
        if (ra[j] == b) { dup = true; break; }
      if (!dup) ra[counts[a]++] = b;
    }
    int32_t* rb = out_nbrs + (int64_t)b * max_degree;
    if (counts[b] < max_degree) {
      bool dup = false;
      for (int32_t j = 0; j < counts[b]; ++j)
        if (rb[j] == a) { dup = true; break; }
      if (!dup) rb[counts[b]++] = a;
    }
  };

  for (auto& rows : ent_rows) {
    if (rows.empty()) continue;
    int32_t hub = rows[0];
    for (size_t i = 1; i < rows.size(); ++i) add(hub, rows[i]);
    for (size_t i = 0; i + 1 < rows.size(); ++i) add(rows[i], rows[i + 1]);
  }
}

// TextEncoder subword featurization (models/encoder.py encode_tokens):
// per word, feature 0 = crc32(word) % vocab, then char n-grams of the
// '<word>'-wrapped form (lengths ngram_min..ngram_max, left-to-right) until
// `ngrams` features; the row fills by cyclic repetition of the collected
// features. ids is [n, max_len, ngrams] int32 (row-major), mask [n, max_len]
// f32; both must arrive zeroed (only token positions are written). Texts
// must be pre-lowercased (binding._text_array) — tokens are pure-ASCII
// alnum runs, so byte == char and n-gram slicing matches Python exactly.
void encoder_tokens(const char* const* texts, int n, int max_len, int vocab,
                    int ngrams, int ngram_min, int ngram_max, int32_t* ids,
                    float* mask) {
  if (ngrams < 1) ngrams = 1;
  const uint32_t uv = static_cast<uint32_t>(vocab);
  std::vector<std::string> toks;
  std::vector<int32_t> feats;
  std::string wrapped;
  for (int i = 0; i < n; ++i) {
    toks.clear();
    tokenize(texts[i], toks);
    int m = static_cast<int>(toks.size());
    if (m > max_len) m = max_len;
    int32_t* trow = ids + (int64_t)i * max_len * ngrams;
    float* mrow = mask + (int64_t)i * max_len;
    for (int j = 0; j < m; ++j) {
      const std::string& tok = toks[j];
      feats.clear();
      feats.push_back(static_cast<int32_t>(crc(tok) % uv));
      if (ngrams > 1) {
        wrapped.clear();
        wrapped.push_back('<');
        wrapped.append(tok);
        wrapped.push_back('>');
        int wl = static_cast<int>(wrapped.size());
        for (int g = ngram_min;
             g <= ngram_max && (int)feats.size() < ngrams; ++g) {
          for (int a = 0; a + g <= wl && (int)feats.size() < ngrams; ++a) {
            uint32_t h = static_cast<uint32_t>(
                crc32(0L, reinterpret_cast<const Bytef*>(wrapped.data() + a),
                      g));
            feats.push_back(static_cast<int32_t>(h % uv));
          }
        }
      }
      int32_t* frow = trow + (int64_t)j * ngrams;
      int fs = static_cast<int>(feats.size());
      for (int g = 0; g < ngrams; ++g) frow[g] = feats[g % fs];
      mrow[j] = 1.0f;
    }
  }
}

}  // extern "C"
