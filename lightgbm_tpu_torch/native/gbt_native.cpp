// Native host runtime of lightgbm_tpu_torch.
//
// The reference keeps its data layer and serving path in C++ (src/io/parser.hpp,
// src/io/bin.cpp, src/application/predictor.hpp); this library is the
// port's host side of the same: text parsing (CSV/TSV/LibSVM with format
// sniffing), value->bin quantization, and model-file prediction, all
// OpenMP-parallel, exported through a C ABI consumed via ctypes
// (lightgbm_tpu_torch/native/__init__.py).  Training and the predict
// kernels run on the card through PyTorch; this is the host side.
//
// Semantics mirrored from the reference (file:line cites):
//   format sniffing            src/io/parser.cpp:72+
//   ValueToBin binary search   include/LightGBM/bin.h:451-483
//   decision_type bit layout   include/LightGBM/tree.h:157-176
//   Numerical/CategoricalDecision  include/LightGBM/tree.h:231-313
//   model text format          src/io/tree.cpp:192-227, src/boosting/gbdt.cpp:948+

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kZeroRange = 1e-35;   // reference kZeroThreshold
constexpr int kMissingNone = 0;
constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;
constexpr int kCategoricalMask = 1;    // decision_type bit 0
constexpr int kDefaultLeftMask = 2;    // decision_type bit 1

// ----------------------------------------------------------------- parsing

inline bool is_na_token(const std::string& t) {
  return t.empty() || t == "na" || t == "nan" || t == "NA" || t == "NaN" ||
         t == "null" || t == "NULL" || t == "N/A";
}

inline double parse_cell(const char* s, const char* e) {
  while (s < e && std::isspace(static_cast<unsigned char>(*s))) ++s;
  while (e > s && std::isspace(static_cast<unsigned char>(*(e - 1)))) --e;
  if (s == e) return std::nan("");
  std::string tok(s, e);
  if (is_na_token(tok)) return std::nan("");
  char* endp = nullptr;
  double v = std::strtod(tok.c_str(), &endp);
  if (endp == tok.c_str()) return std::nan("");
  return v;
}

struct ParseResult {
  int64_t rows = 0;
  int64_t cols = 0;              // feature columns (label removed)
  std::vector<double> features;  // row-major [rows, cols]
  std::vector<float> labels;
  std::string error;
};

// Sniff format from sample lines: libsvm if any "i:v" token appears past the
// first, else tab-, comma- or space-separated (parser.cpp:72+ discipline).
enum class Format { kCSV, kTSV, kLibSVM, kSpace };

Format sniff_format(const std::vector<std::string>& lines) {
  for (const auto& line : lines) {
    if (line.empty()) continue;
    std::istringstream iss(line);
    std::string tok;
    int i = 0;
    bool has_colon = false;
    while (iss >> tok) {
      if (i > 0 && tok.find(':') != std::string::npos) has_colon = true;
      ++i;
    }
    if (has_colon) return Format::kLibSVM;
    if (line.find('\t') != std::string::npos) return Format::kTSV;
    if (line.find(',') != std::string::npos) return Format::kCSV;
    if (i > 1) return Format::kSpace;
  }
  return Format::kCSV;
}

void parse_delim_lines(const std::vector<std::string>& lines, char delim,
                       bool any_space, int label_idx, ParseResult* out) {
  int64_t n = static_cast<int64_t>(lines.size());
  // column count from the first non-empty line
  int64_t ncol = 0;
  for (const auto& line : lines) {
    if (line.empty()) continue;
    if (any_space) {
      std::istringstream iss(line);
      std::string t;
      while (iss >> t) ++ncol;
    } else {
      ncol = 1 + std::count(line.begin(), line.end(), delim);
    }
    break;
  }
  if (ncol == 0) { out->error = "empty data"; return; }
  bool has_label = label_idx >= 0 && label_idx < ncol;
  int64_t fcols = ncol - (has_label ? 1 : 0);
  out->rows = n;
  out->cols = fcols;
  // short/ragged rows leave their trailing cells as NaN (missing), matching
  // the python loader's missing-value convention
  out->features.assign(n * fcols, std::nan(""));
  out->labels.assign(n, 0.0f);

#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const std::string& line = lines[r];
    int64_t col = 0, fcol = 0;
    if (any_space) {
      std::istringstream iss(line);
      std::string t;
      while (iss >> t && col < ncol) {
        double v = parse_cell(t.data(), t.data() + t.size());
        if (has_label && col == label_idx) out->labels[r] = (float)v;
        else if (fcol < fcols) out->features[r * fcols + fcol++] = v;
        ++col;
      }
    } else {
      const char* s = line.c_str();
      const char* end = s + line.size();
      while (col < ncol) {
        const char* e = static_cast<const char*>(memchr(s, delim, end - s));
        if (e == nullptr) e = end;
        double v = parse_cell(s, e);
        if (has_label && col == label_idx) out->labels[r] = (float)v;
        else if (fcol < fcols) out->features[r * fcols + fcol++] = v;
        ++col;
        if (e == end) break;
        s = e + 1;
      }
    }
  }
}

void parse_libsvm_lines(const std::vector<std::string>& lines, int label_idx,
                        ParseResult* out) {
  int64_t n = static_cast<int64_t>(lines.size());
  std::vector<std::vector<std::pair<int, double>>> rows(n);
  std::vector<float> labels(n, 0.0f);
  int max_idx = -1;
#pragma omp parallel
  {
    int local_max = -1;
#pragma omp for schedule(static)
    for (int64_t r = 0; r < n; ++r) {
      std::istringstream iss(lines[r]);
      std::string tok;
      bool first = true;
      while (iss >> tok) {
        auto colon = tok.find(':');
        if (first && label_idx >= 0 && colon == std::string::npos) {
          labels[r] = (float)std::strtod(tok.c_str(), nullptr);
          first = false;
          continue;
        }
        first = false;
        if (colon == std::string::npos) continue;
        int idx = std::atoi(tok.substr(0, colon).c_str());
        double v = std::strtod(tok.c_str() + colon + 1, nullptr);
        rows[r].emplace_back(idx, v);
        local_max = std::max(local_max, idx);
      }
    }
#pragma omp critical
    max_idx = std::max(max_idx, local_max);
  }
  int64_t fcols = max_idx + 1;
  out->rows = n;
  out->cols = fcols;
  out->features.assign(n * fcols, 0.0);
  out->labels = std::move(labels);
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r)
    for (auto& iv : rows[r]) out->features[r * fcols + iv.first] = iv.second;
}

// --------------------------------------------------------------- predictor

struct NativeTree {
  int num_leaves = 1;
  int num_cat = 0;
  std::vector<int> split_feature;
  std::vector<double> threshold;
  std::vector<int8_t> decision_type;
  std::vector<int> left_child;
  std::vector<int> right_child;
  std::vector<double> leaf_value;
  std::vector<int> cat_boundaries;
  std::vector<uint32_t> cat_threshold;

  inline bool cat_decision(double fval, int node) const {
    // CategoricalDecision (tree.h:268-283)
    if (std::isnan(fval)) {
      if (((decision_type[node] >> 2) & 3) == kMissingNan) return false;
      fval = 0.0;
    }
    int iv = static_cast<int>(fval);
    if (iv < 0) return false;
    int ci = static_cast<int>(threshold[node]);
    int lo = cat_boundaries[ci], hi = cat_boundaries[ci + 1];
    int i1 = iv / 32, i2 = iv % 32;
    if (lo + i1 < hi) return (cat_threshold[lo + i1] >> i2) & 1u;
    return false;
  }

  inline int get_leaf(const double* fv) const {
    // NumericalDecision walk (tree.h:231-313,426-438)
    if (num_leaves <= 1) return 0;
    int node = 0;
    while (node >= 0) {
      double v = fv[split_feature[node]];
      bool go_left;
      int8_t dt = decision_type[node];
      if (dt & kCategoricalMask) {
        go_left = cat_decision(v, node);
      } else {
        int mt = (dt >> 2) & 3;
        bool dl = dt & kDefaultLeftMask;
        if (std::isnan(v) && mt != kMissingNan) v = 0.0;
        bool missing = (mt == kMissingZero && std::fabs(v) <= kZeroRange) ||
                       (mt == kMissingNan && std::isnan(v));
        go_left = missing ? dl : (v <= threshold[node]);
      }
      node = go_left ? left_child[node] : right_child[node];
    }
    return ~node;
  }

  inline double predict(const double* fv) const {
    return leaf_value[get_leaf(fv)];
  }
};

struct NativeModel {
  int num_class = 1;
  int max_feature_idx = 0;
  bool average_output = false;
  std::string objective;         // e.g. "binary sigmoid:1"
  double sigmoid = 1.0;
  std::vector<NativeTree> trees;
  std::string error;

  int num_features() const { return max_feature_idx + 1; }
  int num_iterations() const {
    return num_class > 0 ? (int)trees.size() / num_class : 0;
  }
};

template <typename T>
std::vector<T> parse_array(const std::string& s) {
  std::vector<T> out;
  std::istringstream iss(s);
  double v;
  while (iss >> v) out.push_back(static_cast<T>(v));
  return out;
}

NativeModel* load_model_from_string(const std::string& text) {
  auto* model = new NativeModel();
  std::istringstream in(text);
  std::string line;
  // header section until the first blank line / "Tree=" block
  std::map<std::string, std::string> kv;
  std::vector<std::map<std::string, std::string>> tree_blocks;
  std::map<std::string, std::string>* cur = &kv;
  bool in_trees = false;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.rfind("Tree=", 0) == 0) {
      tree_blocks.emplace_back();
      cur = &tree_blocks.back();
      in_trees = true;
      continue;
    }
    if (line.rfind("feature importances", 0) == 0) break;
    if (line == "boost_from_average") { kv["boost_from_average"] = "1"; continue; }
    if (line == "average_output") { kv["average_output"] = "1"; continue; }
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    (*cur)[line.substr(0, eq)] = line.substr(eq + 1);
  }
  (void)in_trees;
  if (kv.count("num_class")) model->num_class = std::atoi(kv["num_class"].c_str());
  if (kv.count("max_feature_idx"))
    model->max_feature_idx = std::atoi(kv["max_feature_idx"].c_str());
  model->average_output = kv.count("average_output") > 0;
  if (kv.count("objective")) {
    model->objective = kv["objective"];
    auto sp = model->objective.find("sigmoid:");
    if (sp != std::string::npos)
      model->sigmoid = std::strtod(model->objective.c_str() + sp + 8, nullptr);
  }
  for (auto& tb : tree_blocks) {
    NativeTree t;
    t.num_leaves = tb.count("num_leaves") ? std::atoi(tb["num_leaves"].c_str()) : 1;
    t.num_cat = tb.count("num_cat") ? std::atoi(tb["num_cat"].c_str()) : 0;
    int n = t.num_leaves - 1;
    if (n > 0) {
      t.split_feature = parse_array<int>(tb["split_feature"]);
      t.threshold = parse_array<double>(tb["threshold"]);
      t.decision_type = parse_array<int8_t>(tb["decision_type"]);
      t.left_child = parse_array<int>(tb["left_child"]);
      t.right_child = parse_array<int>(tb["right_child"]);
      if ((int)t.split_feature.size() != n || (int)t.threshold.size() != n ||
          (int)t.decision_type.size() != n || (int)t.left_child.size() != n ||
          (int)t.right_child.size() != n) {
        model->error = "malformed tree block (array length mismatch)";
        return model;
      }
    }
    t.leaf_value = parse_array<double>(tb["leaf_value"]);
    if ((int)t.leaf_value.size() < t.num_leaves) {
      model->error = "malformed tree block (leaf_value)";
      return model;
    }
    if (t.num_cat > 0) {
      t.cat_boundaries = parse_array<int>(tb["cat_boundaries"]);
      t.cat_threshold = parse_array<uint32_t>(tb["cat_threshold"]);
    }
    model->trees.push_back(std::move(t));
  }
  return model;
}

}  // namespace

// =================================================================== C ABI

extern "C" {

// ------------------------------------------------------------------ parser

void* GBTN_ParseFile(const char* path, int has_header, int label_idx) {
  auto* out = new ParseResult();
  std::ifstream f(path);
  if (!f) { out->error = std::string("cannot open ") + path; return out; }
  std::vector<std::string> lines;
  std::string line;
  bool first = true;
  std::string header;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (first && has_header) { header = line; first = false; continue; }
    first = false;
    if (!line.empty()) lines.push_back(std::move(line));
  }
  if (lines.empty()) { out->error = "empty data file"; return out; }
  std::vector<std::string> head(lines.begin(),
                                lines.begin() + std::min<size_t>(32, lines.size()));
  switch (sniff_format(head)) {
    case Format::kLibSVM: parse_libsvm_lines(lines, label_idx, out); break;
    case Format::kTSV:    parse_delim_lines(lines, '\t', false, label_idx, out); break;
    case Format::kCSV:    parse_delim_lines(lines, ',', false, label_idx, out); break;
    case Format::kSpace:  parse_delim_lines(lines, ' ', true, label_idx, out); break;
  }
  return out;
}

long long GBTN_ParsedRows(void* h) { return static_cast<ParseResult*>(h)->rows; }
long long GBTN_ParsedCols(void* h) { return static_cast<ParseResult*>(h)->cols; }
const char* GBTN_ParsedError(void* h) {
  return static_cast<ParseResult*>(h)->error.c_str();
}

void GBTN_ParsedCopy(void* h, double* features, float* labels) {
  auto* p = static_cast<ParseResult*>(h);
  if (!p->features.empty())
    std::memcpy(features, p->features.data(), p->features.size() * sizeof(double));
  if (!p->labels.empty())
    std::memcpy(labels, p->labels.data(), p->labels.size() * sizeof(float));
}

void GBTN_ParsedFree(void* h) { delete static_cast<ParseResult*>(h); }

// ----------------------------------------------------------------- binning

// Vectorized ValueToBin (bin.h:451-483): first bin whose upper bound >= v.
// bounds: strictly increasing uppers, n_search entries used for the search
// (excludes a trailing NaN bin); nan_bin: bin for NaN rows (-1: treat as 0).
void GBTN_BinColumn(const double* values, long long n, const double* bounds,
                    int n_search, int nan_bin, int out_bits, void* out) {
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    double v = values[i];
    int b;
    if (std::isnan(v)) {
      if (nan_bin >= 0) b = nan_bin;
      else { v = 0.0; b = -1; }
    } else {
      b = -1;
    }
    if (b < 0) {
      // lower_bound over bounds[0..n_search-2]; last bin catches the rest
      int lo = 0, hi = n_search - 1;
      while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (bounds[mid] < v) lo = mid + 1; else hi = mid;
      }
      b = lo;
    }
    if (out_bits == 8) static_cast<uint8_t*>(out)[i] = (uint8_t)b;
    else static_cast<uint16_t*>(out)[i] = (uint16_t)b;
  }
}

// Greedy equal-count bin boundary search over (distinct value, count)
// pairs — the hot inner loop of BinMapper fitting (bin.cpp:72-141
// semantics, mirroring data/binning.py::greedy_find_bin exactly; the
// Python loop costs ~17 ms per continuous feature at 50k distinct
// values, which dominates wide-dataset construction).  Writes at most
// max(max_bin, 1) boundaries (last one +inf) into out; returns the count.
int GBTN_GreedyFindBin(const double* distinct, const long long* counts,
                       int num_distinct, int max_bin, long long total_cnt,
                       int min_data_in_bin, double* out) {
  const double kInf = std::numeric_limits<double>::infinity();
  int n_out = 0;
  if (max_bin <= 0) {
    out[n_out++] = kInf;
    return n_out;
  }
  if (num_distinct <= max_bin) {
    long long cur = 0;
    for (int i = 0; i < num_distinct - 1; ++i) {
      cur += counts[i];
      if (cur >= min_data_in_bin) {
        out[n_out++] = (distinct[i] + distinct[i + 1]) / 2.0;
        cur = 0;
      }
    }
    out[n_out++] = kInf;
    return n_out;
  }
  if (min_data_in_bin > 0) {
    long long cap = total_cnt / min_data_in_bin;
    if (cap < max_bin) max_bin = (int)cap;
    if (max_bin < 1) max_bin = 1;
  }
  double mean_bin_size = (double)total_cnt / max_bin;
  std::vector<char> is_big(num_distinct);
  int rest_bin_cnt = max_bin;
  long long rest_sample_cnt = total_cnt;
  for (int i = 0; i < num_distinct; ++i) {
    is_big[i] = (double)counts[i] >= mean_bin_size;
    if (is_big[i]) {
      --rest_bin_cnt;
      rest_sample_cnt -= counts[i];
    }
  }
  mean_bin_size = (double)rest_sample_cnt / std::max(rest_bin_cnt, 1);
  std::vector<double> upper(max_bin, kInf), lower(max_bin, kInf);
  int bin_cnt = 0;
  lower[0] = distinct[0];
  long long cur = 0;
  for (int i = 0; i < num_distinct - 1; ++i) {
    if (!is_big[i]) rest_sample_cnt -= counts[i];
    cur += counts[i];
    if (is_big[i] || (double)cur >= mean_bin_size ||
        (is_big[i + 1] &&
         (double)cur >= std::max(1.0, mean_bin_size * 0.5))) {
      upper[bin_cnt] = distinct[i];
      ++bin_cnt;
      lower[bin_cnt] = distinct[i + 1];
      if (bin_cnt >= max_bin - 1) break;
      cur = 0;
      if (!is_big[i]) {
        --rest_bin_cnt;
        mean_bin_size = (double)rest_sample_cnt / std::max(rest_bin_cnt, 1);
      }
    }
  }
  bin_cnt += 1;
  for (int i = 0; i < bin_cnt - 1; ++i)
    out[n_out++] = (upper[i] + lower[i + 1]) / 2.0;
  out[n_out++] = kInf;
  return n_out;
}

// Categorical value->bin through a sorted (category, bin) table.
void GBTN_BinColumnCategorical(const double* values, long long n,
                               const long long* cats, const int* bins,
                               int n_cats, int overflow_bin, int out_bits,
                               void* out) {
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    double v = values[i];
    int b = overflow_bin;
    if (!std::isnan(v)) {
      long long iv = (long long)v;
      int lo = 0, hi = n_cats;
      while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (cats[mid] < iv) lo = mid + 1; else hi = mid;
      }
      if (lo < n_cats && cats[lo] == iv) b = bins[lo];
    }
    if (out_bits == 8) static_cast<uint8_t*>(out)[i] = (uint8_t)b;
    else static_cast<uint16_t*>(out)[i] = (uint16_t)b;
  }
}

// --------------------------------------------------------------- predictor

void* GBTN_LoadModelString(const char* s) {
  return load_model_from_string(std::string(s));
}

void* GBTN_LoadModelFile(const char* path) {
  std::ifstream f(path);
  if (!f) {
    auto* m = new NativeModel();
    m->error = std::string("cannot open ") + path;
    return m;
  }
  std::stringstream ss;
  ss << f.rdbuf();
  return load_model_from_string(ss.str());
}

const char* GBTN_ModelError(void* h) {
  return static_cast<NativeModel*>(h)->error.c_str();
}
int GBTN_ModelNumClass(void* h) { return static_cast<NativeModel*>(h)->num_class; }
int GBTN_ModelNumTrees(void* h) {
  return (int)static_cast<NativeModel*>(h)->trees.size();
}
int GBTN_ModelNumFeatures(void* h) {
  return static_cast<NativeModel*>(h)->num_features();
}

// Raw-score batch prediction (Predictor analogue, predictor.hpp:24-195):
// X row-major [n, f]; out [n, num_class]; num_iteration <= 0 -> all.
void GBTN_Predict(void* h, const double* X, long long n, int f,
                  int num_iteration, int raw_score, double* out) {
  auto* m = static_cast<NativeModel*>(h);
  int k = std::max(m->num_class, 1);
  int iters = m->num_iterations();
  if (num_iteration > 0 && num_iteration < iters) iters = num_iteration;
  int total = iters * k;
  (void)f;
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < n; ++r) {
    const double* fv = X + r * f;
    double* o = out + r * k;
    for (int c = 0; c < k; ++c) o[c] = 0.0;
    for (int t = 0; t < total; ++t) o[t % k] += m->trees[t].predict(fv);
    // GBDT::Predict semantics (gbdt_prediction.cpp:29-38): raw score is
    // the plain SUM; average_output (RF) divides by the iteration count
    // and applies NO objective transform; otherwise ConvertOutput.
    if (!raw_score && m->average_output) {
      if (iters > 0)
        for (int c = 0; c < k; ++c) o[c] /= iters;
    } else if (!raw_score) {
      if (m->objective.rfind("binary", 0) == 0) {
        o[0] = 1.0 / (1.0 + std::exp(-m->sigmoid * o[0]));
      } else if (m->objective.rfind("multiclassova", 0) == 0) {
        for (int c = 0; c < k; ++c)
          o[c] = 1.0 / (1.0 + std::exp(-m->sigmoid * o[c]));
      } else if (m->objective.rfind("multiclass", 0) == 0) {
        double mx = o[0];
        for (int c = 1; c < k; ++c) mx = std::max(mx, o[c]);
        double s = 0.0;
        for (int c = 0; c < k; ++c) { o[c] = std::exp(o[c] - mx); s += o[c]; }
        for (int c = 0; c < k; ++c) o[c] /= s;
      } else if (m->objective.rfind("xentlambda", 0) == 0 ||
                 m->objective.rfind("cross_entropy_lambda", 0) == 0) {
        o[0] = std::log1p(std::exp(o[0]));
      } else if (m->objective.rfind("xentropy", 0) == 0 ||
                 m->objective.rfind("cross_entropy", 0) == 0) {
        o[0] = 1.0 / (1.0 + std::exp(-o[0]));
      }
      // poisson is IDENTITY in the reference v2.0.5 (linear-score form,
      // regression_objective.hpp:299-358 defines no ConvertOutput)
    }
  }
}

// Per-tree leaf index prediction (PredictLeafIndex): out [n, total_trees].
void GBTN_PredictLeaf(void* h, const double* X, long long n, int f,
                      int num_iteration, int* out) {
  auto* m = static_cast<NativeModel*>(h);
  int k = std::max(m->num_class, 1);
  int iters = m->num_iterations();
  if (num_iteration > 0 && num_iteration < iters) iters = num_iteration;
  int total = iters * k;
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < n; ++r) {
    const double* fv = X + r * f;
    for (int t = 0; t < total; ++t)
      out[r * total + t] = m->trees[t].get_leaf(fv);
  }
}

void GBTN_FreeModel(void* h) { delete static_cast<NativeModel*>(h); }

int GBTN_OpenMPThreads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
