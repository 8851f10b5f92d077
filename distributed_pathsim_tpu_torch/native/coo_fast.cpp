// Native COO sparse-sparse product with coalescing — the host-side
// structural join of the half-chain fold (ops/sparse.py coo_matmul +
// summed), done in one C++ pass.
//
// This replaces the reference's distributed 4-way motif join
// (DPathSim_APVPA.py:72-84): the join structure is computed ONCE on the
// host, here, and the arithmetic runs on the card. At million-author scale this call dominates host time, so
// it gets the native treatment alongside the GEXF parser.
//
// C ABI, handle-based like gexf_fast.cpp: callers get an opaque result
// handle, read nnz, copy out flat arrays, free. Output is coalesced and
// sorted row-major — byte-identical ordering to the numpy path
// (np.unique over row*ncols+col yields ascending keys).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CooResult {
  std::vector<int64_t> rows;
  std::vector<int64_t> cols;
  std::vector<double> weights;
  std::string error;
};

}  // namespace

extern "C" {

// a: [nnz_a] COO triplets of an (M x K) matrix.
// b: [nnz_b] COO triplets of a (K x N) matrix; b_nrows = K, b_ncols = N.
// Returns an opaque CooResult* (never null); check coo_error() first.
void* coo_spgemm(const int64_t* a_rows, const int64_t* a_cols,
                 const double* a_w, int64_t nnz_a, const int64_t* b_rows,
                 const int64_t* b_cols, const double* b_w, int64_t nnz_b,
                 int64_t b_nrows, int64_t b_ncols) {
  auto* res = new CooResult();
  if (b_nrows < 0 || b_ncols <= 0) {
    res->error = "coo_spgemm: bad b shape";
    return res;
  }
  // CSR index of b by row (counting sort — rows are dense indices).
  std::vector<int64_t> row_start(static_cast<size_t>(b_nrows) + 1, 0);
  for (int64_t i = 0; i < nnz_b; ++i) {
    int64_t r = b_rows[i];
    if (r < 0 || r >= b_nrows) {
      res->error = "coo_spgemm: b row index out of range";
      return res;
    }
    ++row_start[static_cast<size_t>(r) + 1];
  }
  for (int64_t r = 0; r < b_nrows; ++r) row_start[r + 1] += row_start[r];
  std::vector<int64_t> b_col_sorted(nnz_b);
  std::vector<double> b_w_sorted(nnz_b);
  {
    std::vector<int64_t> fill(row_start.begin(), row_start.end() - 1);
    for (int64_t i = 0; i < nnz_b; ++i) {
      int64_t pos = fill[b_rows[i]]++;
      b_col_sorted[pos] = b_cols[i];
      b_w_sorted[pos] = b_w[i];
    }
  }
  // Join + accumulate. Key = row * b_ncols + col (row-major), matching
  // the numpy coalesce; counts are small integers so the accumulation
  // order cannot change the f64 result.
  std::unordered_map<uint64_t, double> acc;
  acc.reserve(static_cast<size_t>(nnz_a));
  const uint64_t ncols = static_cast<uint64_t>(b_ncols);
  for (int64_t i = 0; i < nnz_a; ++i) {
    int64_t mid = a_cols[i];
    if (mid < 0 || mid >= b_nrows) {
      res->error = "coo_spgemm: a col index out of range";
      return res;
    }
    const double aw = a_w[i];
    const uint64_t base = static_cast<uint64_t>(a_rows[i]) * ncols;
    for (int64_t p = row_start[mid]; p < row_start[mid + 1]; ++p) {
      acc[base + static_cast<uint64_t>(b_col_sorted[p])] += aw * b_w_sorted[p];
    }
  }
  // Extract sorted row-major for a deterministic, numpy-identical order.
  std::vector<std::pair<uint64_t, double>> entries(acc.begin(), acc.end());
  std::sort(entries.begin(), entries.end(),
            [](const auto& x, const auto& y) { return x.first < y.first; });
  res->rows.reserve(entries.size());
  res->cols.reserve(entries.size());
  res->weights.reserve(entries.size());
  for (const auto& [k, w] : entries) {
    res->rows.push_back(static_cast<int64_t>(k / ncols));
    res->cols.push_back(static_cast<int64_t>(k % ncols));
    res->weights.push_back(w);
  }
  return res;
}

const char* coo_error(void* h) {
  auto* res = static_cast<CooResult*>(h);
  return res->error.empty() ? nullptr : res->error.c_str();
}

int64_t coo_result_nnz(void* h) {
  return static_cast<int64_t>(static_cast<CooResult*>(h)->rows.size());
}

void coo_result_fill(void* h, int64_t* rows, int64_t* cols, double* w) {
  auto* res = static_cast<CooResult*>(h);
  const size_t n = res->rows.size();
  std::memcpy(rows, res->rows.data(), n * sizeof(int64_t));
  std::memcpy(cols, res->cols.data(), n * sizeof(int64_t));
  std::memcpy(w, res->weights.data(), n * sizeof(double));
}

void coo_free(void* h) { delete static_cast<CooResult*>(h); }

}  // extern "C"
