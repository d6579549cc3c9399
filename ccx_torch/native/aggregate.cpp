// Native windowed-scatter kernel for the metric-sample aggregator.
//
// The reference's host-side hot loop #2 (SURVEY.md call stack 3.2) is the
// O(P * W) windowed rollup; in ccx it is the ingest scatter in
// ccx/monitor/aggregator.py. numpy's ufunc.at is an order of magnitude
// slower than a fused single pass at 100k-partition sample batches, so this
// kernel applies all four accumulations (sum, max, count, latest) in one
// cache-friendly sweep. Loaded via ctypes (ccx/native/__init__.py) with a
// transparent numpy fallback when the shared library is unavailable.
//
// Layout contract (matches the aggregator's arrays):
//   sum, mx, latest : double[E, W, M]  (C-contiguous)
//   latest_t        : int64[E, W]
//   count           : int64[E, W]
//   entities, slots : int64[n]  (slots pre-validated: 0 <= slot < W)
//   times           : int64[n]  (rows sorted ascending by time so the
//                                "latest" overwrite is last-write-wins)
//   metrics         : double[n, M]

#include <cstdint>

extern "C" {

void ccx_scatter(double* sum, double* mx, double* latest,
                 std::int64_t* latest_t, std::int64_t* count,
                 const std::int64_t* entities, const std::int64_t* slots,
                 const std::int64_t* times, const double* metrics,
                 std::int64_t n, std::int64_t W, std::int64_t M) {
  for (std::int64_t i = 0; i < n; ++i) {
    const std::int64_t cell = entities[i] * W + slots[i];
    double* srow = sum + cell * M;
    double* xrow = mx + cell * M;
    const double* m = metrics + i * M;
    for (std::int64_t j = 0; j < M; ++j) {
      srow[j] += m[j];
      if (m[j] > xrow[j]) xrow[j] = m[j];
    }
    count[cell] += 1;
    if (times[i] >= latest_t[cell]) {
      latest_t[cell] = times[i];
      double* lrow = latest + cell * M;
      for (std::int64_t j = 0; j < M; ++j) lrow[j] = m[j];
    }
  }
}

// Batch decode of length-prefixed partition samples (ccx/monitor/sampling/
// holders.py serialize_batch framing) into columnar arrays — the warm-start
// path deserializes the full store at boot; a Python struct loop costs
// ~3 us/record, this costs ~0.03.
//   buf: the raw log; out_*: preallocated [capacity] / [capacity, M]
// Returns number of records decoded, or -1 on a framing error.
std::int64_t ccx_decode_partition_samples(
    const unsigned char* buf, std::int64_t len, std::int64_t capacity,
    std::int64_t M, std::int64_t* out_ids, std::int64_t* out_times,
    double* out_metrics) {
  std::int64_t off = 0, rec = 0;
  const std::int64_t head = 3 + 1 + 8 + 8 + 8 + 2;  // magic ver broker part time n
  while (off + 4 <= len && rec < capacity) {
    std::uint32_t rlen;
    __builtin_memcpy(&rlen, buf + off, 4);
    off += 4;
    if (off + rlen > len) return -1;
    const unsigned char* r = buf + off;
    if (rlen < 4) return -1;  // too short for even magic + version
    if (!(r[0] == 'C' && r[1] == 'X' && r[2] == 'P')) {
      off += rlen;  // skip broker samples and other record types
      continue;
    }
    // Validate the record version like the Python deserializer does —
    // a future schema must fail loudly (caller falls back), not misparse.
    if (r[3] > 1) return -1;
    if (static_cast<std::int64_t>(rlen) < head) return -1;
    std::int64_t partition, time_ms;
    std::uint16_t nm;
    __builtin_memcpy(&partition, r + 12, 8);
    __builtin_memcpy(&time_ms, r + 20, 8);
    __builtin_memcpy(&nm, r + 28, 2);
    if (head + 8 * static_cast<std::int64_t>(nm) > rlen) return -1;
    out_ids[rec] = partition;
    out_times[rec] = time_ms;
    const std::int64_t take = nm < M ? nm : M;
    for (std::int64_t j = 0; j < take; ++j) {
      double v;
      __builtin_memcpy(&v, r + head + 8 * j, 8);
      out_metrics[rec * M + j] = v;
    }
    for (std::int64_t j = take; j < M; ++j) out_metrics[rec * M + j] = 0.0;
    ++rec;
    off += rlen;
  }
  return rec;
}

}  // extern "C"
