// Native CSV scanner/parser for libgdf_tpu.
//
// Host counterpart of the reference's device-side CSV pipeline
// (libgdf/src/io/csv/csv-reader.cu: countRecords / storeRecordStart /
// convertCsvToGdf kernels + type_conversion.cuh field converters). Here
// the byte scan belongs on the host (the data crosses to the device anyway),
// so this is a multithreaded C++ implementation: mmap the file, scan
// record offsets in parallel, then convert each numeric column straight
// into caller-provided typed buffers with a validity byte per row
// (empty/unparseable field => 0, like the reference's bitmask clear,
// csv-reader.cu:119-130).
//
// C ABI (consumed by libgdf_tpu/native/__init__.py via ctypes):
//   gdf_csv_open    -> handle (mmap + record index)
//   gdf_csv_nrows   -> number of records after skiprows/skipfooter
//   gdf_csv_parse_column -> fill typed buffer + valid mask for one column
//   gdf_csv_field   -> copy one raw field (for str/date columns)
//   gdf_csv_close   -> unmap and free
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <string>
#include <thread>
#include <vector>

namespace {

struct CsvHandle {
  int fd = -1;
  const char *data = nullptr;
  size_t size = 0;
  char delim = ',';
  char term = '\n';
  bool skipinitialspace = false;
  // Offset of the first byte of every record (after skiprows trimming).
  std::vector<size_t> row_start;
  std::vector<size_t> row_end;  // exclusive, excludes terminator
};

// Parallel newline scan (== countRecords/storeRecordStart,
// csv-reader.cu:505-608, minus the GPU).
void index_records(CsvHandle *h, int skiprows, int skipfooter) {
  const char *d = h->data;
  const size_t n = h->size;
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (n < (1u << 16)) nthreads = 1;
  std::vector<std::vector<size_t>> found(nthreads);
  std::vector<std::thread> workers;
  const size_t chunk = (n + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    workers.emplace_back([&, t]() {
      const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      const char term = h->term;
      for (size_t i = lo; i < hi; ++i)
        if (d[i] == term) found[t].push_back(i);
    });
  }
  for (auto &w : workers) w.join();

  std::vector<size_t> terms;
  size_t total = 0;
  for (auto &f : found) total += f.size();
  terms.reserve(total);
  for (auto &f : found) terms.insert(terms.end(), f.begin(), f.end());

  std::vector<size_t> starts, ends;
  size_t pos = 0;
  for (size_t tpos : terms) {
    starts.push_back(pos);
    ends.push_back(tpos);
    pos = tpos + 1;
  }
  if (pos < n) {  // final record without trailing terminator
    starts.push_back(pos);
    ends.push_back(n);
  }
  const size_t nrows = starts.size();
  size_t lo = std::min<size_t>(skiprows, nrows);
  size_t hi = nrows - std::min<size_t>(skipfooter, nrows - lo);
  h->row_start.assign(starts.begin() + lo, starts.begin() + hi);
  h->row_end.assign(ends.begin() + lo, ends.begin() + hi);
}

// Locate field `col` within record [lo, hi): returns [fs, fe).
inline void find_field(const CsvHandle *h, size_t lo, size_t hi, int col,
                       size_t *fs, size_t *fe) {
  const char *d = h->data;
  size_t s = lo;
  for (int c = 0; c < col; ++c) {
    while (s < hi && d[s] != h->delim) ++s;
    if (s < hi) ++s;  // past delimiter
  }
  size_t e = s;
  while (e < hi && d[e] != h->delim) ++e;
  if (h->skipinitialspace)
    while (s < e && (d[s] == ' ' || d[s] == '\t')) ++s;
  // trim trailing CR (files with \r\n) and surrounding spaces
  while (e > s && (d[e - 1] == '\r' || d[e - 1] == ' ' || d[e - 1] == '\t'))
    --e;
  while (s < e && (d[s] == ' ' || d[s] == '\t')) ++s;
  *fs = s;
  *fe = e;
}

enum DtypeCode {  // mirrors libgdf_tpu/native/__init__.py
  DT_INT8 = 1, DT_INT16 = 2, DT_INT32 = 3, DT_INT64 = 4,
  DT_F32 = 5, DT_F64 = 6,
};

template <typename T>
inline bool parse_int(const char *s, const char *e, T *out) {
  if (s == e) return false;
  bool neg = false;
  if (*s == '-' || *s == '+') { neg = (*s == '-'); ++s; }
  if (s == e) return false;
  long long v = 0;
  for (; s < e; ++s) {
    if (*s < '0' || *s > '9') {
      // tolerate a fractional tail like the reference's int-from-float
      if (*s == '.') break;
      return false;
    }
    v = v * 10 + (*s - '0');
  }
  *out = static_cast<T>(neg ? -v : v);
  return true;
}

inline bool parse_f64(const char *s, const char *e, double *out) {
  if (s == e) return false;
  std::string tmp(s, e - s);
  char *endp = nullptr;
  errno = 0;
  double v = strtod(tmp.c_str(), &endp);
  if (errno || endp != tmp.c_str() + tmp.size()) return false;
  *out = v;
  return true;
}

template <typename T, bool kFloat>
void parse_col_range(const CsvHandle *h, int col, size_t lo, size_t hi,
                     T *out, uint8_t *valid) {
  for (size_t i = lo; i < hi; ++i) {
    size_t fs, fe;
    find_field(h, h->row_start[i], h->row_end[i], col, &fs, &fe);
    bool ok;
    if (kFloat) {
      double v;
      ok = parse_f64(h->data + fs, h->data + fe, &v);
      out[i] = static_cast<T>(v);
    } else {
      T v{};
      ok = parse_int<T>(h->data + fs, h->data + fe, &v);
      out[i] = v;
    }
    if (!ok) out[i] = T{};
    valid[i] = ok ? 1 : 0;
  }
}

template <typename T, bool kFloat>
void parse_col_mt(const CsvHandle *h, int col, T *out, uint8_t *valid) {
  const size_t n = h->row_start.size();
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (n < 4096) nthreads = 1;
  std::vector<std::thread> workers;
  const size_t chunk = (n + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(parse_col_range<T, kFloat>, h, col, lo, hi, out,
                         valid);
  }
  for (auto &w : workers) w.join();
}

}  // namespace

extern "C" {

void *gdf_csv_open(const char *path, char delim, char term,
                   int skiprows, int skipfooter, int skipinitialspace) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  auto *h = new CsvHandle;
  h->fd = fd;
  h->size = static_cast<size_t>(st.st_size);
  h->delim = delim;
  h->term = term;
  h->skipinitialspace = skipinitialspace != 0;
  if (h->size > 0) {
    void *m = mmap(nullptr, h->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) { close(fd); delete h; return nullptr; }
    h->data = static_cast<const char *>(m);
  }
  index_records(h, skiprows, skipfooter);
  return h;
}

long long gdf_csv_nrows(void *handle) {
  return static_cast<CsvHandle *>(handle)->row_start.size();
}

// Fill out[nrows] and valid[nrows] for column `col`. Returns 0 on success.
int gdf_csv_parse_column(void *handle, int col, int dtype_code, void *out,
                         uint8_t *valid) {
  auto *h = static_cast<CsvHandle *>(handle);
  switch (dtype_code) {
    case DT_INT8:
      parse_col_mt<int8_t, false>(h, col, static_cast<int8_t *>(out), valid);
      return 0;
    case DT_INT16:
      parse_col_mt<int16_t, false>(h, col, static_cast<int16_t *>(out),
                                   valid);
      return 0;
    case DT_INT32:
      parse_col_mt<int32_t, false>(h, col, static_cast<int32_t *>(out),
                                   valid);
      return 0;
    case DT_INT64:
      parse_col_mt<int64_t, false>(h, col, static_cast<int64_t *>(out),
                                   valid);
      return 0;
    case DT_F32:
      parse_col_mt<float, true>(h, col, static_cast<float *>(out), valid);
      return 0;
    case DT_F64:
      parse_col_mt<double, true>(h, col, static_cast<double *>(out), valid);
      return 0;
    default:
      return 1;
  }
}

// Copy raw field text (row, col) into buf (cap bytes); returns field length
// (may exceed cap — caller re-calls with a bigger buffer).
long long gdf_csv_field(void *handle, long long row, int col, char *buf,
                        long long cap) {
  auto *h = static_cast<CsvHandle *>(handle);
  if (row < 0 || static_cast<size_t>(row) >= h->row_start.size()) return -1;
  size_t fs, fe;
  find_field(h, h->row_start[row], h->row_end[row], col, &fs, &fe);
  const long long len = static_cast<long long>(fe - fs);
  if (buf && cap > 0) memcpy(buf, h->data + fs, std::min<long long>(len, cap));
  return len;
}

// Batched text extraction for one column (str/date columns): fills
// offsets[nrows+1] with cumulative byte offsets and, when bytes is
// non-null, copies every field's raw text contiguously (parallel).
// Two-call protocol: first with bytes == nullptr to size the buffer
// (returns total bytes), then with the allocated buffer. Replaces the
// one-ctypes-call-per-field path that cost str/date columns most of
// the native scanner's win.
long long gdf_csv_column_text(void *handle, int col, long long *offsets,
                              char *bytes) {
  auto *h = static_cast<CsvHandle *>(handle);
  const size_t n = h->row_start.size();
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (n < 4096) nthreads = 1;
  const size_t chunk = (n + nthreads - 1) / nthreads;

  if (bytes == nullptr) {
    // pass 1: per-row field lengths (parallel), then prefix-sum
    std::vector<std::thread> workers;
    for (unsigned t = 0; t < nthreads; ++t) {
      const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      workers.emplace_back([h, col, lo, hi, offsets]() {
        for (size_t i = lo; i < hi; ++i) {
          size_t fs, fe;
          find_field(h, h->row_start[i], h->row_end[i], col, &fs, &fe);
          offsets[i + 1] = static_cast<long long>(fe - fs);
        }
      });
    }
    for (auto &w : workers) w.join();
    offsets[0] = 0;
    for (size_t i = 0; i < n; ++i) offsets[i + 1] += offsets[i];
    return offsets[n];
  }
  // pass 2: parallel copy at the caller-provided offsets
  std::vector<std::thread> workers;
  for (unsigned t = 0; t < nthreads; ++t) {
    const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([h, col, lo, hi, offsets, bytes]() {
      for (size_t i = lo; i < hi; ++i) {
        size_t fs, fe;
        find_field(h, h->row_start[i], h->row_end[i], col, &fs, &fe);
        memcpy(bytes + offsets[i], h->data + fs, fe - fs);
      }
    });
  }
  for (auto &w : workers) w.join();
  return offsets[n];
}

void gdf_csv_close(void *handle) {
  auto *h = static_cast<CsvHandle *>(handle);
  if (h->data) munmap(const_cast<char *>(h->data), h->size);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

}  // extern "C"
