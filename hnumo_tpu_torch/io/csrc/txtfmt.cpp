// txtfmt: the txt snapshot's number formatter for hnumo_tpu_torch.
//
// Writes each float64 value exactly as Python's '{:23.16e}\n'.format does
// (io/snapshots._column_plain, the oracle of tests/test_torch_txtfmt.py):
// seventeen significant digits, correctly rounded, in scientific notation
// with an exponent of at least two digits, right-aligned in 23 columns,
// then a newline. A value wider than 23 columns (a three-digit exponent)
// keeps its natural width. Every NaN is written "nan", whatever its sign
// bit; the infinities "inf" and "-inf".
//
// std::to_chars (C++17, <charconv>) gives the digits: it rounds the exact
// binary value, as Python's own dtoa does, and needs no locale.
//
// The values are split over threads in contiguous chunks. Chunk k is
// formatted into its own region of the output, which starts at its first
// value's index times TXTFMT_VALUE_BYTES (the widest a value can be), then
// the regions are packed in order.
//
// Built by hnumo_tpu_torch/_hostlib.py into hnumo_tpu_torch/_build/ at first
// use, bound with ctypes by hnumo_tpu_torch/io/_native.py.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int kWidth = 23;
// "-1.7976931348623157e+308\n"
constexpr int64_t kValueBytes = 25;

char* put(char* p, double v) {
  char digits[32];
  int n;
  if (std::isnan(v)) {
    std::memcpy(digits, "nan", 3);
    n = 3;
  } else {
    auto r = std::to_chars(digits, digits + sizeof digits, v,
                           std::chars_format::scientific, 16);
    n = static_cast<int>(r.ptr - digits);
  }
  if (n < kWidth) {
    std::memset(p, ' ', kWidth - n);
    p += kWidth - n;
  }
  std::memcpy(p, digits, n);
  p += n;
  *p++ = '\n';
  return p;
}

}  // namespace

extern "C" {

// The most bytes one value takes; `out` holds at least n times this.
int64_t txtfmt_value_bytes() { return kValueBytes; }

// Formats x[0..n) into out, one value a line, over `threads` threads.
// Returns the number of bytes written, or -1 where cap < n * kValueBytes.
int64_t txtfmt_column(const double* x, int64_t n, char* out, int64_t cap,
                      int threads) {
  if (n < 0 || cap < n * kValueBytes) return -1;
  int64_t nthreads = threads < 1 ? 1 : threads;
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  std::vector<int64_t> len(nthreads, 0);
  auto chunk = [&](int64_t k) {
    int64_t begin = n * k / nthreads, end = n * (k + 1) / nthreads;
    char* start = out + begin * kValueBytes;
    char* p = start;
    for (int64_t i = begin; i < end; ++i) p = put(p, x[i]);
    len[k] = p - start;
  };
  std::vector<std::thread> pool;
  for (int64_t k = 1; k < nthreads; ++k) {
    try {
      pool.emplace_back(chunk, k);
    } catch (const std::system_error&) {
      chunk(k);  // no thread to be had: the same chunk on this one
    }
  }
  chunk(0);
  for (auto& t : pool) t.join();
  // pack: region k moves down to the end of region k - 1; it never moves up,
  // so no region is overwritten before it has moved
  int64_t at = len[0];
  for (int64_t k = 1; k < nthreads; ++k) {
    std::memmove(out + at, out + (n * k / nthreads) * kValueBytes, len[k]);
    at += len[k];
  }
  return at;
}

}  // extern "C"
