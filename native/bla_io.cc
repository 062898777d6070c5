// Native host-side IO for big-linear-algebra.
//
// Native rebuild of the reference's C IO layer (lib/csv.c, lib/cifar10.c,
// lib/bmp.c, lib/mnist_csv2.c): the device compute path is JAX/XLA/Pallas,
// but the host-side data plane (CSV parsing of ~100MB MNIST files, binary
// CIFAR batches, BMP dumps) stays native for throughput. Exposed as a plain
// C ABI consumed via ctypes (see big_linear_algebra/data/_native.py);
// every entry point has a pure-Python fallback.
//
// CSV value contract (reference lib/csv.c:7-16,40-52, SURVEY.md §7.12): a ','
// always terminates a value (empty token parses as 0.0); a newline terminates
// a value only if characters were accumulated; '\r' is ignored. This accepts
// both the reference's trailing-comma files and standard CSVs.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr size_t kBufSize = 1 << 20;

// Streaming CSV scanner over a FILE*. Calls `emit(value)` per parsed value.
template <typename Emit>
long scan_csv(FILE* f, Emit&& emit) {
  char* buf = static_cast<char*>(malloc(kBufSize));
  if (!buf) return -1;
  char token[64];
  size_t tok_len = 0;
  long count = 0;
  size_t nread;
  while ((nread = fread(buf, 1, kBufSize, f)) > 0) {
    for (size_t i = 0; i < nread; i++) {
      const char c = buf[i];
      if (c == ',' || (c == '\n' && tok_len != 0)) {
        token[tok_len] = '\0';
        emit(tok_len ? strtof(token, nullptr) : 0.0f);
        tok_len = 0;
        count++;
      } else if (c != '\n' && c != '\r') {
        if (tok_len + 1 < sizeof(token)) token[tok_len++] = c;
      }
    }
  }
  // EOF terminates a trailing unterminated value (standard CSV last cell).
  if (tok_len != 0) {
    token[tok_len] = '\0';
    emit(strtof(token, nullptr));
    count++;
  }
  free(buf);
  return count;
}

}  // namespace

extern "C" {

// Count the number of CSV values in a file (see contract above).
// Returns -1 on open failure.
long bla_csv_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long n = scan_csv(f, [](float) {});
  fclose(f);
  return n;
}

// Parse up to `cap` CSV values into `out`. Returns the number of values the
// file contains (which may exceed cap; only cap are stored), or -1 on error.
long bla_csv_read(const char* path, float* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long stored = 0;
  long n = scan_csv(f, [&](float v) {
    if (stored < cap) out[stored++] = v;
  });
  fclose(f);
  return n;
}

// Write `rows` x `cols` float values in the reference CSV format:
// "%f," per value, newline after every `cols` values (lib/csv.c:59-70).
int bla_csv_write(const char* path, const float* data, long rows, long cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char* buf = static_cast<char*>(malloc(kBufSize));
  if (!buf) {
    fclose(f);
    return -1;
  }
  size_t used = 0;
  bool ok = true;
  for (long i = 0; ok && i < rows; i++) {
    for (long j = 0; j < cols; j++) {
      if (used + 64 > kBufSize) {
        ok = fwrite(buf, 1, used, f) == used;  // short write: disk full etc.
        used = 0;
        if (!ok) break;
      }
      used += snprintf(buf + used, 64, "%f,", data[i * cols + j]);
    }
    if (ok) buf[used++] = '\n';
  }
  if (ok && used) ok = fwrite(buf, 1, used, f) == used;
  free(buf);
  int rc = fclose(f);
  return (ok && rc == 0) ? 0 : -1;
}

// Count '\n' bytes (≈ count_num_lines, lib/csv.c:72-89). -1 on error.
long bla_count_lines(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* buf = static_cast<char*>(malloc(kBufSize));
  long count = 0;
  size_t nread;
  while ((nread = fread(buf, 1, kBufSize, f)) > 0)
    for (size_t i = 0; i < nread; i++) count += buf[i] == '\n';
  free(buf);
  fclose(f);
  return count;
}

// Read a CIFAR-10 binary batch file (10000 records of 1 label byte + 3072
// pixel bytes, lib/cifar10.c:6-11). Fills `labels[max]` and
// `pixels[max*3072]` (RRR..GGG..BBB planes, top-down row order as stored).
// Returns the number of examples read, or -1 on error.
long bla_cifar_read(const char* path, uint8_t* labels, uint8_t* pixels,
                    long max_examples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long n = 0;
  uint8_t rec[3073];
  while (n < max_examples && fread(rec, 1, 3073, f) == 3073) {
    labels[n] = rec[0];
    memcpy(pixels + n * 3072, rec + 1, 3072);
    n++;
  }
  fclose(f);
  return n;
}

// Write a 24-bit uncompressed BMP from per-channel planes
// (≈ write_bmp_data, lib/bmp.c:11; with the intended-semantics header — the
// reference writes byte 32 twice and never byte 33, SURVEY.md §7.14).
// Rows are written in the order given; BMP convention displays the first row
// at the bottom. Returns 0 on success, -1 on error.
int bla_bmp_write(const char* path, const uint8_t* red, const uint8_t* green,
                  const uint8_t* blue, int width, int height) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const unsigned row_size = ((24 * width + 31) / 32) * 4;
  const unsigned file_size = 54 + row_size * height;
  uint8_t header[54];
  memset(header, 0, sizeof(header));
  header[0] = 'B';
  header[1] = 'M';
  header[2] = file_size & 0xFF;
  header[3] = (file_size >> 8) & 0xFF;
  header[4] = (file_size >> 16) & 0xFF;
  header[5] = (file_size >> 24) & 0xFF;
  header[10] = 54;          // pixel data offset
  header[14] = 40;          // BITMAPINFOHEADER size
  header[18] = width & 0xFF;
  header[19] = (width >> 8) & 0xFF;
  header[20] = (width >> 16) & 0xFF;
  header[21] = (width >> 24) & 0x7F;
  header[22] = height & 0xFF;
  header[23] = (height >> 8) & 0xFF;
  header[24] = (height >> 16) & 0xFF;
  header[25] = (height >> 24) & 0x7F;
  header[26] = 1;           // color planes
  header[28] = 24;          // bits per pixel
  header[38] = 72;          // horizontal resolution
  header[42] = 72;          // vertical resolution
  if (fwrite(header, 1, 54, f) != 54) {
    fclose(f);
    return -1;
  }
  uint8_t* row = static_cast<uint8_t*>(calloc(row_size, 1));
  for (int i = 0; i < height; i++) {
    for (int j = 0; j < width; j++) {
      row[3 * j] = blue[i * width + j];
      row[3 * j + 1] = green[i * width + j];
      row[3 * j + 2] = red[i * width + j];
    }
    if (fwrite(row, 1, row_size, f) != row_size) {
      free(row);
      fclose(f);
      return -1;
    }
  }
  free(row);
  return fclose(f) == 0 ? 0 : -1;
}

}  // extern "C"
