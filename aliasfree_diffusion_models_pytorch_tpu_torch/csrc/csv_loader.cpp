// Host-side data-loading runtime of the PyTorch port (the port's own copy of the JAX package's
// native/csv_loader.cpp, with the same C ABI and the same results).
//
// A single-pass CSV integer parser that writes straight into a caller-provided float buffer
// (normalised to [0, 1]), a deterministic splitmix64 Fisher-Yates permutation and a batch
// gather, exposed with a C ABI for ctypes. Python keeps orchestration; C++ does the byte
// crunching. It runs on the host CPU, not on the card.
//
// Build: utils/native.py compiles this file with g++ at first use into build/torch_native/ at
// the root of the checkout. The Python side keeps its numpy path where no compiler exists.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Count data rows (lines after the header) — lets the caller pre-allocate.
// Returns -1 on IO error.
int64_t afdm_csv_count_rows(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  constexpr size_t kBuf = 1 << 20;
  char* buf = static_cast<char*>(std::malloc(kBuf));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  int64_t newlines = 0;
  size_t got;
  bool last_was_newline = true;
  while ((got = std::fread(buf, 1, kBuf, f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') ++newlines;
    }
    last_was_newline = buf[got - 1] == '\n';
  }
  std::free(buf);
  std::fclose(f);
  if (!last_was_newline) ++newlines;     // final line without trailing \n
  return newlines > 0 ? newlines - 1 : 0;  // minus header
}

// Parse "label,p0,p1,...,p{cols-1}" rows into labels[rows] and
// pixels[rows*cols] (pixels divided by 255 into [0,1] floats).
// Returns the number of rows parsed, or -1 on IO error, -2 on format error.
int64_t afdm_parse_label_pixel_csv(const char* path, int64_t cols,
                                   int32_t* labels, float* pixels,
                                   int64_t max_rows) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // Slurp the file (MNIST-small is ~70 MB; trivially fits).
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* data = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!data) {
    std::fclose(f);
    return -1;
  }
  size_t rd = std::fread(data, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  data[rd] = '\0';

  const char* p = data;
  const char* end = data + rd;
  // Skip header line.
  while (p < end && *p != '\n') ++p;
  if (p < end) ++p;

  constexpr float kInv255 = 1.0f / 255.0f;
  int64_t row = 0;
  while (p < end && row < max_rows) {
    // Skip blank lines.
    if (*p == '\n' || *p == '\r') {
      ++p;
      continue;
    }
    // label
    bool neg = false;
    if (*p == '-') {
      neg = true;
      ++p;
    }
    int32_t label = 0;
    while (p < end && *p >= '0' && *p <= '9') label = label * 10 + (*p++ - '0');
    labels[row] = neg ? -label : label;
    // pixels
    float* out = pixels + row * cols;
    for (int64_t c = 0; c < cols; ++c) {
      if (p >= end || *p != ',') {
        std::free(data);
        return -2;
      }
      ++p;  // comma
      int32_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      out[c] = static_cast<float>(v) * kInv255;
    }
    while (p < end && *p != '\n') ++p;  // consume \r / junk to EOL
    if (p < end) ++p;
    ++row;
  }
  std::free(data);
  return row;
}

// Deterministic Fisher-Yates permutation with splitmix64 — the shuffling
// backbone of the native dataloader (seeded: (seed, epoch) fully determine
// the order, matching the Python Dataloader contract).
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void afdm_shuffled_permutation(int64_t n, uint64_t seed, uint64_t epoch,
                               int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + epoch + 0xD1B54A32D192ED03ull;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(s) % static_cast<uint64_t>(i + 1);
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Gather a batch: out[b] = images[perm[start+b]] for b in [0, bsz), where each
// image is `stride` floats. Parallel-friendly contiguous writes; the host-side
// analogue of a device gather, used by the prefetching dataloader.
void afdm_gather_batch(const float* images, const int64_t* perm, int64_t start,
                       int64_t bsz, int64_t stride, float* out) {
  for (int64_t b = 0; b < bsz; ++b) {
    std::memcpy(out + b * stride, images + perm[start + b] * stride,
                static_cast<size_t>(stride) * sizeof(float));
  }
}

}  // extern "C"
