// Native chunk codec for the zarrlite data path (the port's own copy of the
// JAX package's native/zarr_codec.cpp; the two must stay byte-compatible in
// what they decode).
//
// The input pipeline's CPU hot spot is zarr chunk IO: read file -> zlib
// inflate -> crop window copy. This library does the whole sequence in one
// C++ call per chunk; Python loader threads call it through ctypes, which
// releases the GIL for true parallelism without process forking.
//
// Build: at first use by sbgm_danra_tpu_torch/data/native_codec.py with the
// system C++ compiler (-O3 -shared -fPIC, links zlib) into
// sbgm_danra_tpu_torch/_build/.
// ABI: plain C functions; all sizes in elements, dtype float32/float64/raw.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

extern "C" {

enum CodecStatus {
  CODEC_OK = 0,
  CODEC_EOPEN = 1,
  CODEC_EREAD = 2,
  CODEC_EINFLATE = 3,
  CODEC_EBOUNDS = 4,
  CODEC_ESIZE = 5,
};

// Read a whole file into a malloc'd buffer. Returns size or -1.
static int64_t read_file(const char* path, unsigned char** out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  int64_t n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(n > 0 ? n : 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  int64_t got = static_cast<int64_t>(std::fread(buf, 1, n, f));
  std::fclose(f);
  if (got != n) {
    std::free(buf);
    return -1;
  }
  *out = buf;
  return n;
}

// Decompress (or pass through) a 2-D chunk file and copy a crop window into
// `out` (row-major float32 of (x2-x1) x (y2-y1)).
//   path: chunk file; compressed: 1 = zlib stream, 0 = raw bytes
//   h, w: chunk dims (elements); itemsize: bytes per element (4 or 8)
//   x1..y2: crop window, rows [x1, x2), cols [y1, y2)
int decompress_crop(const char* path, int compressed, int64_t h, int64_t w,
                    int itemsize, int64_t x1, int64_t x2, int64_t y1,
                    int64_t y2, unsigned char* out) {
  if (x1 < 0 || y1 < 0 || x2 > h || y2 > w || x1 >= x2 || y1 >= y2)
    return CODEC_EBOUNDS;

  unsigned char* raw = nullptr;
  int64_t raw_n = read_file(path, &raw);
  if (raw_n < 0) return CODEC_EOPEN;

  const uint64_t chunk_bytes = static_cast<uint64_t>(h) * w * itemsize;
  unsigned char* plain = nullptr;
  bool owned = false;

  if (compressed) {
    plain = static_cast<unsigned char*>(std::malloc(chunk_bytes));
    if (!plain) {
      std::free(raw);
      return CODEC_ESIZE;
    }
    owned = true;
    uLongf dest_len = chunk_bytes;
    int rc = uncompress(plain, &dest_len, raw, static_cast<uLong>(raw_n));
    std::free(raw);
    if (rc != Z_OK || dest_len != chunk_bytes) {
      std::free(plain);
      return CODEC_EINFLATE;
    }
  } else {
    if (static_cast<uint64_t>(raw_n) != chunk_bytes) {
      std::free(raw);
      return CODEC_ESIZE;
    }
    plain = raw;
    owned = true;
  }

  const int64_t crop_w = y2 - y1;
  const int64_t row_bytes = crop_w * itemsize;
  for (int64_t r = x1; r < x2; ++r) {
    const unsigned char* src = plain + (static_cast<uint64_t>(r) * w + y1) * itemsize;
    unsigned char* dst = out + (static_cast<uint64_t>(r - x1) * crop_w) * itemsize;
    std::memcpy(dst, src, row_bytes);
  }
  if (owned) std::free(plain);
  return CODEC_OK;
}

// Compress a buffer with zlib (level 1..9) into `out`; returns compressed
// size, or -1 on failure. `out` must hold compressBound(n) bytes.
int64_t compress_buffer(const unsigned char* src, int64_t n, int level,
                        unsigned char* out, int64_t out_cap) {
  uLongf dest_len = static_cast<uLongf>(out_cap);
  int rc = compress2(out, &dest_len, src, static_cast<uLong>(n), level);
  if (rc != Z_OK) return -1;
  return static_cast<int64_t>(dest_len);
}

int64_t compress_bound(int64_t n) { return compressBound(static_cast<uLong>(n)); }

}  // extern "C"
