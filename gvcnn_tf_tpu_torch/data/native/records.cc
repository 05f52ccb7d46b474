// What the port's TFRecord path needs of C++, with no library beyond the
// C++ runtime (so it builds where libjpeg and libpng are missing): the
// masked CRC32C of the TFRecord framing, and the size of an encoded image
// read from its header.  Built alone into libgvrecords.so
// (data/native_loader.py), C API for ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#elif defined(__ARM_FEATURE_CRC32)
#include <arm_acle.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected polynomial 0x82F63B78): the checksum of the
// TFRecord framing.  The hardware instruction where the build's -march has
// it, else slicing-by-8 tables.
// ---------------------------------------------------------------------------
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c_update(uint32_t crc, const uint8_t* p, size_t n) {
#if defined(__SSE4_2__) && defined(__x86_64__)
  uint64_t c = crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
  }
  crc = uint32_t(c);
  for (; n; --n, ++p) crc = _mm_crc32_u8(crc, *p);
  return crc;
#elif defined(__ARM_FEATURE_CRC32)
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    crc = __crc32cd(crc, v);
  }
  for (; n; --n, ++p) crc = __crc32cb(crc, *p);
  return crc;
#else
  static const Crc32cTables tab;
  const auto& t = tab.t;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;  // little-endian hosts only (x86-64, aarch64)
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n; --n, ++p) crc = (crc >> 8) ^ t[0][(crc ^ *p) & 0xFF];
  return crc;
#endif
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

extern "C" {

// The TFRecord checksum of data[0:n]: CRC32C, rotated right by 15 bits,
// plus 0xa282ead8 (TensorFlow's masked_crc32c).
uint32_t gvx_masked_crc32c(const uint8_t* data, size_t n) {
  const uint32_t crc = ~crc32c_update(~0u, data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// Height and width of a PNG (IHDR) or baseline/progressive JPEG (SOFn)
// from its header.  Returns 0, or -1 when the blob is neither or is cut.
int gvx_image_size(const uint8_t* buf, size_t len, int* h, int* w) {
  if (len >= 24 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G' && std::memcmp(buf + 12, "IHDR", 4) == 0) {
    *w = int(be32(buf + 16));
    *h = int(be32(buf + 20));
    return 0;
  }
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;
  size_t i = 2;
  while (i + 4 <= len) {
    if (buf[i] != 0xFF) return -1;
    uint8_t m = buf[i + 1];
    if (m == 0xFF) {  // fill byte
      ++i;
      continue;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD8)) {  // markers without a length
      i += 2;
      continue;
    }
    const size_t seg = be16(buf + i + 2);
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (i + 9 > len) return -1;
      *h = int(be16(buf + i + 5));
      *w = int(be16(buf + i + 7));
      return 0;
    }
    i += 2 + seg;
  }
  return -1;
}

}  // extern "C"
