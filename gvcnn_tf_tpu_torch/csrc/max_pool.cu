// TF-'SAME' / 'VALID' max pool on NHWC tensors, bf16 or fp32, forward and
// backward, for k x k windows at stride s with (k, s) in {(2, 2), (3, 1),
// (3, 2)}: every max pool of the port's backbones (Inception-v1's 13,
// ResNet-50's one, Inception-v2/v3/v4's).
//   * max_pool_same_fwd_{bf16,f32}: y = the window's maximum; where `slot`
//     is given, also the window slot (0 .. k*k-1, row-major) of the first
//     maximum, one byte an output element, NHWC like y;
//   * max_pool_same_bwd_{bf16,f32}: dx from dy and that record.
//
// Replaces no TPU kernel: the JAX package left pooling to XLA
// (reduce_window, and select_and_scatter for its gradient).  It was added
// because PyTorch's own NHWC pools were the largest block of device time in
// the B=32 Inception-v1 train step (21.4 ms of 63.6), 9x off their bound:
// the forward writes an int64 index an output (kept until the backward),
// and an asymmetric TF-'SAME' pad (0, 1) costs a -inf fill and a copy of
// the input, and a slice of its gradient.
//
// What bounds it on the H100: bytes.  No arithmetic to speak of; at 384
// images of 224x224 the 13 pools read 1.10 G bf16 inputs and write 0.544 G
// outputs and as many record bytes (3.84 GB, 1.15 ms at 3.35 TB/s); the
// backward reads dy and the record and writes dx, as much again.
//
// Design.
//   * Padding inside the kernel: a tap outside the image is not a
//     candidate (no -inf tensor).  A window whose taps are all -inf keeps
//     its first in-image tap, as F.max_pool2d does.
//   * Ties go to the first maximum in row-major window order, as
//     F.max_pool2d and XLA's select-and-scatter credit them; a window that
//     holds a NaN gives NaN and credits its first NaN.
//   * Each thread owns a vector of channels (16 bytes: 8 bf16 or 4 fp32,
//     one load and one store; the caller checks that C is a multiple of
//     it and that every pointer is 16-byte aligned, as every pool's input
//     on the backbones is) of one output column over a band of BAND
//     output rows (one row where k == s).  It takes each input row's maximum over the
//     window's columns once and folds it into every output row whose window
//     holds that row (a separable row max, then column max, in registers),
//     so at stride 1 a band reads BAND + 2 input rows, not 3 x BAND, and at
//     stride 2 2 x BAND + 1, not 3 x BAND.  The column re-reads of
//     neighbouring output columns come from neighbouring threads of the
//     same warp, so L1 serves them; DRAM sees each input about once.
//   * The arithmetic works on whole 32-bit words, two bf16 lanes at a time:
//     a NaN-propagating max (max.NaN.bf16x2), then, for the record, the
//     first tap equal to it (set.eq.bf16x2 masks, taps walked backwards),
//     so a tap costs a few instructions for 8 channels; one per channel
//     left the kernel bound by its instruction issue, not its bytes.
//   * The record is written only where the caller asks (a gradient is
//     needed); at one byte an element it is an eighth of an int64 index.
//   * Backward by gather: each thread owns the channel vector of dx at one
//     column of s input rows (at stride 2 the two rows that share their
//     outputs) and visits the (at most ceil(k/s)^2) outputs whose windows
//     hold each pixel; where the record names the pixel's slot it adds dy
//     in fp32.  A record's bytes are compared with the pixel's slot four
//     at a time, and dy is loaded only where some channel matched.  dx is
//     written once: no zero fill, no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BAND = 4;  // output rows a forward thread owns where k > s
// Input rows a backward thread owns: S, so that at stride 2 the two rows
// that share their outputs share a thread.
template <int S>
constexpr int ROWS = S;

// `bands`: a thread's rows in an image, counted (forward: output rows by
// BAND, backward: input rows by ROWS<S>).
struct Geometry {
  int n, h, w, c, ho, wo, pad_top, pad_left, bands;
};

// A vector of channels is WORDS 32-bit words (16 bytes), each holding two
// bf16 lanes or one fp32 lane.  The operations below act on every lane of
// a word at once; a mask has all bits of a lane set where its test holds.
constexpr int WORDS = 4;
template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr uint32_t NEG_INF = 0xff80ff80u;
  static constexpr uint32_t ONES = 0x00010001u;  // 1 in every lane
  // The larger lane by lane; NaN where either is NaN.
  static __device__ __forceinline__ uint32_t max_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  // Lanes of a equal to m's, or NaN.
  static __device__ __forceinline__ uint32_t hits(uint32_t a, uint32_t m) {
    uint32_t eq, nan;
    asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(eq) : "r"(a), "r"(m));
    asm("set.neu.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(a));
    return eq | nan;
  }
  // dy's lanes where `mask` is set, added into acc[0..1] in fp32.
  static __device__ __forceinline__ void add(float* acc, uint32_t dy,
                                             uint32_t mask) {
    acc[0] += __uint_as_float((dy & mask) << 16);
    acc[1] += __uint_as_float(dy & mask & 0xffff0000u);
  }
};

template <>
struct Lanes<float> {
  static constexpr uint32_t NEG_INF = 0xff800000u;
  static constexpr uint32_t ONES = 1u;
  static __device__ __forceinline__ uint32_t max_nan(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t hits(uint32_t a, uint32_t m) {
    uint32_t eq, nan;
    asm("set.eq.u32.f32 %0, %1, %2;" : "=r"(eq) : "r"(a), "r"(m));
    asm("set.neu.u32.f32 %0, %1, %1;" : "=r"(nan) : "r"(a));
    return eq | nan;
  }
  static __device__ __forceinline__ void add(float* acc, uint32_t dy,
                                             uint32_t mask) {
    acc[0] += __uint_as_float(dy & mask);
  }
};

// Channels a vector holds: 8 bf16 or 4 fp32.
template <typename T>
constexpr int VEC = WORDS * static_cast<int>(4 / sizeof(T));

__device__ __forceinline__ uint32_t select(uint32_t mask, uint32_t a,
                                           uint32_t b) {
  return (a & mask) | (b & ~mask);
}

template <typename T>
__device__ __forceinline__ void load_words(const T* p,
                                           uint32_t (&w)[WORDS]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  w[0] = u.x;
  w[1] = u.y;
  w[2] = u.z;
  w[3] = u.w;
}

template <typename T>
__device__ __forceinline__ void store_words(T* p, const uint32_t (&w)[WORDS]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The record: one byte a channel, from slot lanes laid out as the values.
template <typename T>
__device__ __forceinline__ void store_slots(uint8_t* p,
                                            const uint32_t (&s)[WORDS]) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(__byte_perm(s[0], s[1], 0x6420),
                                              __byte_perm(s[2], s[3], 0x6420));
  } else {
    *reinterpret_cast<uint32_t*>(p) =
        __byte_perm(__byte_perm(s[0], s[1], 0x0040),
                    __byte_perm(s[2], s[3], 0x0040), 0x5410);
  }
}

// A channel vector's record as loaded: eight bytes (bf16) or four (fp32,
// in .x).
template <typename T>
__device__ __forceinline__ uint2 load_record(const uint8_t* p) {
  if constexpr (sizeof(T) == 2) {
    return *reinterpret_cast<const uint2*>(p);
  } else {
    return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0);
  }
}

// 0x80 in each byte of a record that equals `slot`, else 0; only the
// bytes that were loaded (.y stays 0 for fp32's four).
__device__ __forceinline__ uint32_t hit_word(uint32_t record, uint32_t slot) {
  const uint32_t x = record ^ (slot * 0x01010101u);
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

template <typename T>
__device__ __forceinline__ uint2 hit_bytes(uint2 record, uint32_t slot) {
  return make_uint2(hit_word(record.x, slot),
                    sizeof(T) == 2 ? hit_word(record.y, slot) : 0u);
}

// The lane mask of value word w from a record's hit bytes.
template <typename T>
__device__ __forceinline__ uint32_t word_mask(uint2 hit, int w) {
  if constexpr (sizeof(T) == 2) {
    // Channels 2w and 2w + 1 are bytes (2w) % 4 and (2w) % 4 + 1 of a word.
    const uint32_t b = __byte_perm(w < 2 ? hit.x : hit.y, 0,
                                   w % 2 ? 0x3424 : 0x1404);
    return ((b >> 15) & 0x00010001u) * 0xffffu;
  } else {
    return static_cast<uint32_t>(
        static_cast<int32_t>(hit.x << (24 - 8 * w)) >> 31);
  }
}

// The forward.  Each input row of the band: its maximum over the window's
// in-image columns, then (with the record) the first column that holds
// it, found by walking the columns backwards.  Each output row, once its
// last input row is in: the maximum over its in-image rows, then the first
// row that holds it.  A tap outside the image is read from a clamped
// address and left out, so the body has no branch and the band's loads
// can be issued ahead of the arithmetic.
template <typename T, int K, int S, bool RECORD>
__global__ void __launch_bounds__(THREADS)
max_pool_same_fwd_nhwc(const T* __restrict__ x, T* __restrict__ y,
                       uint8_t* __restrict__ slot, const Geometry g) {
  using L = Lanes<T>;
  constexpr int R = K > S ? BAND : 1;
  constexpr int IN_ROWS = (R - 1) * S + K;
  const unsigned cvs = g.c / VEC<T>;
  const unsigned j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= g.bands * g.wo * cvs) return;
  const int c0 = j % cvs * VEC<T>;
  const int ow = j / cvs % g.wo;
  const int oh0 = j / cvs / g.wo * R;
  const long long n = blockIdx.y;
  const int ih0 = oh0 * S - g.pad_top;
  const int iw0 = ow * S - g.pad_left;
  // The last input row that an output row of this band reads.
  const int last = min(g.h, ih0 + (min(R, g.ho - oh0) - 1) * S + K) - 1;
  const T* xn = x + n * g.h * g.w * g.c + c0;

  uint32_t rmax[IN_ROWS][WORDS], rcol[IN_ROWS][WORDS];
  bool row_in[IN_ROWS];
#pragma unroll
  for (int t = 0; t < IN_ROWS; ++t) {
    const int ih = ih0 + t;
    row_in[t] = ih >= 0 && ih <= last;
    const T* xr = xn + min(max(ih, 0), g.h - 1) * g.w * g.c;
    uint32_t tap[K][WORDS];
    bool in[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int iw = iw0 + c;
      in[c] = iw >= 0 && iw < g.w;
      load_words<T>(xr + min(max(iw, 0), g.w - 1) * g.c, tap[c]);
    }
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      uint32_t m = L::NEG_INF, col = 0;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (in[c]) m = L::max_nan(m, tap[c][w]);
      }
      if constexpr (RECORD) {
#pragma unroll
        for (int c = K - 1; c >= 0; --c) {
          if (in[c]) col = select(L::hits(tap[c][w], m), c * L::ONES, col);
        }
      }
      rmax[t][w] = m;
      rcol[t][w] = col;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t != r * S + K - 1) continue;
      uint32_t out[WORDS], arg[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        uint32_t m = L::NEG_INF, s = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (row_in[r * S + k]) m = L::max_nan(m, rmax[r * S + k][w]);
        }
        if constexpr (RECORD) {
#pragma unroll
          for (int k = K - 1; k >= 0; --k) {
            if (row_in[r * S + k]) {
              s = select(L::hits(rmax[r * S + k][w], m),
                         rcol[r * S + k][w] + k * K * L::ONES, s);
            }
          }
        }
        out[w] = m;
        arg[w] = s;
      }
      if (oh0 + r < g.ho) {
        const long long o =
            n * g.ho * g.wo * g.c + ((oh0 + r) * g.wo + ow) * g.c + c0;
        store_words<T>(y + o, out);
        if constexpr (RECORD) store_slots<T>(slot + o, arg);
      }
    }
  }
}

// The backward.  Each thread owns the same column and channels of ROWS<S>
// input rows.  The records of every output whose window holds one of its
// pixels are loaded first, then dy of those where some channel names the
// pixel, so the loads of each kind are issued together (a record two rows
// share is read again from L1); the sums are fp32.
template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS)
max_pool_same_bwd_nhwc(const T* __restrict__ dy,
                       const uint8_t* __restrict__ slot, T* __restrict__ dx,
                       const Geometry g) {
  using L = Lanes<T>;
  constexpr int PER_WORD = 4 / sizeof(T);  // fp32 sums a word
  // Outputs along a dim whose windows hold one input pixel, at most.
  constexpr int SPAN = (K + S - 1) / S;
  const unsigned cvs = g.c / VEC<T>;
  const unsigned j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= g.bands * g.w * cvs) return;
  const int c0 = j % cvs * VEC<T>;
  const int iw = j / cvs % g.w;
  const int ih0 = j / cvs / g.w * ROWS<S>;
  const long long n = blockIdx.y;
  // Padded coordinates; output oh holds padded rows oh*S .. oh*S + K - 1.
  const int pw = iw + g.pad_left;
  const int ow_lo = pw < K ? 0 : (pw - K) / S + 1;
  const int ow_hi = min(pw / S, g.wo - 1);
  const long long base = n * g.ho * g.wo * g.c + c0;

  int oh_lo[ROWS<S>], oh_hi[ROWS<S>];
  bool valid[ROWS<S>][SPAN][SPAN];
  uint2 rec[ROWS<S>][SPAN][SPAN];
#pragma unroll
  for (int p = 0; p < ROWS<S>; ++p) {
    const int ph = ih0 + p + g.pad_top;
    oh_lo[p] = ph < K ? 0 : (ph - K) / S + 1;
    oh_hi[p] = min(ph / S, g.ho - 1);
#pragma unroll
    for (int a = 0; a < SPAN; ++a) {
#pragma unroll
      for (int b = 0; b < SPAN; ++b) {
        const int oh = oh_lo[p] + a, ow = ow_lo + b;
        valid[p][a][b] = ih0 + p < g.h && oh <= oh_hi[p] && ow <= ow_hi;
        rec[p][a][b] = load_record<T>(
            slot + base + (min(oh, oh_hi[p]) * g.wo + min(ow, ow_hi)) * g.c);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < ROWS<S>; ++p) {
    const int ph = ih0 + p + g.pad_top;
    float acc[WORDS * PER_WORD];
#pragma unroll
    for (int v = 0; v < WORDS * PER_WORD; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int a = 0; a < SPAN; ++a) {
#pragma unroll
      for (int b = 0; b < SPAN; ++b) {
        const int oh = oh_lo[p] + a, ow = ow_lo + b;
        const uint2 hit =
            hit_bytes<T>(rec[p][a][b], (ph - oh * S) * K + (pw - ow * S));
        if (valid[p][a][b] && (hit.x | hit.y)) {
          uint32_t d[WORDS];
          load_words<T>(dy + base + (oh * g.wo + ow) * g.c, d);
#pragma unroll
          for (int w = 0; w < WORDS; ++w) {
            L::add(acc + w * PER_WORD, d[w], word_mask<T>(hit, w));
          }
        }
      }
    }
    uint32_t out[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(acc[2 * w], acc[2 * w + 1]);
        out[w] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        out[w] = __float_as_uint(acc[w]);
      }
    }
    if (ih0 + p < g.h) {
      store_words<T>(
          dx + n * g.h * g.w * g.c + ((ih0 + p) * g.w + iw) * g.c + c0, out);
    }
  }
}

// Grid: blocks over one image's threads in x, images in y, so a thread's
// index math is 32-bit; a batch of more than MAX_GRID_Y images is launched
// in chunks.
constexpr int MAX_GRID_Y = 65535;

dim3 grid_of(unsigned per_image, int images) {
  return dim3((per_image + THREADS - 1) / THREADS, images);
}

template <typename T, int K, int S>
void launch_fwd(const void* x, void* y, void* slot, Geometry g,
                cudaStream_t stream) {
  constexpr int R = K > S ? BAND : 1;
  g.bands = (g.ho + R - 1) / R;
  const long long in_image = static_cast<long long>(g.h) * g.w * g.c;
  const long long out_image = static_cast<long long>(g.ho) * g.wo * g.c;
  for (int n0 = 0; n0 < g.n; n0 += MAX_GRID_Y) {
    const dim3 grid = grid_of(g.bands * g.wo * (g.c / VEC<T>),
                              min(MAX_GRID_Y, g.n - n0));
    const T* xt = static_cast<const T*>(x) + n0 * in_image;
    T* yt = static_cast<T*>(y) + n0 * out_image;
    if (slot != nullptr) {
      max_pool_same_fwd_nhwc<T, K, S, true>
          <<<grid, THREADS, 0, stream>>>(
              xt, yt, static_cast<uint8_t*>(slot) + n0 * out_image, g);
    } else {
      max_pool_same_fwd_nhwc<T, K, S, false>
          <<<grid, THREADS, 0, stream>>>(xt, yt, nullptr, g);
    }
  }
}

template <typename T, int K, int S>
void launch_bwd(const void* dy, const void* slot, void* dx, Geometry g,
                cudaStream_t stream) {
  g.bands = (g.h + ROWS<S> - 1) / ROWS<S>;
  const long long in_image = static_cast<long long>(g.h) * g.w * g.c;
  const long long out_image = static_cast<long long>(g.ho) * g.wo * g.c;
  for (int n0 = 0; n0 < g.n; n0 += MAX_GRID_Y) {
    const dim3 grid =
        grid_of(g.bands * g.w * (g.c / VEC<T>),
                min(MAX_GRID_Y, g.n - n0));
    max_pool_same_bwd_nhwc<T, K, S><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(dy) + n0 * out_image,
        static_cast<const uint8_t*>(slot) + n0 * out_image,
        static_cast<T*>(dx) + n0 * in_image, g);
  }
}

template <typename T>
int pool_fwd(const void* x, void* y, void* slot, int n, int h, int w, int c,
             int ho, int wo, int k, int s, int pad_top, int pad_left,
             void* stream) {
  const Geometry g{n, h, w, c, ho, wo, pad_top, pad_left, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && s == 2) {
    launch_fwd<T, 3, 2>(x, y, slot, g, st);
  } else if (k == 3 && s == 1) {
    launch_fwd<T, 3, 1>(x, y, slot, g, st);
  } else if (k == 2 && s == 2) {
    launch_fwd<T, 2, 2>(x, y, slot, g, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pool_bwd(const void* dy, const void* slot, void* dx, int n, int h, int w,
             int c, int ho, int wo, int k, int s, int pad_top, int pad_left,
             void* stream) {
  const Geometry g{n, h, w, c, ho, wo, pad_top, pad_left, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && s == 2) {
    launch_bwd<T, 3, 2>(dy, slot, dx, g, st);
  } else if (k == 3 && s == 1) {
    launch_bwd<T, 3, 1>(dy, slot, dx, g, st);
  } else if (k == 2 && s == 2) {
    launch_bwd<T, 2, 2>(dy, slot, dx, g, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, c) NHWC -> y (n, ho, wo, c) NHWC, contiguous, in x's type; a
// k x k window at stride s over x padded by pad_top / pad_left before
// (and by whatever ho, wo imply after).  `slot` (n, ho, wo, c) uint8, or
// null for no record.  (k, s) in {(3, 2), (3, 1), (2, 2)}, 0 <= pad < k;
// c a multiple of 16 bytes' channels (8 bf16, 4 fp32) and every pointer
// 16-byte aligned (the caller checks both).
extern "C" int max_pool_same_fwd_bf16(const void* x, void* y, void* slot,
                                      int n, int h, int w, int c, int ho,
                                      int wo, int k, int s, int pad_top,
                                      int pad_left, void* stream) {
  return pool_fwd<__nv_bfloat16>(x, y, slot, n, h, w, c, ho, wo, k, s,
                                 pad_top, pad_left, stream);
}

extern "C" int max_pool_same_fwd_f32(const void* x, void* y, void* slot,
                                     int n, int h, int w, int c, int ho,
                                     int wo, int k, int s, int pad_top,
                                     int pad_left, void* stream) {
  return pool_fwd<float>(x, y, slot, n, h, w, c, ho, wo, k, s, pad_top,
                         pad_left, stream);
}

// dy and slot (n, ho, wo, c) NHWC -> dx (n, h, w, c) NHWC, the same
// geometry as the forward that wrote `slot`.
extern "C" int max_pool_same_bwd_bf16(const void* dy, const void* slot,
                                      void* dx, int n, int h, int w, int c,
                                      int ho, int wo, int k, int s,
                                      int pad_top, int pad_left,
                                      void* stream) {
  return pool_bwd<__nv_bfloat16>(dy, slot, dx, n, h, w, c, ho, wo, k, s,
                                 pad_top, pad_left, stream);
}

extern "C" int max_pool_same_bwd_f32(const void* dy, const void* slot,
                                     void* dx, int n, int h, int w, int c,
                                     int ho, int wo, int k, int s,
                                     int pad_top, int pad_left,
                                     void* stream) {
  return pool_bwd<float>(dy, slot, dx, n, h, w, c, ho, wo, k, s, pad_top,
                         pad_left, stream);
}
