// Inception-v1 stem convolution, Conv2d_1a_7x7: 7x7, stride 2, 3 -> 64
// channels, TF-'SAME' padding, no bias, with an optional per-channel
// epilogue out = relu(acc * scale[c] + shift[c]) rounded once (eval-mode
// BatchNorm and the ReLU that follows it).  Two kernels:
//   * stem_conv7x7s2_bf16: an implicit GEMM on the tensor cores, bf16 NHWC
//     in, fp32 accumulation, bf16 NHWC out (the bf16 configs);
//   * stem_conv7x7s2_f32: an implicit GEMM on the tensor cores in 3xTF32,
//     fp32 NHWC in, fp32 accuracy, fp32 NHWC out (the fp32 configs, e.g.
//     mn10_single_view); described before its code below.
//
// Replaces the TPU kernel gvcnn_tf_tpu/ops/pallas_stem.py::_stem_fwd
// (_stem_kernel + _pack_weights).  That kernel built the im2col matrix in
// VMEM and packed two output rows into one 128-lane MXU product; the
// packing was shaped for the MXU and is not carried over.  The fact it
// rested on is: for a fixed kernel row kh, the 21 taps (kw, c) of output
// pixel p are 21 consecutive bf16 of the padded NHWC input row, starting
// at element 6p.
//
// The bf16 kernel.  What bounds it on the H100: bytes.  At N = 96, 224x224 the input is
// 28.9 MB and the output 154.1 MB; at 3.35 TB/s that is 54.6 us.  The
// 22.7 GFLOP (K = 147) take 22.9 us at the bf16 tensor-core peak.
//
// Design.  GEMM with M = output pixels, N = 64 channels and K laid out as
// kh * 24 + m, m = 3 * kw + c; rows m = 21..23 of every kernel row and
// k = 168..175 carry zero weights, so K = 176 is 11 mma.m16n8k16 k-steps
// and every 8-wide k block lies in one kernel row.  The A fragments are
// read with 32-bit loads straight from the staged input rows (no im2col
// buffer): the extra taps read a neighbouring pixel's values times zero
// weights, so every staged byte, the pads included, is written.
//   * Persistent grid, one block of 7 warps per SM, walking (image, band
//     of BAND output rows) tiles; the packed (176, 64) weight is staged
//     once per block in shared memory, already in B-fragment order.
//   * A band needs 2 * BAND + 5 input rows.  They are staged with 16-byte
//     cp.async into a double-buffered ring, so the next tile's rows arrive
//     while this tile's MMAs run.  A row whose global address is not
//     16-byte aligned (W % 8 != 0) takes a 2-byte copy path instead.
//   * Each warp owns groups of 64 consecutive output pixels of the band
//     (4 m-tiles x 8 n-tiles = 128 fp32 accumulators a thread).  The
//     epilogue applies scale / shift / ReLU in registers, converts to bf16,
//     stages the group in a swizzled 8 KB slice of shared memory and
//     writes it as one contiguous 16-byte-vectorized span (the band's
//     output rows are contiguous in NHWC).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUT = 64;
constexpr int KSTEPS = 11;                  // K = 176 = 11 x 16
constexpr int WARPS = 7;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 4;                       // m16 tiles per warp group
constexpr int GROUP = MT * 16;              // output pixels per warp group
constexpr int BAND = 4;                     // output rows per tile (max)
constexpr int LEAD = 4;                     // bytes before padded column 0
constexpr int MAX_DEVICES = 64;

// Shared memory: B fragments | output staging | scale, shift | input ring.
constexpr int WFRAG_BYTES = KSTEPS * 4 * 32 * 16;          // 22,528
constexpr int OSTAGE_BYTES = WARPS * GROUP * COUT * 2;     // 57,344
constexpr int AFFINE_BYTES = 2 * 32 * 8;                   // 512
constexpr int FIXED_BYTES = WFRAG_BYTES + OSTAGE_BYTES + AFFINE_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Shape {
  int h, w, ho, wo, pad_top, pad_left, band, bands, rowb, in_rows;
};

// Stage the 2 * band + 5 input rows of `tile` into `buf`, zero padded:
// byte LEAD + 2 f of a staged row holds element f of the padded row
// (padded column f / 3, channel f % 3); rows outside the image are zeros.
__device__ __forceinline__ void stage_rows(const unsigned char* __restrict__ x,
                                           unsigned char* buf, int tile,
                                           const Shape& s, bool aligned) {
  const int img = tile / s.bands;
  const int iy0 = (tile - img * s.bands) * s.band * 2 - s.pad_top;
  const long long row_bytes = 6LL * s.w;
  const unsigned char* xi = x + img * (row_bytes * s.h);
  if (aligned) {
    // pad_left == 2, so the data starts at byte LEAD + 12 = 16 and every
    // 16-byte chunk is all data or all zeros.
    const int chunks = s.rowb >> 4;
    const int data_end = 16 + 6 * s.w;
    for (int e = threadIdx.x; e < s.in_rows * chunks; e += THREADS) {
      const int i = e / chunks;
      const int off = (e - i * chunks) << 4;
      const int iy = iy0 + i;
      unsigned char* dst = buf + i * s.rowb + off;
      if (iy >= 0 && iy < s.h && off >= 16 && off < data_end) {
        cp_async16(dst, xi + iy * row_bytes + (off - 16));
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    const int halves = s.rowb >> 1;
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xi);
    for (int e = threadIdx.x; e < s.in_rows * halves; e += THREADS) {
      const int i = e / halves;
      const int k = e - i * halves;
      const int iy = iy0 + i;
      const int f = k - LEAD / 2;
      unsigned short v = 0;
      if (iy >= 0 && iy < s.h && f >= 0) {
        const int ic = f / 3 - s.pad_left;
        if (ic >= 0 && ic < s.w) {
          v = xs[(static_cast<long long>(iy) * s.w + ic) * 3 + f % 3];
        }
      }
      reinterpret_cast<unsigned short*>(buf + i * s.rowb)[k] = v;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out, int n_img, Shape s,
                     int aligned, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wfrag = reinterpret_cast<uint4*>(smem);
  unsigned char* ostage = smem + WFRAG_BYTES;
  float2* scale2 = reinterpret_cast<float2*>(ostage + OSTAGE_BYTES);
  float2* shift2 = scale2 + 32;
  unsigned char* ring = smem + FIXED_BYTES;
  const int ring_bytes = s.in_rows * s.rowb;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;     // fragment row / column group
  const int tig = lane & 3;      // thread in group
  const int tiles = n_img * s.bands;

  int tile = blockIdx.x;
  if (tile < tiles) {
    stage_rows(reinterpret_cast<const unsigned char*>(x), ring, tile, s,
               aligned);
  }
  cp_async_commit();

  // B fragments of mma.m16n8k16 (k x n, "col"): for k-step st and n-tile j
  // the thread holds {W[k][n], W[k + 1][n]} and {W[k + 8][n], W[k + 9][n]}
  // with k = 16 st + 2 tig, n = 8 j + gid.  Entry (st, jp, lane) is a
  // uint4 holding n-tiles 2 jp and 2 jp + 1, read with one 16-byte load.
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  for (int e = tid; e < KSTEPS * 4 * 32; e += THREADS) {
    const int l = e & 31, jp = (e >> 5) & 3, st = e >> 7;
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * st + 2 * (l & 3) + 8 * (q & 1);
      const int nn = 8 * (2 * jp + (q >> 1)) + (l >> 2);
      r[q] = static_cast<uint32_t>(wu[k * COUT + nn]) |
             (static_cast<uint32_t>(wu[(k + 1) * COUT + nn]) << 16);
    }
    wfrag[e] = make_uint4(r[0], r[1], r[2], r[3]);
  }
  if (tid < 32) {
    scale2[tid] = scale ? make_float2(scale[2 * tid], scale[2 * tid + 1])
                        : make_float2(1.0f, 1.0f);
    shift2[tid] = shift ? make_float2(shift[2 * tid], shift[2 * tid + 1])
                        : make_float2(0.0f, 0.0f);
  }

  unsigned char* my_stage = ostage + warp * (GROUP * COUT * 2);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const unsigned char* cur = ring + (it & 1) * ring_bytes;
    const int next = tile + gridDim.x;
    if (next < tiles) {
      stage_rows(reinterpret_cast<const unsigned char*>(x),
                 ring + ((it + 1) & 1) * ring_bytes, next, s, aligned);
    }
    cp_async_commit();
    cp_async_wait<1>();          // this tile's rows have landed
    __syncthreads();

    const int img = tile / s.bands;
    const int oy0 = (tile - img * s.bands) * s.band;
    const int npix = min(s.band, s.ho - oy0) * s.wo;
    __nv_bfloat16* out_band =
        out + (static_cast<long long>(img) * s.ho + oy0) * s.wo * COUT;

    for (int g0 = warp * GROUP; g0 < npix; g0 += WARPS * GROUP) {
      // Byte offset in `cur` of tap (kh = 0, m = 2 tig) of the two pixels
      // (rows gid, gid + 8) of each m-tile; a pixel past the band reads
      // pixel 0 and is not stored.
      int abase[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int q = g0 + mi * 16 + hh * 8 + gid;
          q = q < npix ? q : 0;
          const int r = q / s.wo;
          abase[mi][hh] = 2 * r * s.rowb + LEAD + 12 * (q - r * s.wo) + 4 * tig;
        }
      }

      float acc[MT][8][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;

#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        // A: register 2 kq + hh holds k = 16 st + 8 kq + 2 tig (+1) of
        // pixel row gid + 8 hh.  The 8-wide k block 2 st + kq is kernel row
        // blk / 3, taps 8 (blk % 3) ..; block 21 is the zero tail.
        uint32_t a[MT][4];
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int blk = 2 * st + kq;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              a[mi][2 * kq + hh] =
                  blk < 21 ? *reinterpret_cast<const uint32_t*>(
                                 cur + abase[mi][hh] + (blk / 3) * s.rowb +
                                 16 * (blk % 3))
                           : 0u;
            }
          }
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const uint4 b = wfrag[(st * 4 + jp) * 32 + lane];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(acc[mi][2 * jp], a[mi], b.x, b.y);
            mma_bf16(acc[mi][2 * jp + 1], a[mi], b.z, b.w);
          }
        }
      }

      // Epilogue in registers.  Accumulator (mi, j) holds channels
      // 8 j + 2 tig (+1) of pixels gid and gid + 8 of m-tile mi.  A staged
      // pixel row is 128 bytes; its 16-byte chunk j sits at j ^ (pixel & 7)
      // so the 8 pixel rows a store touches fall in different banks.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = scale2[4 * j + tig];
        const float2 sh = shift2[4 * j + tig];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float v[4] = {fmaf(acc[mi][j][0], sc.x, sh.x),
                        fmaf(acc[mi][j][1], sc.y, sh.y),
                        fmaf(acc[mi][j][2], sc.x, sh.x),
                        fmaf(acc[mi][j][3], sc.y, sh.y)};
          if (relu) {
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], 0.0f);
          }
          const int pl = mi * 16 + gid;          // pl & 7 == gid
          const int col = ((j ^ gid) << 4) + 4 * tig;
          *reinterpret_cast<uint32_t*>(my_stage + pl * 128 + col) =
              pack_bf16x2(v[0], v[1]);
          *reinterpret_cast<uint32_t*>(my_stage + (pl + 8) * 128 + col) =
              pack_bf16x2(v[2], v[3]);
        }
      }
      __syncwarp();
      const int nvalid = min(GROUP, npix - g0);
      uint4* dst = reinterpret_cast<uint4*>(out_band +
                                            static_cast<long long>(g0) * COUT);
      for (int c = lane; c < nvalid * 8; c += 32) {
        const int pl = c >> 3, lc = c & 7;
        dst[c] = *reinterpret_cast<const uint4*>(my_stage + pl * 128 +
                                                 ((lc ^ (pl & 7)) << 4));
      }
      __syncwarp();
    }
    __syncthreads();             // everyone is done with `cur`
  }
  cp_async_wait<0>();
}

// The fp32 kernel.  What bounds it on the H100: operations.  At N = 8,
// 224x224 (mn10_single_view's B = 8) the conv is 1.89 GFLOP (147
// multiply-adds per output); it runs as three TF32 products, 5.67 GFLOP,
// 11.4 us at the 495 TFLOP/s TF32 tensor-core peak, against 4.82 MB in and
// 25.69 MB out, 9.1 us at 3.35 TB/s.  (On the CUDA cores the same work is
// 1.89 GFLOP at 67 TFLOP/s: 28.2 us.)
//
// Why 3xTF32.  A TF32 operand keeps 10 of fp32's 23 mantissa bits, and one
// TF32 product misses the fp32 configs' bound of 1e-5 x max|ref| by an
// order of magnitude (about 3e-4 x max|ref|).  Each operand v is split
// into big = rna(v) and small = rna(v - big) (rna: round to nearest TF32,
// ties away, the `cvt.rna.tf32.f32` below; v - big is exact in fp32), and
// small_a big_b + big_a small_b + big_a big_b, the small terms first, is
// accumulated in fp32: that keeps 21-22 bits of each operand and errs like
// an fp32 conv (tests/test_torch_stem.py emulates it against the fp32 XLA
// conv).  The tensor core ignores an operand's low 13 bits, so raw fp32
// would be truncated, not rounded, and big + small would not be v.
//
// Design.  GEMM with M = output pixels, N = 64 channels and K = 7 x 24 =
// 168, k = kh * 24 + m, m = 3 * kw + c; m = 21..23 carry zero weights, so
// K is 21 k-steps of mma.m16n8k8 (tf32) and every 8-wide k block lies in
// one kernel row.  As in the bf16 kernel, the taps (kw, c) of output pixel
// p for a kernel row are consecutive floats of the padded NHWC input row
// from element 6 p, so the A fragments are read straight from the staged
// rows (no im2col buffer); the extra taps read a neighbour's values times
// zero weights.
//   * Persistent grid, one block of 8 warps per SM, walking (image, band of
//     `band` output rows, strip of `sw` output columns) tiles.  The packed
//     (168, 64) weight is split once per block into big and small B
//     fragments in shared memory (2 x 43,008 bytes).  The launcher picks
//     the band that fills the card best for this N and H (at N = 8,
//     224x224: 7 rows, 128 tiles, one a block); strips only cut rows wider
//     than 128 outputs, which would not fit in shared memory.
//   * A tile needs 2 band + 5 input rows.  They are staged with 16-byte
//     cp.async into a double-buffered ring, so the next tile's rows arrive
//     while this tile's MMAs run; rows whose global address is not 16-byte
//     aligned (W % 4 != 0) take a 4-byte cp.async path.
//   * Each warp owns a contiguous share of the tile's m16 tiles (6 or 7 at
//     224x224) and runs them in chunks of up to 4 (4 m-tiles x 8 n-tiles =
//     128 fp32 accumulators a thread): per k-step it loads and splits its A
//     values once (one split serves 8 n-tiles x 3 MMAs) and reads each B
//     fragment pair once for the chunk's m-tiles.  The chunk's m-tile count
//     is a template argument: a predicated-off mma.sync costs what an
//     executed one does, so a short chunk must not issue 4 m-tiles' MMAs.
//     The short chunk runs last in the first half of the warps and first in
//     the second half, so the two warps of a sub-partition store at
//     different times and one computes while the other stores.
//   * `measure.py stem-probe` times variants of this file (one product
//     only, no MMAs, other bands) to show where the time goes; PERF.md
//     keeps its readings.
//   * Bank conflicts: neighbouring pixels start 6 words apart, so 8
//     consecutive pixels' fragment loads (words 6 p + tig) collide two by
//     two.  Fragment row r of an m-tile holds pixel 2 r (r < 8) or 2 (r - 8)
//     + 1 instead, so one load reads words 12 g + tig (+ 6): 32 distinct
//     banks wherever the m-tile lies in one output row (always when the
//     strip width is a multiple of 16, as at 224x224).
//   * The epilogue applies scale / shift / ReLU to the accumulators and
//     stores float2 straight from them: each warp store writes whole
//     32-byte sectors (4 lanes cover channels 8 j .. 8 j + 7 of a pixel).
constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_KSTEPS = 21;                 // K = 168 = 21 x 8
constexpr int F_MT = 4;                      // m16 tiles a chunk (max)
constexpr int F_LEAD = 2;                    // words before padded element 0
constexpr int F_MAX_BAND = 16;
constexpr int F_MAX_STRIP = 128;             // output columns a strip (max)
// Shared memory: big B fragments | small B fragments | scale, shift | ring.
constexpr int F_WFRAG_BYTES = F_KSTEPS * 4 * 32 * 16;      // 43,008
constexpr int F_FIXED_BYTES = 2 * F_WFRAG_BYTES + AFFINE_BYTES;

struct ShapeF32 {
  int h, w, ho, wo, pad_top, pad_left, band, bands, sw, strips, rsw, in_rows;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// v rounded to the nearest TF32 (ties away from zero), low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TileF32 {
  int img, oy0, sx0, nc, npix;
};

__device__ __forceinline__ TileF32 tile_f32(int tile, const ShapeF32& s) {
  TileF32 t;
  const int per_img = s.bands * s.strips;
  t.img = tile / per_img;
  const int rem = tile - t.img * per_img;
  const int bi = rem / s.strips;
  t.oy0 = bi * s.band;
  t.sx0 = (rem - bi * s.strips) * s.sw;
  t.nc = min(s.sw, s.wo - t.sx0);
  t.npix = min(s.band, s.ho - t.oy0) * t.nc;
  return t;
}

// Stage the 2 band + 5 input rows of `tile` into `buf`, zero padded: word
// F_LEAD + f of a staged row holds element f of the strip's padded row
// (padded column 2 sx0 + f / 3, channel f % 3), which is element
// 3 (2 sx0 - pad_left) + f of the input row; rows outside the image are
// zeros.
__device__ __forceinline__ void stage_rows_f32(const float* __restrict__ x,
                                               float* buf, int tile,
                                               const ShapeF32& s,
                                               bool aligned) {
  const TileF32 t = tile_f32(tile, s);
  const int iy0 = t.oy0 * 2 - s.pad_top;
  const long long row_elems = 3LL * s.w;
  const float* xi = x + t.img * (row_elems * s.h);
  const int e0 = 3 * (2 * t.sx0 - s.pad_left) - F_LEAD;   // word 0
  if (aligned) {
    // pad_left == 2 and sx0 even, so e0 % 4 == 0, and 3 W % 4 == 0: every
    // 16-byte chunk is all data or all zeros.
    const int chunks = s.rsw >> 2;
    for (int i = threadIdx.x; i < s.in_rows * chunks; i += F_THREADS) {
      const int r = i / chunks;
      const int wd = (i - r * chunks) << 2;
      const int iy = iy0 + r;
      const int e = e0 + wd;
      float* dst = buf + r * s.rsw + wd;
      if (iy >= 0 && iy < s.h && e >= 0 && e < row_elems) {
        cp_async16(dst, xi + iy * row_elems + e);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < s.in_rows * s.rsw; i += F_THREADS) {
      const int r = i / s.rsw;
      const int wd = i - r * s.rsw;
      const int iy = iy0 + r;
      const int e = e0 + wd;
      float* dst = buf + i;
      if (iy >= 0 && iy < s.h && e >= 0 && e < row_elems) {
        cp_async4(dst, xi + iy * row_elems + e);
      } else {
        *dst = 0.f;
      }
    }
  }
}

// One chunk of a warp's share: m16 tiles c .. c + CNT - 1 of tile t, all 64
// channels.  CNT is a template argument so that a short chunk issues only
// its own MMAs (a predicated-off mma.sync still takes its turn).
template <int CNT>
__device__ __forceinline__ void f32_chunk(const float* cur, const uint4* wbig,
                                          const uint4* wsmall,
                                          const float2* scale2,
                                          const float2* shift2,
                                          float* __restrict__ out,
                                          const ShapeF32& s, const TileF32& t,
                                          int c, int relu) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;     // fragment row / column group
  const int tig = lane & 3;      // thread in group
  // Word offset in a staged row pair of tap (kh = 0, m = tig) of the
  // pixels of fragment rows gid (pixel 2 gid of the m-tile) and gid + 8
  // (pixel 2 gid + 1); a pixel past the tile reads pixel 0 and is not
  // stored.
  int abase[CNT][2];
#pragma unroll
  for (int mi = 0; mi < CNT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int q = 16 * (c + mi) + 2 * gid + hh;
      q = q < t.npix ? q : 0;
      const int r = q / t.nc;
      abase[mi][hh] = 2 * r * s.rsw + F_LEAD + 6 * (q - r * t.nc) + tig;
    }
  }

  float acc[CNT][8][4];
#pragma unroll
  for (int mi = 0; mi < CNT; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;

#pragma unroll 1
  for (int kh = 0; kh < 7; ++kh) {
    const float* arow = cur + kh * s.rsw;
    const uint4* bbig = wbig + kh * 3 * 128 + lane;
    const uint4* bsmall = wsmall + kh * 3 * 128 + lane;
#pragma unroll
    for (int sub = 0; sub < 3; ++sub) {
      // A: register hh + 2 kq holds tap m = 8 sub + 4 kq + tig of the
      // pixel of fragment row gid + 8 hh, split into big and small.
      uint32_t ab[CNT][4], as[CNT][4];
#pragma unroll
      for (int mi = 0; mi < CNT; ++mi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_tf32(arow[abase[mi][r & 1] + 8 * sub + 4 * (r >> 1)],
                     ab[mi][r], as[mi][r]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const uint4 bb = bbig[(sub * 4 + jp) * 32];
        const uint4 bs = bsmall[(sub * 4 + jp) * 32];
#pragma unroll
        for (int mi = 0; mi < CNT; ++mi) {
          mma_tf32(acc[mi][2 * jp], as[mi], bb.x, bb.y);
          mma_tf32(acc[mi][2 * jp + 1], as[mi], bb.z, bb.w);
        }
#pragma unroll
        for (int mi = 0; mi < CNT; ++mi) {
          mma_tf32(acc[mi][2 * jp], ab[mi], bs.x, bs.y);
          mma_tf32(acc[mi][2 * jp + 1], ab[mi], bs.z, bs.w);
        }
#pragma unroll
        for (int mi = 0; mi < CNT; ++mi) {
          mma_tf32(acc[mi][2 * jp], ab[mi], bb.x, bb.y);
          mma_tf32(acc[mi][2 * jp + 1], ab[mi], bb.z, bb.w);
        }
      }
    }
  }

  // Epilogue.  Accumulator (mi, j) holds channels 8 j + 2 tig (+1) of
  // the pixels of fragment rows gid (registers 0, 1) and gid + 8 (2, 3).
#pragma unroll
  for (int mi = 0; mi < CNT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = 16 * (c + mi) + 2 * gid + hh;
      if (q >= t.npix) continue;
      const int r = q / t.nc;
      float* dst = out + ((static_cast<long long>(t.img) * s.ho + t.oy0 +
                           r) * s.wo + t.sx0 + (q - r * t.nc)) * COUT +
                   2 * tig;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = scale2[4 * j + tig];
        const float2 sh = shift2[4 * j + tig];
        float2 v = make_float2(fmaf(acc[mi][j][2 * hh], sc.x, sh.x),
                               fmaf(acc[mi][j][2 * hh + 1], sc.y, sh.y));
        if (relu) {
          v.x = fmaxf(v.x, 0.0f);
          v.y = fmaxf(v.y, 0.0f);
        }
        *reinterpret_cast<float2*>(dst + 8 * j) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
stem_conv_f32_mma_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int n_img, ShapeF32 s,
                         int aligned, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wbig = reinterpret_cast<uint4*>(smem);
  uint4* wsmall = wbig + F_KSTEPS * 4 * 32;
  float2* scale2 = reinterpret_cast<float2*>(smem + 2 * F_WFRAG_BYTES);
  float2* shift2 = scale2 + 32;
  float* ring = reinterpret_cast<float*>(smem + F_FIXED_BYTES);
  const int ring_words = s.in_rows * s.rsw;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tiles = n_img * s.bands * s.strips;

  int tile = blockIdx.x;
  if (tile < tiles) stage_rows_f32(x, ring, tile, s, aligned);
  cp_async_commit();

  // B fragments of mma.m16n8k8 (k x n, "col"): for k-step ks and n-tile j
  // the thread holds W[k][n] and W[k + 4][n], k = 8 ks + tig, n = 8 j +
  // gid.  Entry (ks, jp, lane) is a uint4 holding n-tiles 2 jp and 2 jp + 1,
  // read with one 16-byte load; `wbig` holds the big parts, `wsmall` the
  // small ones.
  for (int e = tid; e < F_KSTEPS * 4 * 32; e += F_THREADS) {
    const int l = e & 31, jp = (e >> 5) & 3, ks = e >> 7;
    uint32_t big[4], small[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 8 * ks + (l & 3) + 4 * (q & 1);
      const int nn = 8 * (2 * jp + (q >> 1)) + (l >> 2);
      split_tf32(w[k * COUT + nn], big[q], small[q]);
    }
    wbig[e] = make_uint4(big[0], big[1], big[2], big[3]);
    wsmall[e] = make_uint4(small[0], small[1], small[2], small[3]);
  }
  if (tid < 32) {
    scale2[tid] = scale ? make_float2(scale[2 * tid], scale[2 * tid + 1])
                        : make_float2(1.0f, 1.0f);
    shift2[tid] = shift ? make_float2(shift[2 * tid], shift[2 * tid + 1])
                        : make_float2(0.0f, 0.0f);
  }

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const float* cur = ring + (it & 1) * ring_words;
    const int next = tile + gridDim.x;
    if (next < tiles) {
      stage_rows_f32(x, ring + ((it + 1) & 1) * ring_words, next, s,
                     aligned);
    }
    cp_async_commit();
    cp_async_wait<1>();          // this tile's rows have landed
    __syncthreads();

    // The warp's share: m16 tiles [c, t1), in chunks of F_MT and one
    // shorter chunk, which the first half of the warps runs last and the
    // second half first, so that the two warps of a sub-partition store
    // their results at different times.
    const TileF32 t = tile_f32(tile, s);
    const int mtiles = (t.npix + 15) >> 4;
    const int t1 = (warp + 1) * mtiles / F_WARPS;
    int c = warp * mtiles / F_WARPS;
    int cnt = (t1 - c) % F_MT;
    if (cnt == 0 || warp < F_WARPS / 2) cnt = min(F_MT, t1 - c);
    for (; c < t1; c += cnt, cnt = min(F_MT, t1 - c)) {
      switch (cnt) {
        case 4:
          f32_chunk<4>(cur, wbig, wsmall, scale2, shift2, out, s, t, c, relu);
          break;
        case 3:
          f32_chunk<3>(cur, wbig, wsmall, scale2, shift2, out, s, t, c, relu);
          break;
        case 2:
          f32_chunk<2>(cur, wbig, wsmall, scale2, shift2, out, s, t, c, relu);
          break;
        default:
          f32_chunk<1>(cur, wbig, wsmall, scale2, shift2, out, s, t, c, relu);
      }
    }
    __syncthreads();             // everyone is done with `cur`
  }
  cp_async_wait<0>();
}

int g_sms[MAX_DEVICES];
int g_max_smem[MAX_DEVICES];

// The current device in `dev`; the first call on a device reads its SM
// count and shared memory and lets both kernels use all of it.
cudaError_t init_device(int& dev) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_sms[dev] != 0) return cudaSuccess;
  cudaDeviceGetAttribute(&g_max_smem[dev],
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (const void* kernel :
       {reinterpret_cast<const void*>(stem_conv_mma_kernel),
        reinterpret_cast<const void*>(stem_conv_f32_mma_kernel)}) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_max_smem[dev]);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  g_sms[dev] = sms;
  return cudaSuccess;
}

}  // namespace

// x: (n, h, w, 3) bf16, contiguous.  w: (176, 64) bf16, row kh * 24 + 3 kw
// + c, zero rows kh * 24 + 21..23 and 168..175 (pack_stem_weight).
// scale, shift: 64 fp32 each, or both null for no affine.  out: (n, ho, wo,
// 64) bf16, contiguous, 16-byte aligned.  pad_left is 2 or 3 (TF-'SAME').
extern "C" int stem_conv7x7s2_bf16(const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   void* out, int n, int h, int wdt, int ho,
                                   int wo, int pad_top, int pad_left, int relu,
                                   void* stream) {
  int dev = 0;
  const cudaError_t err = init_device(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape s;
  s.h = h;
  s.w = wdt;
  s.ho = ho;
  s.wo = wo;
  s.pad_top = pad_top;
  s.pad_left = pad_left;
  // Bytes of a staged row: up to padded element 6 (wo - 1) + 23, rounded
  // to 16.
  s.rowb = (LEAD + 2 * (6 * wo + 18) + 15) & ~15;
  s.band = BAND;
  while (s.band > 1 &&
         FIXED_BYTES + 2 * (2 * s.band + 5) * s.rowb > g_max_smem[dev]) {
    --s.band;
  }
  s.in_rows = 2 * s.band + 5;
  const int smem = FIXED_BYTES + 2 * s.in_rows * s.rowb;
  if (smem > g_max_smem[dev]) return static_cast<int>(cudaErrorInvalidValue);
  s.bands = (ho + s.band - 1) / s.band;
  const int tiles = n * s.bands;
  const int aligned =
      wdt % 8 == 0 && pad_left == 2 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int grid = tiles < g_sms[dev] ? tiles : g_sms[dev];
  stem_conv_mma_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), n,
      s, aligned, relu);
  return static_cast<int>(cudaGetLastError());
}

// x: (n, h, w, 3) fp32, contiguous.  w: (168, 64) fp32, row kh * 24 + 3 kw
// + c, zero rows kh * 24 + 21..23 (pack_stem_weight_f32).  scale, shift: 64
// fp32 each, or both null for no affine.  out: (n, ho, wo, 64) fp32,
// contiguous, 8-byte aligned.  pad_left is 2 or 3 (TF-'SAME').
extern "C" int stem_conv7x7s2_f32(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* out, int n, int h, int wdt, int ho,
                                  int wo, int pad_top, int pad_left, int relu,
                                  void* stream) {
  int dev = 0;
  const cudaError_t err = init_device(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = g_sms[dev];
  ShapeF32 s;
  s.h = h;
  s.w = wdt;
  s.ho = ho;
  s.wo = wo;
  s.pad_top = pad_top;
  s.pad_left = pad_left;
  // Strips of equal width, even where there are several (16-byte staging).
  s.strips = (wo + F_MAX_STRIP - 1) / F_MAX_STRIP;
  s.sw = (wo + s.strips - 1) / s.strips;
  if (s.strips > 1) {
    s.sw += s.sw & 1;
    s.strips = (wo + s.sw - 1) / s.sw;
  }
  // Words of a staged row: up to padded element 6 (sw - 1) + 23, rounded
  // to 4 (16 bytes).
  s.rsw = (F_LEAD + 6 * s.sw + 18 + 3) & ~3;
  // The band with the least estimated time: waves of tiles over the SMs,
  // times the m16 tiles of the busiest warp plus one a chunk for its loads
  // and splits (a tie keeps the smaller band, whose staging waits less).
  s.band = 0;
  long long best = 0;
  for (int band = 1; band <= F_MAX_BAND; ++band) {
    if (F_FIXED_BYTES + 2 * (2 * band + 5) * s.rsw * 4 > g_max_smem[dev]) {
      break;
    }
    const long long tiles =
        static_cast<long long>(n) * ((ho + band - 1) / band) * s.strips;
    const int share = ((band * s.sw + 15) / 16 + F_WARPS - 1) / F_WARPS;
    const long long cost =
        (tiles + sms - 1) / sms * (share + (share + F_MT - 1) / F_MT);
    if (s.band == 0 || cost < best) {
      s.band = band;
      best = cost;
    }
  }
  if (s.band == 0) return static_cast<int>(cudaErrorInvalidValue);
  s.in_rows = 2 * s.band + 5;
  s.bands = (ho + s.band - 1) / s.band;
  const long long tiles = static_cast<long long>(n) * s.bands * s.strips;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = F_FIXED_BYTES + 2 * s.in_rows * s.rsw * 4;
  const int aligned =
      wdt % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  stem_conv_f32_mma_kernel<<<grid, F_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), n, s, aligned, relu);
  return static_cast<int>(cudaGetLastError());
}
