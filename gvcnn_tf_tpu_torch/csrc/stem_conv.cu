// Inception-v1 stem convolution, Conv2d_1a_7x7: 7x7, stride 2, 3 -> 64
// channels, TF-'SAME' padding, no bias, with an optional per-channel
// epilogue out = relu(acc * scale[c] + shift[c]) rounded once (eval-mode
// BatchNorm and the ReLU that follows it).  Two kernels:
//   * stem_conv7x7s2_bf16: an implicit GEMM on the tensor cores, bf16 NHWC
//     in, fp32 accumulation, bf16 NHWC out (the bf16 configs);
//   * stem_conv7x7s2_f32: a direct conv on the CUDA cores, fp32 NHWC in,
//     fp32 FMAs, fp32 NHWC out, no TF32 rounding of the inputs (the fp32
//     configs, e.g. mn10_single_view); described before its code below.
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
// 224x224 (mn10_single_view's B = 8) it does 1.89 GFLOP (147 multiply-adds
// per output), 28.2 us at the 67 TFLOP/s fp32 peak, against 30.5 MB of
// input and output, 9.1 us at 3.35 TB/s.  Tensor cores would take the
// inputs in TF32 (10-bit mantissa); fp32 configs keep fp32 numerics, so the
// multiply-adds run on the CUDA cores.
//
// Design (the direct conv the bf16 path first shipped with, in fp32): one
// block of 4 warps per (image, strip of F_TILE_W output columns, F_ROWS
// output rows).  The block stages the (147, 64) weight matrix in shared
// memory once, then for each output row the 7 input rows of its strip,
// zero padded and split by column parity, so that the 32 lanes of a warp
// read 32 consecutive words for every tap (no bank conflicts).  Warp w
// computes channels [16 w, 16 w + 16) of two output pixels a lane (lane,
// lane + 32); the 16 weights of a tap are a broadcast read shared by the
// warp.  The epilogue applies scale / shift / ReLU to the accumulators and
// writes each pixel's 16 channels as four 16-byte stores.
constexpr int F_TAPS = 7 * 7 * 3;                        // 147
constexpr int F_TILE_W = 64;                             // output columns
constexpr int F_ROWS = 2;                                // output rows
constexpr int F_THREADS = 128;                           // 4 warps
constexpr int F_CH = COUT / (F_THREADS / 32);            // 16 a warp
constexpr int F_IN_COLS = (F_TILE_W - 1) * 2 + 7;        // 133
constexpr int F_HALF_COLS = (F_IN_COLS + 1) / 2;         // 67 a parity

__global__ void __launch_bounds__(F_THREADS)
stem_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int h, int wdt, int ho, int wo, int pad_top,
                     int pad_left, int relu) {
  // 37,632 + 11,256 bytes: under the 48 KB of static shared memory.
  __shared__ __align__(16) float w_s[F_TAPS * COUT];
  __shared__ float strip[7][3][2][F_HALF_COLS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid >> 5;                  // channel group of this warp
  const int ox0 = blockIdx.x * F_TILE_W;    // first output column
  const int oy0 = blockIdx.y * F_ROWS;      // first output row
  const long long n = blockIdx.z;

  for (int i = tid; i < F_TAPS * COUT; i += F_THREADS) w_s[i] = w[i];

  float sc[F_CH], sh[F_CH];
#pragma unroll
  for (int k = 0; k < F_CH; ++k) {
    sc[k] = scale ? scale[cg * F_CH + k] : 1.0f;
    sh[k] = shift ? shift[cg * F_CH + k] : 0.0f;
  }

  const int ix0 = ox0 * 2 - pad_left;       // input column of strip col 0
  const float* xn = x + n * h * wdt * 3;

  for (int r = 0; r < F_ROWS; ++r) {
    const int oy = oy0 + r;
    if (oy >= ho) break;                    // uniform across the block
    const int iy0 = oy * 2 - pad_top;

    __syncthreads();                        // previous row done with strip
    for (int i = tid; i < 7 * F_IN_COLS * 3; i += F_THREADS) {
      const int c = i % 3;
      const int lc = (i / 3) % F_IN_COLS;
      const int kh = i / (3 * F_IN_COLS);
      const int iy = iy0 + kh;
      const int ix = ix0 + lc;
      float v = 0.0f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wdt) {
        v = xn[(static_cast<long long>(iy) * wdt + ix) * 3 + c];
      }
      strip[kh][c][lc & 1][lc >> 1] = v;
    }
    __syncthreads();

    float acc0[F_CH], acc1[F_CH];
#pragma unroll
    for (int k = 0; k < F_CH; ++k) {
      acc0[k] = 0.0f;
      acc1[k] = 0.0f;
    }
    for (int kh = 0; kh < 7; ++kh) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int kw = 0; kw < 7; ++kw) {
          // Output pixel p reads strip column 2 p + kw: parity kw & 1,
          // index p + kw / 2.
          const float* srow = strip[kh][c][kw & 1];
          const float a0 = srow[lane + (kw >> 1)];
          const float a1 = srow[lane + 32 + (kw >> 1)];
          const float4* wv = reinterpret_cast<const float4*>(
              w_s + ((kh * 7 + kw) * 3 + c) * COUT + cg * F_CH);
#pragma unroll
          for (int q = 0; q < F_CH / 4; ++q) {
            const float4 wq = wv[q];
            acc0[4 * q + 0] = fmaf(a0, wq.x, acc0[4 * q + 0]);
            acc0[4 * q + 1] = fmaf(a0, wq.y, acc0[4 * q + 1]);
            acc0[4 * q + 2] = fmaf(a0, wq.z, acc0[4 * q + 2]);
            acc0[4 * q + 3] = fmaf(a0, wq.w, acc0[4 * q + 3]);
            acc1[4 * q + 0] = fmaf(a1, wq.x, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(a1, wq.y, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(a1, wq.z, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(a1, wq.w, acc1[4 * q + 3]);
          }
        }
      }
    }

    const long long row = (n * ho + oy) * wo;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = ox0 + lane + 32 * half;
      if (ox >= wo) continue;
      float v[F_CH];
#pragma unroll
      for (int k = 0; k < F_CH; ++k) {
        v[k] = fmaf(half ? acc1[k] : acc0[k], sc[k], sh[k]);
        if (relu) v[k] = fmaxf(v[k], 0.0f);
      }
      float4* dst = reinterpret_cast<float4*>(out + (row + ox) * COUT +
                                              cg * F_CH);
#pragma unroll
      for (int q = 0; q < F_CH / 4; ++q) {
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                             v[4 * q + 3]);
      }
    }
  }
}

int g_sms[MAX_DEVICES];
int g_max_smem[MAX_DEVICES];

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
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    cudaDeviceGetAttribute(&g_max_smem[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    err = cudaFuncSetAttribute(stem_conv_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_max_smem[dev]);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g_sms[dev] = sms;
  }
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

// x: (n, h, w, 3) fp32, contiguous.  w: (147, 64) fp32, row (kh * 7 + kw) *
// 3 + c (pack_stem_weight_f32).  scale, shift: 64 fp32 each, or both null
// for no affine.  out: (n, ho, wo, 64) fp32, contiguous, 16-byte aligned.
extern "C" int stem_conv7x7s2_f32(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* out, int n, int h, int wdt, int ho,
                                  int wo, int pad_top, int pad_left, int relu,
                                  void* stream) {
  const dim3 grid((wo + F_TILE_W - 1) / F_TILE_W,
                  (ho + F_ROWS - 1) / F_ROWS, n);
  stem_conv_f32_kernel<<<grid, F_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), h, wdt, ho, wo, pad_top, pad_left, relu);
  return static_cast<int>(cudaGetLastError());
}
