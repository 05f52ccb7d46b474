// Inception-v1 stem convolution, Conv2d_1a_7x7: 7x7, stride 2, 3 -> 64
// channels, TF-'SAME' padding, no bias.  bf16 in, fp32 accumulation, bf16
// out, NHWC throughout.
//
// Replaces the TPU kernel gvcnn_tf_tpu/ops/pallas_stem.py::_stem_fwd
// (_stem_kernel + _pack_weights), which built the im2col matrix in VMEM and
// packed two output rows into one 128-lane MXU product.  That packing was
// shaped for the MXU and is not carried over.
//
// What bounds it on the H100: the input has 3 channels and the window is
// read at stride 2, so a plain implicit GEMM re-reads each input pixel up to
// 49 times and the product has K = 147, far from a tensor-core tile.  The
// arithmetic (~22.7 GFLOP at N = 96, 224x224) is small for the card; the
// cost is in moving the 3-channel window into the multipliers.
//
// Design: one block per (sample, strip of TILE_W output columns, ROWS
// output rows).  The block stages the (147, 64) weight matrix in shared
// memory once as fp32, then for each output row stages the 7 input rows of
// its strip, zero padded, split by column parity so that the 32 lanes of a
// warp read 32 consecutive words for every tap (no bank conflicts).  Warp w
// computes channels [16w, 16w + 16) for two output pixels per lane (lane,
// lane + 32); the 16 weights of a tap are a broadcast read shared by the
// warp.  Everything runs on the CUDA cores in fp32.
//
// Left for later PRs: tensor cores (mma/wgmma with K = 147 padded to 160),
// double-buffered input staging with cp.async or TMA, and fusing folded
// BatchNorm's bias and the ReLU into the epilogue (they run in PyTorch
// after this kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KH = 7, KW = 7, CIN = 3, COUT = 64, STRIDE = 2;
constexpr int TAPS = KH * KW * CIN;                      // 147
constexpr int TILE_W = 64;                               // output columns
constexpr int ROWS = 8;                                  // output rows
constexpr int THREADS = 128;                             // 4 warps
constexpr int CH_PER_WARP = COUT / (THREADS / 32);       // 16
constexpr int IN_COLS = (TILE_W - 1) * STRIDE + KW;      // 133
constexpr int HALF_COLS = (IN_COLS + 1) / 2;             // 67 per parity

static_assert(CH_PER_WARP == 16, "one warp per 16 output channels");

// Store 16 fp32 accumulators as 16 bf16 (32 bytes) in two 16-byte writes.
__device__ __forceinline__ void store16(__nv_bfloat16* dst,
                                        const float (&acc)[CH_PER_WARP]) {
  __align__(16) __nv_bfloat162 packed[CH_PER_WARP / 2];
#pragma unroll
  for (int k = 0; k < CH_PER_WARP / 2; ++k) {
    packed[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* src = reinterpret_cast<const uint4*>(packed);
  d[0] = src[0];
  d[1] = src[1];
}

__global__ void __launch_bounds__(THREADS)
stem_conv7x7s2_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out,
                      int h, int wdt, int ho, int wo,
                      int pad_top, int pad_left) {
  // 37,632 + 11,256 bytes: under the 48 KB of static shared memory.
  __shared__ __align__(16) float w_s[TAPS * COUT];
  __shared__ float strip[KH][CIN][2][HALF_COLS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid >> 5;                 // channel group of this warp
  const int ox0 = blockIdx.x * TILE_W;     // first output column
  const int oy0 = blockIdx.y * ROWS;       // first output row
  const long long n = blockIdx.z;

  for (int i = tid; i < TAPS * COUT; i += THREADS) {
    w_s[i] = __bfloat162float(w[i]);
  }

  const int ix0 = ox0 * STRIDE - pad_left;  // input column of strip col 0
  const __nv_bfloat16* xn = x + n * h * wdt * CIN;

  for (int r = 0; r < ROWS; ++r) {
    const int oy = oy0 + r;
    if (oy >= ho) break;                    // uniform across the block
    const int iy0 = oy * STRIDE - pad_top;

    __syncthreads();                        // previous row done with strip
    // Stage 7 input rows x IN_COLS columns x 3 channels; consecutive
    // threads read consecutive bf16 of one input row.
    for (int i = tid; i < KH * IN_COLS * CIN; i += THREADS) {
      const int c = i % CIN;
      const int lc = (i / CIN) % IN_COLS;
      const int kh = i / (CIN * IN_COLS);
      const int iy = iy0 + kh;
      const int ix = ix0 + lc;
      float v = 0.0f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wdt) {
        v = __bfloat162float(xn[((long long)iy * wdt + ix) * CIN + c]);
      }
      strip[kh][c][lc & 1][lc >> 1] = v;
    }
    __syncthreads();

    float acc0[CH_PER_WARP], acc1[CH_PER_WARP];
#pragma unroll
    for (int k = 0; k < CH_PER_WARP; ++k) {
      acc0[k] = 0.0f;
      acc1[k] = 0.0f;
    }

    for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
#pragma unroll
        for (int kw = 0; kw < KW; ++kw) {
          // Output pixel p reads strip column 2p + kw: parity kw & 1,
          // index p + kw / 2.
          const float* s = strip[kh][c][kw & 1];
          const float a0 = s[lane + (kw >> 1)];
          const float a1 = s[lane + 32 + (kw >> 1)];
          const float4* wv = reinterpret_cast<const float4*>(
              w_s + ((kh * KW + kw) * CIN + c) * COUT + cg * CH_PER_WARP);
#pragma unroll
          for (int q = 0; q < CH_PER_WARP / 4; ++q) {
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
    if (ox0 + lane < wo) {
      store16(out + (row + ox0 + lane) * COUT + cg * CH_PER_WARP, acc0);
    }
    if (ox0 + lane + 32 < wo) {
      store16(out + (row + ox0 + lane + 32) * COUT + cg * CH_PER_WARP, acc1);
    }
  }
}

}  // namespace

// x: (n, h, w, 3) bf16, contiguous.  w: (147, 64) bf16, row (kh*7+kw)*3+c.
// out: (n, ho, wo, 64) bf16, contiguous, 16-byte aligned.
extern "C" int stem_conv7x7s2_bf16(const void* x, const void* w, void* out,
                                   int n, int h, int wdt, int ho, int wo,
                                   int pad_top, int pad_left, void* stream) {
  const dim3 grid((wo + TILE_W - 1) / TILE_W, (ho + ROWS - 1) / ROWS, n);
  stem_conv7x7s2_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), h, wdt, ho, wo, pad_top, pad_left);
  return static_cast<int>(cudaGetLastError());
}
