// TF-'SAME' 3x3 average pool at stride 1 on NHWC tensors, bf16 or fp32,
// forward and backward, counting the padded zeros (Flax's avg_pool with
// count_include_pad=True, which the port follows): every average pool of
// the port's backbones (Inception-v2/v3/v4's pool branches).
//   * avg_pool_same_fwd_{bf16,f32}: y = the sum of each 3x3 window of x
//     padded by one zero on every side, over 9;
//   * avg_pool_same_bwd_{bf16,f32}: dx from dy alone.  At stride 1 with
//     symmetric pads the windows that hold input i are the outputs i-1 ..
//     i+1 that lie in the image, so dx = boxsum3x3(dy) / 9 with zero
//     padding: the forward's function applied to dy.  Nothing is saved
//     for it, neither x nor an index.
//
// Replaces no TPU kernel: the JAX package leaves pooling to XLA
// (reduce_window).  It was added because PyTorch's NHWC average pools took
// 96.9 ms of the 281 ms B=32 Inception-v4 train step at 299x299, 4% of
// their bound (backward 57 ms, forward 40 ms).
//
// What bounds it on the H100: bytes.  At 384 images the 14 pools of
// Inception-v4 read 3.26 G bf16 elements and write as many in the forward,
// and the backward as much again: 13.05 GB a step, 3.90 ms at 3.35 TB/s.
// The arithmetic is a few fp32 adds an element.
//
// Design.
//   * One body, two kernels: the forward and the backward run the same
//     function under two names (avg_pool_same_fwd<T>, avg_pool_same_bwd<T>),
//     so a trace keeps them apart.
//   * Each thread owns a vector of channels (16 bytes: 8 bf16 or 4 fp32;
//     the caller checks that C is a multiple of it and that both pointers
//     are 16-byte aligned) at one column, down a band of output rows.  A
//     block holds a slice of channel vectors (threadIdx.x, neighbouring
//     threads on neighbouring addresses) by a strip of columns
//     (threadIdx.y) with one halo column on each side, whose threads load
//     and do not write.
//   * Each thread copies its column's vector of each input row of the band
//     (plus the band's two halo rows) once, with cp.async into a ring of
//     STAGES rows in shared memory, STAGES - 1 rows ahead of the sums, so
//     the loads stay in flight without registers.  After one barrier a row
//     the thread adds its left neighbour's, its own and its right
//     neighbour's vectors (the row sum), and the last three row sums give
//     an output row: a separable sum that reads each input of the block's
//     tile once.  Neighbouring bands of a strip are neighbouring blocks
//     (the band index varies fastest), so the halo rows and columns that
//     two blocks share come from L2 and DRAM sees each input about once.
//   * The sums are fp32, in the order (left + centre) + right by row, then
//     (row above + row) + row below; taps outside the image add nothing
//     (the copy fills zeros).  The quotient by 9 is correctly rounded in
//     fp32 and rounded once into the output type.
//   * The block's shape follows (H, W, C): C cut into equal slices of at
//     most MAX_VECTORS vectors, W into equal strips that fill at most
//     MAX_THREADS threads with their halo, H into equal bands of at most
//     MAX_BAND rows.  At 299x299 in bf16: 35x35x384 is 2 slices of 24
//     vectors by 5 strips of 7 columns by 5 bands of 7 rows; 17x17x1024 is
//     4 x 32 by 3 x 6 by 3 x 6; 8x8x1536 is 6 x 32 by 2 x 4 by 1 x 8.  The
//     constants were the fastest of ten sets timed on the card (slices of
//     8-32 vectors, blocks of 256-512 threads, bands of 4-16 rows, rings of
//     3-6 rows): the 14 forwards within 2.55-2.80 ms, bands of 4 rows slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_VECTORS = 32;  // channel vectors a block's slice holds
constexpr int MAX_BAND = 8;      // output rows a block owns
constexpr int STAGES = 4;        // input rows in the shared-memory ring
constexpr int MAX_GRID_Y = 65535;

// An image's shape in channel vectors, and a block's share of it.
struct Box {
  int h, w, cvs;  // rows, columns, 16-byte channel vectors a pixel
  int vectors;    // vectors a block holds (blockDim.x)
  int cols;       // output columns a block owns (blockDim.y - 2)
  int band;       // output rows a block owns
  int strips;     // column strips an image has
  int bands;      // row bands an image has
};

template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  // acc[i] += lane i of v, in fp32; a word holds lanes 2i (low half) and
  // 2i + 1 (high half).
  static __device__ __forceinline__ void add(float* acc, const uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Lanes<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void add(float* acc, const uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// s / 9, correctly rounded: the product by the rounded 1/9, corrected by
// its exact remainder (Markstein's theorem).
__device__ __forceinline__ float ninth(float s) {
  constexpr float R = 1.0f / 9.0f;
  const float q = s * R;
  return fmaf(fmaf(-q, 9.0f, s), R, q);
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
// (src must still be a valid address).
__device__ __forceinline__ void copy16(uint4* dst, const uint4* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// out = boxsum3x3(in) / 9 over the block's tile (see the source note).
template <typename T>
__device__ __forceinline__ void box_mean(const T* __restrict__ in,
                                         T* __restrict__ out, const Box g) {
  using L = Lanes<T>;
  extern __shared__ uint4 ring[];  // [STAGES][blockDim.y][g.vectors]
  const int tx = threadIdx.x, ty = threadIdx.y;
  int b = blockIdx.x;
  const int band = b % g.bands;
  b /= g.bands;
  const int v = b / g.strips * g.vectors + tx;
  const int iw = b % g.strips * g.cols + ty - 1;  // the column it loads
  const bool loads = v < g.cvs && iw >= 0 && iw < g.w;
  const bool writes = loads && ty >= 1 && ty <= g.cols;
  const int oh0 = band * g.band, oh1 = min(oh0 + g.band, g.h);
  // The band's input rows that lie in the image: first .. first + m - 1.
  const int first = max(oh0 - 1, 0);
  const int m = min(oh1, g.h - 1) - first + 1;
  const long long row = static_cast<long long>(g.w) * g.cvs;
  // Clamped into the image, so that a thread that loads nothing still
  // names an address inside x.
  const long long at = static_cast<long long>(blockIdx.y) * g.h * row +
                       min(max(iw, 0), g.w - 1) * g.cvs + min(v, g.cvs - 1);
  const uint4* src = reinterpret_cast<const uint4*>(in) + at + first * row;
  uint4* dst = reinterpret_cast<uint4*>(out) + at;
  const int stage = blockDim.y * g.vectors;  // vectors a ring row holds
  uint4* mine = ring + ty * g.vectors + tx;

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < m) copy16(mine + k * stage, src + k * row, loads);
    commit();
  }
  float above2[L::N], above1[L::N];  // row sums of the two rows above
#pragma unroll
  for (int i = 0; i < L::N; ++i) above2[i] = above1[i] = 0.0f;
  for (int ih = oh0 - 1; ih <= oh1; ++ih) {
    float s[L::N];
#pragma unroll
    for (int i = 0; i < L::N; ++i) s[i] = 0.0f;
    if (ih >= 0 && ih < g.h) {  // the same in every thread of the block
      const int k = ih - first;
      wait_all_but_newest();  // this thread's copy of row k has landed
      __syncthreads();        // every thread's has, and row k - 1 is read
      if (k + STAGES - 1 < m) {
        copy16(mine + (k + STAGES - 1) % STAGES * stage,
               src + (k + STAGES - 1) * row, loads);
      }
      commit();
      if (writes) {
        const uint4* c = mine + k % STAGES * stage;
        L::add(s, c[-g.vectors]);
        L::add(s, c[0]);
        L::add(s, c[g.vectors]);
      }
    }
    if (writes && ih > oh0) {
      float o[L::N];
#pragma unroll
      for (int i = 0; i < L::N; ++i) {
        o[i] = ninth(above2[i] + above1[i] + s[i]);
      }
      dst[(ih - 1) * row] = L::pack(o);
    }
#pragma unroll
    for (int i = 0; i < L::N; ++i) {
      above2[i] = above1[i];
      above1[i] = s[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
avg_pool_same_fwd(const T* __restrict__ x, T* __restrict__ y, const Box g) {
  box_mean<T>(x, y, g);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
avg_pool_same_bwd(const T* __restrict__ dy, T* __restrict__ dx,
                  const Box g) {
  box_mean<T>(dy, dx, g);
}

// The block shape for an image of h x w pixels of cvs channel vectors.
Box box_of(int h, int w, int cvs) {
  Box g{h, w, cvs, 0, 0, 0, 0, 0};
  const int slices = (cvs + MAX_VECTORS - 1) / MAX_VECTORS;
  g.vectors = (cvs + slices - 1) / slices;
  const int max_cols = MAX_THREADS / g.vectors - 2;
  g.strips = (w + max_cols - 1) / max_cols;
  g.cols = (w + g.strips - 1) / g.strips;
  g.bands = (h + MAX_BAND - 1) / MAX_BAND;
  g.band = (h + g.bands - 1) / g.bands;
  return g;
}

template <typename T>
int launch(void (*kernel)(const T*, T*, Box), const void* in, void* out,
           int n, int h, int w, int c, void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Box g = box_of(h, w, c / VEC);
  const int slices = (g.cvs + g.vectors - 1) / g.vectors;
  const dim3 block(g.vectors, g.cols + 2);
  const size_t smem = sizeof(uint4) * STAGES * block.x * block.y;
  const long long image = static_cast<long long>(h) * w * c;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < n; n0 += MAX_GRID_Y) {
    const dim3 grid(slices * g.strips * g.bands, min(MAX_GRID_Y, n - n0));
    kernel<<<grid, block, smem, st>>>(static_cast<const T*>(in) + n0 * image,
                                      static_cast<T*>(out) + n0 * image, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, c) NHWC -> y (n, h, w, c) NHWC, contiguous, in x's type: the
// 3x3 window at stride 1 over x padded by one zero on every side, over 9.
// c a multiple of 16 bytes' channels (8 bf16, 4 fp32) and both pointers
// 16-byte aligned (the caller checks both).
extern "C" int avg_pool_same_fwd_bf16(const void* x, void* y, int n, int h,
                                      int w, int c, void* stream) {
  return launch<__nv_bfloat16>(avg_pool_same_fwd<__nv_bfloat16>, x, y, n, h,
                               w, c, stream);
}

extern "C" int avg_pool_same_fwd_f32(const void* x, void* y, int n, int h,
                                     int w, int c, void* stream) {
  return launch<float>(avg_pool_same_fwd<float>, x, y, n, h, w, c, stream);
}

// dy (n, h, w, c) NHWC -> dx (n, h, w, c) NHWC: the same box mean of dy.
extern "C" int avg_pool_same_bwd_bf16(const void* dy, void* dx, int n,
                                      int h, int w, int c, void* stream) {
  return launch<__nv_bfloat16>(avg_pool_same_bwd<__nv_bfloat16>, dy, dx, n,
                               h, w, c, stream);
}

extern "C" int avg_pool_same_bwd_f32(const void* dy, void* dx, int n, int h,
                                     int w, int c, void* stream) {
  return launch<float>(avg_pool_same_bwd<float>, dy, dx, n, h, w, c, stream);
}
