// The residual join of Inception-ResNet-v2's blocks on NHWC tensors, bf16
// or fp32, forward and backward: y = relu?(x + scale * (u + bias)), where x
// is the block's input, u its 1x1 "up" conv without the conv's bias (slim's
// conv2d with normalizer_fn=None, activation_fn=None), bias that conv's fp32
// bias and scale the block's constant (0.17 block35, 0.10 block17, 0.20
// block8; 1.0 and no ReLU for the last block8).
//   * residual_join_fwd<T, L>: y;
//   * residual_join_bwd<T, L>: from dy and, with the ReLU, the saved y:
//     dx = dy where y > 0, else 0 (without the ReLU dx is dy itself and is
//     not written), du = scale * dx, and each block's per-channel sums of
//     du in fp32 (one row of `part` a block);
//   * residual_join_bias_grad: dbias, the sum of those rows.
// Every kernel of the join holds `residual_join` in its name, so one reader
// of a trace sees the whole join.
//
// Arithmetic in fp32, as the plain version (ops/residual_join.py) does it:
// t = u + bias, v = x + scale * t, each rounded in fp32 with no fma
// contraction (__fadd_rn, __fmul_rn), then the ReLU and one rounding into
// T; du = scale * dx rounded once.  So y, dx and du are the plain version's
// bit for bit; dbias sums in another order.
//
// Replaces no TPU kernel: the JAX package has no Inception-ResNet-v2.  It
// was added with that backbone, whose 40 residual blocks would otherwise
// run the join as a bias add, a multiply, an add and a ReLU forward and as
// many generic elementwise passes backward.
//
// What bounds it on the H100: bytes.  At 384 images of 299x299 the 40
// joins touch 4.431 G elements (10 x 35x35x320, 20 x 17x17x1088, 10 x
// 8x8x2080 an image); forward x and u read and y written, backward dy read
// and dx and du written: six bf16 passes, 53.2 GB a step, 15.9 ms at 3.35
// TB/s (the ReLU's mask read from y and the bias are left out of that
// bound).  The arithmetic is a few fp32 operations an element.
//
// Design.
//   * A thread moves L channels at a time: 16 bytes (8 bf16 or 4 fp32)
//     where C is a multiple of that and every pointer 16-byte aligned (the
//     caller checks and passes L), one channel otherwise.
//   * The forward is one vector a thread over the flat NHWC tensor; the
//     vector's channel is its index modulo C / L, and the bias is read
//     through the read-only cache.
//   * The backward covers rows (N * H * W) x C as the train-mode BatchNorm
//     kernels do: a block holds a tile of `tv` channel vectors
//     (threadIdx.x % tv, neighbouring threads on neighbouring addresses) by
//     blockDim.x / tv rows at a time, walks a chunk of `chunk_rows` rows,
//     and sums its du per channel in registers; the block's sums are merged
//     in shared memory in a fixed order and written as one row of `part`.
//     The bias-gradient kernel adds the chunks' rows, 8 lanes a channel and
//     a fixed order again: dbias is the same from run to run, and nothing
//     is zeroed before a launch, so a CUDA graph replays the three kernels
//     as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LANES = 8;
// Threads a channel in the bias gradient's sum over the chunks.
constexpr int SUM_LANES = 8;

template <typename T, int L>
struct alignas(sizeof(T) * L) Vec {
  T v[L];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
    residual_join_fwd(const T* __restrict__ x, const T* __restrict__ u,
                      const float* __restrict__ bias, T* __restrict__ y,
                      unsigned vectors, unsigned cvs, float scale, int relu) {
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= vectors) return;
  const int c0 = static_cast<int>(i % cvs) * L;
  const Vec<T, L> xv = reinterpret_cast<const Vec<T, L>*>(x)[i];
  const Vec<T, L> uv = reinterpret_cast<const Vec<T, L>*>(u)[i];
  Vec<T, L> out;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const float t = __fadd_rn(to_f(uv.v[k]), __ldg(bias + c0 + k));
    float v = __fadd_rn(to_f(xv.v[k]), __fmul_rn(scale, t));
    if (relu && v < 0.0f) v = 0.0f;
    out.v[k] = from_f<T>(v);
  }
  reinterpret_cast<Vec<T, L>*>(y)[i] = out;
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
    residual_join_bwd(const T* __restrict__ dy, const T* __restrict__ y,
                      T* __restrict__ dx, T* __restrict__ du,
                      float* __restrict__ part, int rows, int c, int tv,
                      int chunk_rows, float scale, int relu) {
  __shared__ float sums[THREADS * MAX_LANES];
  const int cvs = c / L;
  const int tx = threadIdx.x % tv, ty = threadIdx.x / tv;
  const int by = THREADS / tv;
  const int cv = blockIdx.y * tv + tx;
  const bool active = ty < by && cv < cvs;
  float acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0.0f;
  const int r0 = blockIdx.x * chunk_rows;
  const int r1 = min(rows, r0 + chunk_rows);
  if (active) {
    const Vec<T, L>* g = reinterpret_cast<const Vec<T, L>*>(dy);
    const Vec<T, L>* yv = reinterpret_cast<const Vec<T, L>*>(y);
    Vec<T, L>* gx = reinterpret_cast<Vec<T, L>*>(dx);
    Vec<T, L>* gu = reinterpret_cast<Vec<T, L>*>(du);
#pragma unroll 2
    for (int r = r0 + ty; r < r1; r += by) {
      const size_t i = static_cast<size_t>(r) * cvs + cv;
      Vec<T, L> d = g[i];
      if (relu) {
        const Vec<T, L> out = yv[i];
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (!(to_f(out.v[k]) > 0.0f)) d.v[k] = from_f<T>(0.0f);
        gx[i] = d;
      }
      Vec<T, L> o;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float v = __fmul_rn(scale, to_f(d.v[k]));
        acc[k] += v;
        o.v[k] = from_f<T>(v);
      }
      gu[i] = o;
    }
  }
  // The block's sums: each thread's lanes, then the rows' in order.
#pragma unroll
  for (int k = 0; k < L; ++k) sums[threadIdx.x * L + k] = acc[k];
  __syncthreads();
  if (ty == 0 && cv < cvs) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      float s = 0.0f;
      for (int j = 0; j < by; ++j) s += sums[(j * tv + tx) * L + k];
      part[static_cast<size_t>(blockIdx.x) * c + cv * L + k] = s;
    }
  }
}

// dbias[ch] = the sum of part[k][ch] over the chunks k: a block holds
// THREADS / SUM_LANES channels by SUM_LANES lanes, lane j summing the
// chunks j, j + SUM_LANES, ...; the lanes' sums are added in order.
__global__ void __launch_bounds__(THREADS)
    residual_join_bias_grad_kernel(const float* __restrict__ part,
                                   float* __restrict__ dbias, int c,
                                   int chunks) {
  __shared__ float sums[THREADS];
  const int lane = threadIdx.x % SUM_LANES;
  const int ch = blockIdx.x * (THREADS / SUM_LANES) + threadIdx.x / SUM_LANES;
  float s = 0.0f;
  if (ch < c) {
#pragma unroll 4
    for (int k = lane; k < chunks; k += SUM_LANES)
      s += part[static_cast<size_t>(k) * c + ch];
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  if (lane == 0 && ch < c) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < SUM_LANES; ++j) t += sums[threadIdx.x + j];
    dbias[ch] = t;
  }
}

template <typename T, int L>
int launch_fwd(const void* x, const void* u, const void* bias, void* y,
               int rows, int c, float scale, int relu, cudaStream_t stream) {
  const long long vectors = static_cast<long long>(rows) * (c / L);
  if (vectors <= 0 || vectors > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>((vectors + THREADS - 1) / THREADS);
  residual_join_fwd<T, L><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<unsigned>(vectors), static_cast<unsigned>(c / L), scale,
      relu);
  return cudaGetLastError();
}

template <typename T, int L>
int launch_bwd(const void* dy, const void* y, void* dx, void* du, void* part,
               int rows, int c, int tv, int chunk_rows, int chunks,
               int tiles, float scale, int relu, cudaStream_t stream) {
  const int cvs = c / L;
  if (rows <= 0 || tv <= 0 || tv > THREADS || tiles * tv < cvs ||
      chunk_rows <= 0 ||
      static_cast<long long>(chunks) * chunk_rows < rows ||
      tiles > 65535 || (relu && (y == nullptr || dx == nullptr)))
    return cudaErrorInvalidValue;
  residual_join_bwd<T, L><<<dim3(chunks, tiles), THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<T*>(dx), static_cast<T*>(du), static_cast<float*>(part),
      rows, c, tv, chunk_rows, scale, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int residual_join_fwd_bf16(const void* x, const void* u, const void* bias,
                           void* y, int rows, int c, int lanes, float scale,
                           int relu, cudaStream_t stream) {
  if (lanes == 8 && c % 8 == 0)
    return launch_fwd<__nv_bfloat16, 8>(x, u, bias, y, rows, c, scale, relu,
                                        stream);
  if (lanes == 1)
    return launch_fwd<__nv_bfloat16, 1>(x, u, bias, y, rows, c, scale, relu,
                                        stream);
  return cudaErrorInvalidValue;
}

int residual_join_fwd_f32(const void* x, const void* u, const void* bias,
                          void* y, int rows, int c, int lanes, float scale,
                          int relu, cudaStream_t stream) {
  if (lanes == 4 && c % 4 == 0)
    return launch_fwd<float, 4>(x, u, bias, y, rows, c, scale, relu, stream);
  if (lanes == 1)
    return launch_fwd<float, 1>(x, u, bias, y, rows, c, scale, relu, stream);
  return cudaErrorInvalidValue;
}

int residual_join_bwd_bf16(const void* dy, const void* y, void* dx, void* du,
                           void* part, int rows, int c, int lanes, int tv,
                           int chunk_rows, int chunks, int tiles, float scale,
                           int relu, cudaStream_t stream) {
  if (lanes == 8 && c % 8 == 0)
    return launch_bwd<__nv_bfloat16, 8>(dy, y, dx, du, part, rows, c, tv,
                                        chunk_rows, chunks, tiles, scale,
                                        relu, stream);
  if (lanes == 1)
    return launch_bwd<__nv_bfloat16, 1>(dy, y, dx, du, part, rows, c, tv,
                                        chunk_rows, chunks, tiles, scale,
                                        relu, stream);
  return cudaErrorInvalidValue;
}

int residual_join_bwd_f32(const void* dy, const void* y, void* dx, void* du,
                          void* part, int rows, int c, int lanes, int tv,
                          int chunk_rows, int chunks, int tiles, float scale,
                          int relu, cudaStream_t stream) {
  if (lanes == 4 && c % 4 == 0)
    return launch_bwd<float, 4>(dy, y, dx, du, part, rows, c, tv, chunk_rows,
                                chunks, tiles, scale, relu, stream);
  if (lanes == 1)
    return launch_bwd<float, 1>(dy, y, dx, du, part, rows, c, tv, chunk_rows,
                                chunks, tiles, scale, relu, stream);
  return cudaErrorInvalidValue;
}

int residual_join_bias_grad(const void* part, void* dbias, int c, int chunks,
                            cudaStream_t stream) {
  if (c <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  const int per_block = THREADS / SUM_LANES;
  residual_join_bias_grad_kernel<<<(c + per_block - 1) / per_block, THREADS,
                                   0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), c, chunks);
  return cudaGetLastError();
}

}  // extern "C"
