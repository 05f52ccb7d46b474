// Train-mode BatchNorm (+ ReLU) on NHWC tensors, bf16 or fp32, with fp32
// statistics and parameters: every train-mode BatchNorm of the port's
// backbones and of GVCNN's score FCN.  Four kernels, each one pass over the
// rows = N*H*W by C channels of an NHWC tensor:
//   * batch_norm_stats<T, L>: the batch mean and biased variance of each
//     channel; the block that finishes last also writes mean and invstd =
//     1 / sqrt(var + eps) and, unless told not to (a remat recompute),
//     moves running_mean and running_var (biased) in place:
//     r <- r * momentum + stat * (1 - momentum);
//   * batch_norm_apply<T, L>: y = v or, with the ReLU, y = v > 0 ? v : 0,
//     where v = fma(x, a, b), a = invstd * gamma, b = fma(-mean, a, beta);
//   * batch_norm_bwd_reduce<T, L>: per channel, with g = dy where the
//     forward's v > 0 (dy everywhere without the ReLU): sum(g) and
//     sum(g * (x - mean)), whence dbeta = sum(g) and dgamma = invstd *
//     sum(g * (x - mean)); the block that finishes last writes them and
//     the two constants of the elementwise pass;
//   * batch_norm_bwd_elemt<T, L>: dx = (g - sum(g) / n - (x - mean) *
//     invstd^2 * sum(g * (x - mean)) / n) * invstd * gamma.
// The ReLU's mask is recomputed from x with the forward's own fp32
// expression (the same intrinsics, so the same bits): y is not kept for
// the backward.
//
// The residual variants, for ResNet's relu(shortcut + BN(conv3)), take the
// shortcut r as one more operand (`apply_rows` and `bwd_reduce_rows` with
// R; the kernels above are the same functions without it):
//   * batch_norm_apply_residual<T, L>: out = relu(fma(x, a, b) + r), the
//     sum and the ReLU in fp32, rounded once: reads x and r, writes out;
//   * batch_norm_bwd_reduce_residual<T, L>: the two sums of g = dy where
//     the saved out > 0 (threshold_backward's mask; out is the next
//     block's input, which autograd keeps anyway), and g written: it is
//     r's gradient and the dy that batch_norm_bwd_elemt then reads without
//     the ReLU.
// Per element of a block output that is 10 passes forward and backward
// where the apply, PyTorch's add, its ReLU and their backward made 15.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA (Flax's
// `BatchNorm`).  It was added because PyTorch's channels-last batch-norm
// kernels, with a separate ReLU and about ten launches a layer for the
// running statistics, took 32-43% of the B = 32 train steps at 45-50% of
// their own bound, the statistics kernel at 17-19%.
//
// What bounds it on the H100: bytes.  The four kernels make the passes of
// PyTorch's four (read x; read x, write y; read dy and x; read dy and x,
// write dx: 8 passes over the outputs), and the ReLU's 5 passes are gone.
// The arithmetic is a few fp32 operations an element.
//
// Design.
//   * Each thread owns L channels (one 16-byte vector: 8 bf16 or 4 fp32;
//     L = 1 where C is not a multiple of a vector or the data is not
//     16-byte aligned) of a strip of rows.  A block is a tile of
//     blockDim.x vectors (neighbouring threads on neighbouring addresses)
//     by blockDim.y rows at a time, over a chunk of rows; the grid is
//     (chunks, tiles).  The caller (`ops/batch_norm_kernel.plan`) picks
//     the tiles and the chunks from (rows, C) and passes both in: tiles
//     of at most 32 vectors, as many rows a step as fill 256 threads, and
//     as many chunks as give each SM two blocks with at
//     least 16 rows a thread (two rather than four or eight: fewer
//     partials to merge, and one wave even at 72 registers a thread).  One
//     algorithm for every shape: Inception-v1's Conv2d_1a (4.8 M rows x 64
//     channels) is 1 tile by 264 chunks, ResNet-50's block4 (18.8 k rows x
//     2048) 8 tiles by 33.
//   * Statistics: each thread keeps Welford's (mean, M2) for its lanes in
//     fp32 (one reciprocal a row, shared by the lanes); the block merges
//     its rows' partials, then the chunks are merged by Chan's parallel
//     formula, never from raw E[x^2] - E[x]^2 sums.  The backward's two
//     sums are plain fp32 sums over the same two levels.
//   * The merge without a second launch: each block writes its partial to
//     a scratch buffer (the caller's torch.empty), fences, and takes a
//     ticket for its group of 16 chunks; the block that draws a group's
//     last ticket merges the group into a group partial and takes a ticket
//     for its tile; the block that draws the tile's last merges the
//     groups.  Each merge runs in a fixed order (so the result does not
//     depend on which block came last, and a remat recompute gives the
//     same bits) and puts its ticket back to 0 for the next launch: a CUDA
//     graph needs no memset node.  Partials but the last hold equal counts,
//     so a merge is two passes of independent adds, not a chain of
//     divisions, with BATCH loads in flight a thread (`strided_sum`).  A
//     merge is the serial part of a launch (the other blocks are done);
//     one block merging a tile's 264 chunks cost 20-30 us a launch, two
//     levels of at most 17 a few.
//   * The apply and the elementwise backward keep their channels'
//     constants in registers and stream rows, 16 bytes a load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block's threads: the launch bounds and the shared arrays are sized by
// it, and `ops/batch_norm_kernel.MAX_THREADS` plans with the same number.
constexpr int MAX_THREADS = 256;

// L lanes of T moved as one load or store (`Raw`), unpacked to fp32.
template <typename T, int L>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16, 8> {
  using Raw = uint4;
  // f[i] = lane i; a word holds lanes 2i (low half) and 2i + 1 (high half).
  static __device__ __forceinline__ void unpack(const Raw v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
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
struct Lanes<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ void unpack(const Raw v, float* f) {
    f[0] = __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
};

template <>
struct Lanes<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Lanes<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw v, float* f) {
    f[0] = v;
  }
  static __device__ __forceinline__ Raw pack(const float* f) { return f[0]; }
};

// An NHWC tensor as rows x channels, and the grid's share of it.
struct Plan {
  int rows;        // N * H * W
  int c;           // channels
  int cv;          // lane groups a row of x (c / L)
  int gv;          // lane groups between two rows of dy (its pitch / L)
  int chunk_rows;  // rows a block owns (the last chunk may hold fewer)
  int chunks;      // gridDim.x
  int group;       // chunks whose partials one block merges first
};

// The rows [r0, r1) of this block's chunk.
__device__ __forceinline__ void chunk_rows(const Plan& p, int chunk, int& r0,
                                          int& r1) {
  r0 = chunk * p.chunk_rows;
  r1 = min(r0 + p.chunk_rows, p.rows);
}

// How many of [r0, r1) the threads of row group e (rows r0 + e, r0 + e +
// by, ...) own.
__device__ __forceinline__ int group_rows(int r0, int r1, int e, int by) {
  return r1 - r0 > e ? (r1 - r0 - e + by - 1) / by : 0;
}

// Partials a thread of the last block has in flight while it merges.
constexpr int BATCH = 16;

// The sum of term(k) over k = k0, k0 + step, ... < n, in that order, BATCH
// terms (and their loads) at a time: the last block's merge is the one
// serial part of a launch, and a chain of L2 round trips there cost tens of
// microseconds a launch.
template <typename Term>
__device__ __forceinline__ float strided_sum(int k0, int step, int n,
                                             Term term) {
  float s = 0.0f;
  for (int k = k0; k < n; k += BATCH * step) {
    float t[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      t[u] = k + u * step < n ? term(k + u * step) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) s += t[u];
  }
  return s;
}

// (n, mean, m2) <- the merge of itself with (nb, mb, m2b), nb > 0: Chan's
// parallel formula.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float m2b) {
  const float nn = n + nb;
  const float f = __fdiv_rn(nb, nn);
  const float d = mb - mean;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

// The forward's value before the ReLU, with a = invstd * gamma and b =
// fma(-mean, a, beta): apply and both backward passes compute it with the
// same intrinsics, so the mask is the forward's bit for bit.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fmaf_rn(x, a, b);
}

// Whether the ReLU passes v (and its gradient): v > 0, or v is NaN, as
// torch.relu and its backward (threshold_backward: y <= 0 -> 0) do.
__device__ __forceinline__ bool passes(float v) { return !(v <= 0.0f); }

// Each thread's lane constants: a = invstd * gamma, b = fma(-mean, a,
// beta), and the mean, for the channels c0 .. c0 + L - 1.
template <int L>
__device__ __forceinline__ void constants(const float* __restrict__ mean,
                                          const float* __restrict__ invstd,
                                          const float* __restrict__ weight,
                                          const float* __restrict__ bias,
                                          int c0, float* m, float* a,
                                          float* b) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    m[i] = mean[c0 + i];
    a[i] = weight ? __fmul_rn(invstd[c0 + i], weight[c0 + i])
                  : invstd[c0 + i];
    b[i] = __fmaf_rn(-m[i], a[i], bias[c0 + i]);
  }
}

// Whether this block drew the last of `expected` tickets at *t; that block
// puts it back to 0.  Every thread that wrote a partial has fenced it.
__device__ __forceinline__ bool last_of(int* t, int expected) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(t, 1) == expected - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  return last;
}

// A thread's share of a block's merge: channel j (of tc a tile; ch across
// C) with the other parts - 1 threads of it, as the k0-th.
struct Share {
  int tid, tc, parts, j, k0, ch;
};

// (n, mean, m2) of m partials of one channel (entry e's mean at at[e *
// stride], its M2 at at[e * stride + c]) that hold cnt rows each but the
// last, which holds last.  For the entries but the last, the merge that
// Chan's formula gives for equal counts: the mean of their means, then the
// sum of M2 + cnt * (mean - that mean)^2, two passes of independent adds
// (`strided_sum`; the parts' sums added in order) where a chain of merges
// would wait on each division; the last entry after, by Chan's formula.
// Every thread of the block calls it; the result is a thread's with tid <
// tc, for its channel.
__device__ void merge_stats(const float* at, long long stride, int c, int m,
                            float cnt, float last, const Share& w,
                            float (*sr)[MAX_THREADS], float* mean_of_full,
                            float& n, float& mean, float& m2) {
  const int full = m - 1;
  if (w.k0 < w.parts && w.ch < c) {
    sr[0][w.tid] = strided_sum(w.k0, w.parts, full, [&](int k) {
      return __ldcg(at + k * stride);
    });
  }
  __syncthreads();
  if (w.tid < w.tc) {
    float s = 0.0f;
    for (int k = 0; k < w.parts; ++k) s += sr[0][k * w.tc + w.j];
    mean_of_full[w.j] =
        full > 0 ? __fdiv_rn(s, static_cast<float>(full)) : 0.0f;
  }
  __syncthreads();
  const float mf = mean_of_full[w.j];
  if (w.k0 < w.parts && w.ch < c) {
    sr[1][w.tid] = strided_sum(w.k0, w.parts, full, [&](int k) {
      const float d = __ldcg(at + k * stride) - mf;
      return fmaf(cnt * d, d, __ldcg(at + k * stride + c));
    });
  }
  __syncthreads();
  n = mean = m2 = 0.0f;
  if (w.tid < w.tc && w.ch < c) {
    for (int k = 0; k < w.parts; ++k) m2 += sr[1][k * w.tc + w.j];
    n = full * cnt;
    mean = mf;
    chan(n, mean, m2, last, __ldcg(at + full * stride),
         __ldcg(at + full * stride + c));
  }
}

// The two sums of m partials of one channel (entry e's at at[e * stride]
// and at[e * stride + c]): `strided_sum`s, the parts' sums added in order.
// Every thread of the block calls it; the result is a thread's with tid <
// tc, for its channel.
__device__ void merge_sums(const float* at, long long stride, int c, int m,
                           const Share& w, float (*sr)[MAX_THREADS],
                           float& a1, float& a2) {
  if (w.k0 < w.parts && w.ch < c) {
    sr[0][w.tid] = strided_sum(w.k0, w.parts, m, [&](int k) {
      return __ldcg(at + k * stride);
    });
    sr[1][w.tid] = strided_sum(w.k0, w.parts, m, [&](int k) {
      return __ldcg(at + k * stride + c);
    });
  }
  __syncthreads();
  a1 = a2 = 0.0f;
  if (w.tid < w.tc && w.ch < c) {
    for (int k = 0; k < w.parts; ++k) {
      a1 += sr[0][k * w.tc + w.j];
      a2 += sr[1][k * w.tc + w.j];
    }
  }
}

// The two levels of the chunks' merge, for the caller's block: its group
// of p.group chunks (the block that finishes the group last merges it into
// the group's partial, after the chunks' in `part`), then the groups (the
// block that finishes its tile's last group merge merges them).  The
// group's ticket, or with `tile` the tile's; tickets: groups + 1 a tile.
struct Groups {
  int n, g, first, members;
  __device__ Groups(const Plan& p)
      : n((p.chunks + p.group - 1) / p.group),
        g(blockIdx.x / p.group),
        first(g * p.group),
        members(min(p.group, p.chunks - g * p.group)) {}
  __device__ int* ticket(int* tickets, bool tile) const {
    return tickets + blockIdx.y * (n + 1) + (tile ? n : g);
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_stats(const T* __restrict__ x, float* __restrict__ part,
                 int* __restrict__ ticket, float* __restrict__ mean_out,
                 float* __restrict__ invstd_out,
                 float* __restrict__ running_mean,
                 float* __restrict__ running_var, const Plan p, float eps,
                 float momentum, float rest, int update) {
  using V = Lanes<T, L>;
  constexpr int U = 4;  // rows in flight a thread
  __shared__ float sm[2][MAX_THREADS * L];  // a row group's (mean, m2)
  __shared__ float sr[3][MAX_THREADS];      // a part's (n, mean, m2)
  const int tx = threadIdx.x, ty = threadIdx.y, by = blockDim.y;
  const int tc = blockDim.x * L;  // channels a tile
  const int v = blockIdx.y * blockDim.x + tx;
  int r0, r1;
  chunk_rows(p, blockIdx.x, r0, r1);

  float n = 0.0f, mean[L], m2[L];
#pragma unroll
  for (int i = 0; i < L; ++i) mean[i] = m2[i] = 0.0f;
  if (v < p.cv) {
    const typename V::Raw* src =
        reinterpret_cast<const typename V::Raw*>(x) + v;
    int r = r0 + ty;
    for (; r + (U - 1) * by < r1; r += U * by) {
      typename V::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        raw[u] = __ldg(src + static_cast<long long>(r + u * by) * p.cv);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float f[L];
        V::unpack(raw[u], f);
        n += 1.0f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const float d = f[i] - mean[i];
          mean[i] = fmaf(d, inv, mean[i]);
          m2[i] = fmaf(d, f[i] - mean[i], m2[i]);
        }
      }
    }
    for (; r < r1; r += by) {
      float f[L];
      V::unpack(__ldg(src + static_cast<long long>(r) * p.cv), f);
      n += 1.0f;
      const float inv = __frcp_rn(n);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float d = f[i] - mean[i];
        mean[i] = fmaf(d, inv, mean[i]);
        m2[i] = fmaf(d, f[i] - mean[i], m2[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    sm[0][ty * tc + tx * L + i] = mean[i];
    sm[1][ty * tc + tx * L + i] = m2[i];
  }
  __syncthreads();

  // Merge the row groups: channel j of the tile by `parts` threads, each
  // over every parts-th group, then the parts in order.
  const int tid = ty * blockDim.x + tx;
  const int parts = blockDim.x * by / tc;
  const int j = tid % tc, k0 = tid / tc;
  const int ch = blockIdx.y * tc + j;
  if (k0 < parts) {
    float nn = 0.0f, mu = 0.0f, q = 0.0f;
    for (int e = k0; e < by; e += parts) {
      const int ne = group_rows(r0, r1, e, by);
      if (ne > 0) chan(nn, mu, q, ne, sm[0][e * tc + j], sm[1][e * tc + j]);
    }
    sr[0][tid] = nn;
    sr[1][tid] = mu;
    sr[2][tid] = q;
  }
  __syncthreads();
  if (tid < tc && ch < p.c) {
    float nn = 0.0f, mu = 0.0f, q = 0.0f;
    for (int k = 0; k < parts; ++k) {
      const int s = k * tc + j;
      if (sr[0][s] > 0.0f) chan(nn, mu, q, sr[0][s], sr[1][s], sr[2][s]);
    }
    float* mine = part + static_cast<long long>(blockIdx.x) * 2 * p.c;
    mine[ch] = mu;
    mine[p.c + ch] = q;
    __threadfence();
  }
  // The chunks' merge, in two levels (`Groups`).
  const Groups gr(p);
  const Share w{tid, tc, parts, j, k0, ch};
  const long long stride = 2LL * p.c;
  if (!last_of(gr.ticket(ticket, false), gr.members)) return;
  float nn, mu, q;
  merge_stats(part + gr.first * stride + ch, stride, p.c, gr.members,
              p.chunk_rows,
              gr.first + gr.members == p.chunks
                  ? p.rows - (p.chunks - 1) * p.chunk_rows
                  : p.chunk_rows,
              w, sr, sm[0], nn, mu, q);
  float* groups = part + p.chunks * stride;  // the groups' partials
  if (tid < tc && ch < p.c) {
    groups[gr.g * stride + ch] = mu;
    groups[gr.g * stride + p.c + ch] = q;
    __threadfence();
  }
  if (!last_of(gr.ticket(ticket, true), gr.n)) return;
  const int rows_a_group = p.group * p.chunk_rows;
  merge_stats(groups + ch, stride, p.c, gr.n, rows_a_group,
              p.rows - (gr.n - 1) * rows_a_group, w, sr, sm[0], nn, mu, q);
  if (tid < tc && ch < p.c) {
    const float var = __fdiv_rn(q, nn);
    mean_out[ch] = mu;
    invstd_out[ch] = __fdiv_rn(1.0f, __fsqrt_rn(var + eps));
    if (update) {
      // Today's order: r * momentum, stat * (1 - momentum), their sum.
      running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], momentum),
                                   __fmul_rn(mu, rest));
      running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], momentum),
                                  __fmul_rn(var, rest));
    }
  }
}

// The apply's rows of this thread: y = fma(x, a, b) through the ReLU where
// `relu`; with R, out = relu(fma(x, a, b) + r), the sum and the ReLU in
// fp32 and the result rounded once (`res` holds r, NHWC like x).
template <typename T, int L, bool R>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x,
                                           const T* __restrict__ res,
                                           T* __restrict__ y,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ invstd,
                                           const float* __restrict__ weight,
                                           const float* __restrict__ bias,
                                           const Plan& p, int relu) {
  using V = Lanes<T, L>;
  constexpr int U = 4;
  const int by = blockDim.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= p.cv) return;
  int r0, r1;
  chunk_rows(p, blockIdx.x, r0, r1);
  float m[L], a[L], b[L];
  constants<L>(mean, invstd, weight, bias, v * L, m, a, b);
  const typename V::Raw* src = reinterpret_cast<const typename V::Raw*>(x) + v;
  const typename V::Raw* rsrc =
      R ? reinterpret_cast<const typename V::Raw*>(res) + v : nullptr;
  typename V::Raw* dst = reinterpret_cast<typename V::Raw*>(y) + v;
  int r = r0 + threadIdx.y;
  for (; r < r1; r += U * by) {
    typename V::Raw raw[U], rraw[R ? U : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * by < r1) {
        raw[u] = __ldg(src + static_cast<long long>(r + u * by) * p.cv);
        if constexpr (R) {
          rraw[u] = __ldg(rsrc + static_cast<long long>(r + u * by) * p.cv);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * by < r1) {
        float f[L];
        V::unpack(raw[u], f);
        if constexpr (R) {
          float s[L];
          V::unpack(rraw[u], s);
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const float w = __fadd_rn(affine(f[i], a[i], b[i]), s[i]);
            f[i] = passes(w) ? w : 0.0f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const float w = affine(f[i], a[i], b[i]);
            f[i] = relu && !passes(w) ? 0.0f : w;
          }
        }
        dst[static_cast<long long>(r + u * by) * p.cv] = V::pack(f);
      }
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_apply(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ mean,
                 const float* __restrict__ invstd,
                 const float* __restrict__ weight,
                 const float* __restrict__ bias, const Plan p, int relu) {
  apply_rows<T, L, false>(x, nullptr, y, mean, invstd, weight, bias, p,
                          relu);
}

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_apply_residual(const T* __restrict__ x, const T* __restrict__ res,
                          T* __restrict__ out, const float* __restrict__ mean,
                          const float* __restrict__ invstd,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias, const Plan p) {
  apply_rows<T, L, true>(x, res, out, mean, invstd, weight, bias, p, 1);
}

// The backward reduce, for the caller's block (see the source note): the
// sums of g, where g = dy through the ReLU's mask (recomputed from x where
// `relu`; with R read from the forward's out, as threshold_backward reads
// it, and g written to `gout`, NHWC, rows c apart), then the chunks' merge.
template <typename T, int L, bool R>
__device__ __forceinline__ void bwd_reduce_rows(
    const T* __restrict__ dy, const T* __restrict__ out,
    const T* __restrict__ x, T* __restrict__ gout,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ part, int* __restrict__ ticket,
    float* __restrict__ dweight, float* __restrict__ dbias,
    float* __restrict__ coef, const Plan& p, int relu) {
  using V = Lanes<T, L>;
  constexpr int U = 2;
  __shared__ float sm[2][MAX_THREADS * L];  // a row group's two sums
  __shared__ float sr[2][MAX_THREADS];      // a part's two sums
  const int tx = threadIdx.x, ty = threadIdx.y, by = blockDim.y;
  const int tc = blockDim.x * L;
  const int v = blockIdx.y * blockDim.x + tx;
  int r0, r1;
  chunk_rows(p, blockIdx.x, r0, r1);

  float s1[L], s2[L];
#pragma unroll
  for (int i = 0; i < L; ++i) s1[i] = s2[i] = 0.0f;
  if (v < p.cv) {
    float m[L], a[L], b[L];
    constants<L>(mean, invstd, weight, bias, v * L, m, a, b);
    const typename V::Raw* gsrc =
        reinterpret_cast<const typename V::Raw*>(dy) + v;
    const typename V::Raw* xsrc =
        reinterpret_cast<const typename V::Raw*>(x) + v;
    const typename V::Raw* osrc =
        R ? reinterpret_cast<const typename V::Raw*>(out) + v : nullptr;
    typename V::Raw* gdst =
        R ? reinterpret_cast<typename V::Raw*>(gout) + v : nullptr;
    for (int r = r0 + ty; r < r1; r += U * by) {
      typename V::Raw graw[U], xraw[U], oraw[R ? U : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * by < r1) {
          const long long row = r + u * by;
          graw[u] = __ldg(gsrc + row * p.gv);
          xraw[u] = __ldg(xsrc + row * p.cv);
          if constexpr (R) oraw[u] = __ldg(osrc + row * p.cv);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * by < r1) {
          float g[L], f[L];
          V::unpack(graw[u], g);
          V::unpack(xraw[u], f);
          if constexpr (R) {
            float o[L];
            V::unpack(oraw[u], o);
#pragma unroll
            for (int i = 0; i < L; ++i) {
              g[i] = passes(o[i]) ? g[i] : 0.0f;
              s1[i] += g[i];
              s2[i] = fmaf(g[i], f[i] - m[i], s2[i]);
            }
            // g is dy or 0: exact in T.
            gdst[static_cast<long long>(r + u * by) * p.cv] = V::pack(g);
          } else {
#pragma unroll
            for (int i = 0; i < L; ++i) {
              const float gi =
                  relu && !passes(affine(f[i], a[i], b[i])) ? 0.0f : g[i];
              s1[i] += gi;
              s2[i] = fmaf(gi, f[i] - m[i], s2[i]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    sm[0][ty * tc + tx * L + i] = s1[i];
    sm[1][ty * tc + tx * L + i] = s2[i];
  }
  __syncthreads();

  const int tid = ty * blockDim.x + tx;
  const int parts = blockDim.x * by / tc;
  const int j = tid % tc, k0 = tid / tc;
  const int ch = blockIdx.y * tc + j;
  if (k0 < parts) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int e = k0; e < by; e += parts) {
      a1 += sm[0][e * tc + j];
      a2 += sm[1][e * tc + j];
    }
    sr[0][tid] = a1;
    sr[1][tid] = a2;
  }
  __syncthreads();
  if (tid < tc && ch < p.c) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int k = 0; k < parts; ++k) {
      a1 += sr[0][k * tc + j];
      a2 += sr[1][k * tc + j];
    }
    float* mine = part + static_cast<long long>(blockIdx.x) * 2 * p.c;
    mine[ch] = a1;
    mine[p.c + ch] = a2;
    __threadfence();
  }
  // The chunks' merge, in two levels (`Groups`).
  const Groups gr(p);
  const Share w{tid, tc, parts, j, k0, ch};
  const long long stride = 2LL * p.c;
  if (!last_of(gr.ticket(ticket, false), gr.members)) return;
  float a1, a2;
  merge_sums(part + gr.first * stride + ch, stride, p.c, gr.members, w, sr,
             a1, a2);
  float* groups = part + p.chunks * stride;  // the groups' partials
  if (tid < tc && ch < p.c) {
    groups[gr.g * stride + ch] = a1;
    groups[gr.g * stride + p.c + ch] = a2;
    __threadfence();
  }
  if (!last_of(gr.ticket(ticket, true), gr.n)) return;
  merge_sums(groups + ch, stride, p.c, gr.n, w, sr, a1, a2);
  if (tid < tc && ch < p.c) {
    const float is = invstd[ch];
    const float norm = __fdiv_rn(1.0f, static_cast<float>(p.rows));
    dbias[ch] = a1;
    if (dweight) dweight[ch] = a2 * is;
    coef[ch] = a1 * norm;                      // mean of g
    coef[p.c + ch] = a2 * norm * is * is;      // the projection's scale
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_bwd_reduce(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ invstd,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, float* __restrict__ part,
                      int* __restrict__ ticket, float* __restrict__ dweight,
                      float* __restrict__ dbias, float* __restrict__ coef,
                      const Plan p, int relu) {
  bwd_reduce_rows<T, L, false>(dy, nullptr, x, nullptr, mean, invstd, weight,
                               bias, part, ticket, dweight, dbias, coef, p,
                               relu);
}

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_bwd_reduce_residual(
    const T* __restrict__ dy, const T* __restrict__ out,
    const T* __restrict__ x, T* __restrict__ g,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ part, int* __restrict__ ticket,
    float* __restrict__ dweight, float* __restrict__ dbias,
    float* __restrict__ coef, const Plan p) {
  bwd_reduce_rows<T, L, true>(dy, out, x, g, mean, invstd, weight, bias, part,
                              ticket, dweight, dbias, coef, p, 1);
}

template <typename T, int L>
__global__ void __launch_bounds__(MAX_THREADS)
batch_norm_bwd_elemt(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ invstd,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     const float* __restrict__ coef, T* __restrict__ dx,
                     const Plan p, int relu) {
  using V = Lanes<T, L>;
  constexpr int U = 2;
  const int by = blockDim.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= p.cv) return;
  int r0, r1;
  chunk_rows(p, blockIdx.x, r0, r1);
  float m[L], a[L], b[L], k1[L], k2[L];
  constants<L>(mean, invstd, weight, bias, v * L, m, a, b);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    k1[i] = coef[v * L + i];
    k2[i] = coef[p.c + v * L + i];
  }
  const typename V::Raw* gsrc =
      reinterpret_cast<const typename V::Raw*>(dy) + v;
  const typename V::Raw* xsrc = reinterpret_cast<const typename V::Raw*>(x) + v;
  typename V::Raw* dst = reinterpret_cast<typename V::Raw*>(dx) + v;
  for (int r = r0 + threadIdx.y; r < r1; r += U * by) {
    typename V::Raw graw[U], xraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * by < r1) {
        const long long row = r + u * by;
        graw[u] = __ldg(gsrc + row * p.gv);
        xraw[u] = __ldg(xsrc + row * p.cv);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * by < r1) {
        float g[L], f[L];
        V::unpack(graw[u], g);
        V::unpack(xraw[u], f);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const float gi =
              relu && !passes(affine(f[i], a[i], b[i])) ? 0.0f : g[i];
          // (g - mean(g) - (x - mean) * proj) * invstd * gamma, as
          // PyTorch's batch_norm_backward_elemt orders it.
          g[i] = (gi - k1[i] - (f[i] - m[i]) * k2[i]) * a[i];
        }
        dst[static_cast<long long>(r + u * by) * p.cv] = V::pack(g);
      }
    }
  }
}

// The launch geometry, as the caller planned it: a block of tv lane groups
// by MAX_THREADS / tv rows, a grid of chunks by tiles.  `ok` is false
// where the tiles do not cover the row's lane groups one tile wide each
// (the caller sized its tickets by `tiles`).
struct Launch {
  Plan p;
  dim3 grid, block;
  cudaStream_t stream;
  bool ok;
};

Launch launch_of(int rows, int c, int lanes, int tv, int chunk_rows,
                 int chunks, int tiles, void* stream, int ldg = 0,
                 int group = 1) {
  Launch l;
  l.p = Plan{rows, c, c / lanes, (ldg ? ldg : c) / lanes, chunk_rows,
             chunks, group};
  l.ok = tv >= 1 && tv <= MAX_THREADS && tiles >= 1 &&
         (tiles - 1) * tv < l.p.cv && l.p.cv <= tiles * tv;
  l.block = dim3(tv, MAX_THREADS / tv);
  l.grid = dim3(chunks, tiles);
  l.stream = static_cast<cudaStream_t>(stream);
  return l;
}

template <typename T>
int stats(const void* x, float* part, int* ticket, float* mean,
          float* invstd, float* rm, float* rv, int rows, int c, int lanes,
          int tv, int chunk_rows, int chunks, int tiles, int group,
          float eps, float momentum, float rest, int update, void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l = launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles,
                             stream, 0, group);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  if (lanes == VEC) {
    batch_norm_stats<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        xt, part, ticket, mean, invstd, rm, rv, l.p, eps, momentum, rest,
        update);
  } else {
    batch_norm_stats<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        xt, part, ticket, mean, invstd, rm, rv, l.p, eps, momentum, rest,
        update);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(const void* x, void* y, const float* mean, const float* invstd,
          const float* weight, const float* bias, int rows, int c, int lanes,
          int tv, int chunk_rows, int chunks, int tiles, int relu,
          void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l =
      launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles, stream);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (lanes == VEC) {
    batch_norm_apply<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        xt, yt, mean, invstd, weight, bias, l.p, relu);
  } else {
    batch_norm_apply<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        xt, yt, mean, invstd, weight, bias, l.p, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply_residual(const void* x, const void* res, void* out,
                   const float* mean, const float* invstd, const float* weight,
                   const float* bias, int rows, int c, int lanes, int tv,
                   int chunk_rows, int chunks, int tiles, void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l =
      launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles, stream);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (lanes == VEC) {
    batch_norm_apply_residual<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        xt, rt, ot, mean, invstd, weight, bias, l.p);
  } else {
    batch_norm_apply_residual<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        xt, rt, ot, mean, invstd, weight, bias, l.p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_reduce_residual(const void* dy, const void* out, const void* x,
                        void* g, const float* mean, const float* invstd,
                        const float* weight, const float* bias, float* part,
                        int* ticket, float* dweight, float* dbias, float* coef,
                        int rows, int c, int ldg, int lanes, int tv,
                        int chunk_rows, int chunks, int tiles, int group,
                        void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l = launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles,
                             stream, ldg, group);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* dyt = static_cast<const T*>(dy);
  const T* ot = static_cast<const T*>(out);
  const T* xt = static_cast<const T*>(x);
  T* gt = static_cast<T*>(g);
  if (lanes == VEC) {
    batch_norm_bwd_reduce_residual<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        dyt, ot, xt, gt, mean, invstd, weight, bias, part, ticket, dweight,
        dbias, coef, l.p);
  } else {
    batch_norm_bwd_reduce_residual<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        dyt, ot, xt, gt, mean, invstd, weight, bias, part, ticket, dweight,
        dbias, coef, l.p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_reduce(const void* dy, const void* x, const float* mean,
               const float* invstd, const float* weight, const float* bias,
               float* part, int* ticket, float* dweight, float* dbias,
               float* coef, int rows, int c, int ldg, int lanes, int tv,
               int chunk_rows, int chunks, int tiles, int group, int relu,
               void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l = launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles,
                             stream, ldg, group);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* g = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  if (lanes == VEC) {
    batch_norm_bwd_reduce<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        g, xt, mean, invstd, weight, bias, part, ticket, dweight, dbias, coef,
        l.p, relu);
  } else {
    batch_norm_bwd_reduce<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        g, xt, mean, invstd, weight, bias, part, ticket, dweight, dbias, coef,
        l.p, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_elemt(const void* dy, const void* x, const float* mean,
              const float* invstd, const float* weight, const float* bias,
              const float* coef, void* dx, int rows, int c, int ldg,
              int lanes, int tv, int chunk_rows, int chunks, int tiles,
              int relu, void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const Launch l = launch_of(rows, c, lanes, tv, chunk_rows, chunks, tiles,
                             stream, ldg);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* g = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* out = static_cast<T*>(dx);
  if (lanes == VEC) {
    batch_norm_bwd_elemt<T, VEC><<<l.grid, l.block, 0, l.stream>>>(
        g, xt, mean, invstd, weight, bias, coef, out, l.p, relu);
  } else {
    batch_norm_bwd_elemt<T, 1><<<l.grid, l.block, 0, l.stream>>>(
        g, xt, mean, invstd, weight, bias, coef, out, l.p, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point: x, dy, y and dx (and res, out and g of the residual
// variants) NHWC, rows = N * H * W by c channels, in the entry point's
// type; mean, invstd, weight (or null: gamma = 1), bias, the running
// statistics, dweight (or null), dbias and coef (2 * c) fp32.  x, y, dx,
// res, out and g are contiguous; dy's rows lie ldg elements apart (c where
// it is contiguous, more for a channel slice of a wider NHWC tensor, as a
// concat's backward hands it over).  lanes is 16 bytes' worth (8 bf16, 4
// fp32; c and ldg multiples of it and every tensor 16-byte aligned, which
// the caller checks) or 1; tv lane groups a tile (at most 32) and tiles of
// them across c / lanes (the last may be narrower; cudaErrorInvalidValue
// where they do not cover it); chunks x chunk_rows >= rows > (chunks - 1)
// x chunk_rows; group chunks are merged first, into ceil(chunks / group)
// groups; part holds (chunks + groups) x 2 x c floats; ticket groups + 1
// ints a tile, 0 on entry and 0 again on exit.
#define GVCNN_BN_ENTRIES(SUFFIX, T)                                           \
  extern "C" int batch_norm_stats_##SUFFIX(                                   \
      const void* x, float* part, int* ticket, float* mean, float* invstd,    \
      float* rm, float* rv, int rows, int c, int lanes, int tv,               \
      int chunk_rows, int chunks, int tiles, int group, float eps,            \
      float momentum, float rest, int update, void* stream) {                 \
    return stats<T>(x, part, ticket, mean, invstd, rm, rv, rows, c, lanes,    \
                    tv, chunk_rows, chunks, tiles, group, eps, momentum,      \
                    rest, update, stream);                                    \
  }                                                                           \
  extern "C" int batch_norm_apply_##SUFFIX(                                   \
      const void* x, void* y, const float* mean, const float* invstd,         \
      const float* weight, const float* bias, int rows, int c, int lanes,     \
      int tv, int chunk_rows, int chunks, int tiles, int relu,                \
      void* stream) {                                                         \
    return apply<T>(x, y, mean, invstd, weight, bias, rows, c, lanes, tv,     \
                    chunk_rows, chunks, tiles, relu, stream);                 \
  }                                                                           \
  extern "C" int batch_norm_bwd_reduce_##SUFFIX(                              \
      const void* dy, const void* x, const float* mean, const float* invstd,  \
      const float* weight, const float* bias, float* part, int* ticket,       \
      float* dweight, float* dbias, float* coef, int rows, int c, int ldg,    \
      int lanes, int tv, int chunk_rows, int chunks, int tiles, int group,    \
      int relu, void* stream) {                                               \
    return bwd_reduce<T>(dy, x, mean, invstd, weight, bias, part, ticket,     \
                         dweight, dbias, coef, rows, c, ldg, lanes, tv,       \
                         chunk_rows, chunks, tiles, group, relu, stream);     \
  }                                                                           \
  extern "C" int batch_norm_bwd_elemt_##SUFFIX(                               \
      const void* dy, const void* x, const float* mean, const float* invstd,  \
      const float* weight, const float* bias, const float* coef, void* dx,    \
      int rows, int c, int ldg, int lanes, int tv, int chunk_rows,            \
      int chunks, int tiles, int relu, void* stream) {                        \
    return bwd_elemt<T>(dy, x, mean, invstd, weight, bias, coef, dx, rows, c, \
                        ldg, lanes, tv, chunk_rows, chunks, tiles, relu,      \
                        stream);                                              \
  }                                                                           \
  extern "C" int batch_norm_apply_residual_##SUFFIX(                          \
      const void* x, const void* res, void* out, const float* mean,           \
      const float* invstd, const float* weight, const float* bias, int rows,  \
      int c, int lanes, int tv, int chunk_rows, int chunks, int tiles,        \
      void* stream) {                                                         \
    return apply_residual<T>(x, res, out, mean, invstd, weight, bias, rows,   \
                             c, lanes, tv, chunk_rows, chunks, tiles,         \
                             stream);                                         \
  }                                                                           \
  extern "C" int batch_norm_bwd_reduce_residual_##SUFFIX(                     \
      const void* dy, const void* out, const void* x, void* g,                \
      const float* mean, const float* invstd, const float* weight,            \
      const float* bias, float* part, int* ticket, float* dweight,            \
      float* dbias, float* coef, int rows, int c, int ldg, int lanes, int tv, \
      int chunk_rows, int chunks, int tiles, int group, void* stream) {       \
    return bwd_reduce_residual<T>(dy, out, x, g, mean, invstd, weight, bias,  \
                                  part, ticket, dweight, dbias, coef, rows,   \
                                  c, ldg, lanes, tv, chunk_rows, chunks,      \
                                  tiles, group, stream);                      \
  }

GVCNN_BN_ENTRIES(bf16, __nv_bfloat16)
GVCNN_BN_ENTRIES(f32, float)
