// GVCNN grouping head, forward, fp32: score bucketing -> (M, V) scheme ->
// per-group count and score sum -> group weights (mean or ceil_sum) ->
// masked max over member views (empty groups 0) -> fusion by normalized
// weight.  Outputs fused (B, C), weights (B, M) and scheme (B, M, V).
//
// Replaces the TPU kernel gvcnn_tf_tpu/ops/pallas_grouping.py::
// _pallas_forward (_grouping_kernel), one program per shape with the
// (M, V, C) masked broadcast held in VMEM.
//
// What bounds it on the H100: the launch.  Per shape it reads V x C fp32
// descriptors (~48 KB at V = 12, C = 1024) and writes ~4 KB, so at B <= 8
// the whole call moves well under 1 MB (~0.13 us at 3.35 TB/s), far below
// the few microseconds any launch costs.
//
// Design: a (B, ceil(C / 128)) grid of 128-thread blocks, one channel per
// thread, so even a B = 1 call spreads over 8 SMs (C = 1024).
// Each block recomputes its shape's group ids, counts and weights from the
// V <= 16 scores in shared memory; only channel tile 0 writes `weights`
// and `scheme`.  Each thread keeps the M running maxima of its channel in
// registers and reads its V descriptors coalesced across the block, so the
// (M, V, C) broadcast of the plain version is never formed.  The group id
// is ceilf(s * M) - 1 in fp32, clamped, exactly as the reference: this
// file must not be built with fast math, which would move scores on a j/M
// edge to another group.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int MAX_V = 16;
constexpr int MAX_M = 16;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
group_and_fuse_kernel(const float* __restrict__ scores,
                      const float* __restrict__ descs,
                      float* __restrict__ fused, float* __restrict__ weights,
                      float* __restrict__ scheme, int V, int C, int M,
                      int ceil_sum) {
  __shared__ float s_s[MAX_V];
  __shared__ int gid_s[MAX_V];
  __shared__ float cnt_s[MAX_M];
  __shared__ float w_s[MAX_M];
  __shared__ float total_s;

  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const int c = blockIdx.y * THREADS + t;

  if (t < V) {
    const float s = scores[b * V + t];
    float g = ceilf(s * static_cast<float>(M)) - 1.0f;
    g = fminf(fmaxf(g, 0.0f), static_cast<float>(M - 1));
    s_s[t] = s;
    gid_s[t] = static_cast<int>(g);
  }
  __syncthreads();

  if (t < M) {
    float cnt = 0.0f, ssum = 0.0f;
    for (int v = 0; v < V; ++v) {
      if (gid_s[v] == t) {
        cnt += 1.0f;
        ssum += s_s[v];
      }
    }
    if (ceil_sum) ssum = ceilf(ssum);
    cnt_s[t] = cnt;
    w_s[t] = ssum / fmaxf(cnt, 1.0f);  // 0 for an empty group
  }
  __syncthreads();

  if (t == 0) {
    float total = 0.0f;
    for (int j = 0; j < M; ++j) total += w_s[j];
    total_s = fmaxf(total, 1e-12f);
  }
  __syncthreads();

  if (t < M) w_s[t] = w_s[t] / total_s;
  if (blockIdx.y == 0) {
    if (t < M) weights[b * M + t] = w_s[t];
    for (int i = t; i < M * V; i += THREADS) {
      scheme[b * M * V + i] = gid_s[i % V] == i / V ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  if (c >= C) return;
  const float* d = descs + b * V * C + c;
  float mx[MAX_M];
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) mx[j] = -FLT_MAX;
  for (int v = 0; v < V; ++v) {
    const float x = d[static_cast<long long>(v) * C];
    const int g = gid_s[v];
#pragma unroll
    for (int j = 0; j < MAX_M; ++j) {
      if (j == g) mx[j] = fmaxf(mx[j], x);
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_M; ++j) {
    if (j < M && cnt_s[j] > 0.0f) acc += w_s[j] * mx[j];
  }
  fused[b * C + c] = acc;
}

}  // namespace

// scores (b, v), descs (b, v, c): fp32, contiguous.  Outputs fp32,
// contiguous: fused (b, c), weights (b, m), scheme (b, m, v).  v, m <= 16.
extern "C" int group_and_fuse_f32(const void* scores, const void* descs,
                                  void* fused, void* weights, void* scheme,
                                  int b, int v, int c, int m, int ceil_sum,
                                  void* stream) {
  // At least one channel tile, which writes weights and scheme.
  const dim3 grid(b, c > THREADS ? (c + THREADS - 1) / THREADS : 1);
  group_and_fuse_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(descs),
      static_cast<float*>(fused), static_cast<float*>(weights),
      static_cast<float*>(scheme), v, c, m, ceil_sum);
  return static_cast<int>(cudaGetLastError());
}
