// The ConvBlock epilogue of LightweightCNN for Hopper (sm_90a): BatchNorm ->
// ReLU -> MaxPool2 (floor) -> channel dropout on a convolution's output, in
// the convolution's dtype (bf16, fp16 or f32), forward and backward
// (ops/conv_epilogue.py wraps it; models/cnn.py ConvBlock calls it).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm, ReLU, the
// max-pool and dropout to flax and XLA, which fuse them. The port ran them as
// torch's chain after each cuDNN convolution: an f32 copy of the activation
// (which autograd kept), cuDNN's BatchNorm in f32, a cast back, ReLU, the
// max-pool with int64 indices and dropout's `where` and divide, each a pass
// over device memory, and the backward mirrored it with two more full-size
// casts. At config.yaml (8 s clips, batch 32 x 2, bf16) that chain took about
// 4.4 of the 7.4 ms train step, and the convolutions 0.38 (PERF.md section
// 5): about 34 bytes moved per conv-output element forward and 42 backward.
//
// What bounds it: bytes. The function reads its input once and writes a
// quarter of it (the pool); the least it can move is about 2.75 bytes per
// bf16 conv-output element forward (y, the pooled output, a code byte per
// pooled output) and 4.75 backward (y, the pooled gradient and code, dx).
// This design moves about 4.75 forward (Stats reads y, Apply reads it again)
// and 7.5 backward (Reduce and dx each read y; g and the code twice).
//
// Function (x = y in f32; n = B*H*W per channel):
//   forward, batch statistics (train mode): mean, biased var over (B, H, W);
//     the running statistics move flax's way, new = (1 - m) old + m batch,
//     m = 0.1, with the biased variance, and num_batches_tracked += 1;
//   forward, running statistics (eval mode): mean, var are the running ones;
//   v = round_T((x - mean) * invstd * w + b), invstd = 1 / sqrt(var + eps),
//     rounded to T where torch's `.to(dtype)` after the f32 BatchNorm rounds;
//   r = ReLU(v) (NaN passes); the 2x2 window's maximum by torch's rule (scan
//     order row, then column; a later element wins only if greater, or NaN);
//     rows and columns past 2*(H/2), 2*(W/2) take no part (floor pooling);
//   out = keep[b, c] ? round_T(max * s) : 0 with s = 1 / (1 - p) as the f32
//     reciprocal torch's CUDA divide of a tensor by a scalar multiplies by;
//     without dropout out = max;
//   code[b, ho, wo, c] = the winner's position 0..3 (dh * 2 + dw), or 4 where
//     no gradient passes: ReLU gave 0 at the winner, or the channel was
//     dropped.
//   backward: dy = round_T(g * s) at the winner of each window, 0 elsewhere
//     (the bf16 dropout backward's rounding; the max-pool and ReLU backward
//     move it exactly); x_hat = (x - mean) * invstd; with batch statistics
//     dx = w invstd (dy - sum(dy) / n - x_hat sum(dy x_hat) / n), with
//     running ones dx = w invstd dy, rounded to T where the backward of
//     torch's `x.float()` rounds; grad_bias = sum(dy), grad_weight =
//     sum(dy x_hat), in f32.
//
// Layout: y, out, dx and g are channels-last (NHWC); code is (B, H/2, W/2, C)
// bytes; C % 8 == 0 and C / 8 divides 256 (C = 32 .. 256 here).
//
// The design: a thread takes 8 consecutive channels of one pixel (Stats,
// dx) or of one 2x2 window (Apply, Reduce): one 16-byte load a pixel in bf16
// and fp16 (two in f32), so a warp reads whole contiguous rows of the NHWC
// tensor. Six kernels, three a pass:
// - Stats: each thread sums its rows' x - x0 and (x - x0)^2 about its first
//   value x0 in f32, converts them to (count, mean, M2), and the CTA merges
//   its threads' triples in a fixed tree (Chan, Golub and LeVeque: mean +=
//   delta n_b / n, M2 += M2_b + delta^2 n_a n_b / n) into one partial a
//   channel. Finalize merges the CTAs' partials, a warp a channel (each lane
//   every 32nd partial in block order, about the first partial's mean, then
//   a fixed shuffle tree), writes
//   mean and var and moves the running statistics. No atomics: a replay of
//   a captured step gives equal bits.
// - Apply: the window's four vectors, normalized in f32 with the channel's
//   scale and shift (staged in shared memory), rounded, ReLU, max, dropout,
//   one 16-byte store of the pooled output and 8 code bytes. The code replaces
//   the chain's int64 indices (8 bytes a pooled output) and its ReLU mask,
//   and autograd keeps y (T) and the code where the chain kept an f32 copy
//   as well.
// - Reduce: dy at each window's winner from g and the code (a window whose
//   eight codes are all 4 reads nothing more); x at the winner from the
//   window's four vectors. A 32-byte sector of y holds one pixel's 16
//   channels, and the winners of 16 channels fall on all four pixels of a
//   window almost always, so reading only the winners' bytes would move the
//   same sectors. Per-thread sums, a fixed CTA tree, Finalize in block order.
// - dx: every conv-output pixel, the floor-dropped row and column too (dy
//   = 0 there): its y vector, and g and the code of its window (shared by
//   the window's four pixels through L1).
// The Stats and Reduce grids are at most four CTAs an SM (the wrapper sizes
// them and their partials), so a Finalize lane merges at most 17 partials;
// Apply and dx walk their items with as many CTAs as fit.
// Every stage is its own function over (channel, pixel) items: the ResNet's
// BatchNorm -> ReLU and BatchNorm -> add -> ReLU reuse Stats, Finalize and
// the dx formula, with an elementwise Apply and Reduce in place of the
// window ones.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                    // channels a thread
constexpr int kMaxC = 1024;
constexpr int kFinalChannels = kThreads / 32;  // Finalize: a warp a channel
constexpr int kNoGradient = 4;             // code: no gradient passes
constexpr uint32_t kNoGradientWord = 0x04040404u;

// 8 consecutive elements of T <-> f32, and T's rounding of an f32.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[kVec]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Vec<__half> {
  static __device__ __forceinline__ void load(const __half* p, float (&f)[kVec]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p, const float (&f)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 v = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <>
struct Vec<float> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[kVec]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

__device__ __forceinline__ int byte_of(uint2 w, int j) {
  return (int)(((j < 4 ? w.x : w.y) >> (8 * (j & 3))) & 0xffu);
}

// Chan, Golub and LeVeque: (n, mean, m2) += (nb, meanb, m2b).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float meanb, float m2b) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float delta = meanb - mean;
  const float share = nb / total;
  mean = fmaf(delta, share, mean);
  m2 = m2 + m2b + delta * delta * n * share;
  n = total;
}

// The CTA's per-thread partials sh[k][slot * C + c] (slots = kThreads / V,
// a power of two) merged into slot 0 by a fixed tree, then stored as this
// CTA's partial part[k][c][blockIdx.x]. K = 3: (n, mean, m2) by Chan; K = 2:
// sums.
template <int K>
__device__ __forceinline__ void cta_partial(float (*sh)[kThreads * kVec], int slots, int C,
                                            float* __restrict__ part) {
  __syncthreads();
  for (int half = slots / 2; half > 0; half /= 2) {
    for (int i = threadIdx.x; i < half * C; i += kThreads) {
      const int o = i + half * C;
      if constexpr (K == 3) {
        chan_merge(sh[0][i], sh[1][i], sh[2][i], sh[0][o], sh[1][o], sh[2][o]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) sh[k][i] += sh[k][o];
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < C; c += kThreads)
#pragma unroll
    for (int k = 0; k < K; ++k) part[((size_t)k * C + c) * gridDim.x + blockIdx.x] = sh[k][c];
}

// Stats: per-CTA (n, mean, M2) of every channel over the rows this CTA
// visits (row r = pixel: C contiguous elements). Partials [3][C][G].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ y, long long rows, int C, float* __restrict__ part) {
  __shared__ float sh[3][kThreads * kVec];
  const int V = C / kVec, slots = kThreads / V;
  const int v = threadIdx.x % V, slot = threadIdx.x / V;
  const long long stride = (long long)gridDim.x * slots;
  long long r = (long long)blockIdx.x * slots + slot;
  float x0[kVec], s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) x0[j] = s1[j] = s2[j] = 0.f;
  if (r < rows) Vec<T>::load(y + r * C + v * kVec, x0);
  int n = 0;
  for (; r + 3 * stride < rows; r += 4 * stride, n += 4) {
    float x[4][kVec];
#pragma unroll
    for (int u = 0; u < 4; ++u) Vec<T>::load(y + (r + u * stride) * C + v * kVec, x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = x[u][j] - x0[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
  }
  for (; r < rows; r += stride, ++n) {
    float x[kVec];
    Vec<T>::load(y + r * C + v * kVec, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = x[j] - x0[j];
      s1[j] += d;
      s2[j] = fmaf(d, d, s2[j]);
    }
  }
  const float nf = (float)n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = slot * C + v * kVec + j;
    float m2 = n ? s2[j] - s1[j] * s1[j] / nf : 0.f;
    m2 = m2 < 0.f ? 0.f : m2;  // a NaN stays NaN
    sh[0][i] = nf;
    sh[1][i] = n ? x0[j] + s1[j] / nf : 0.f;
    sh[2][i] = m2;
  }
  cta_partial<3>(sh, slots, C, part);
}

// Finalize: one warp a channel: lane l merges the partials g = l, l + 32,
// ... in order (sums of n, n (mean - x0) and M2 + n (mean - x0)^2 about the
// first partial's mean x0), then a fixed shuffle tree into lane 0 (Chan).
// kStats: part is [3][C][G] (n, mean, m2) -> mean, var (biased) and the
// running statistics; else part is [2][C][G] sums (dy, dy (x - mean)) ->
// sums[0] = sum(dy), sums[1] = sum(dy (x - mean)) invstd.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
    finalize_kernel(const float* __restrict__ part, int G, int C, float* __restrict__ mean,
                    float* __restrict__ var, float* running_mean, float* running_var,
                    long long* batches, float momentum, float eps, float* __restrict__ sums) {
  const int lane = threadIdx.x % 32, c = blockIdx.x * kFinalChannels + threadIdx.x / 32;
  if (kStats && batches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *batches += 1;
  if (c >= C) return;  // the whole warp
  const float* p = part + (size_t)c * G;
  const size_t k = (size_t)C * G;
  float a = 0.f, b = 0.f, m = 0.f;
  if constexpr (kStats) {
    // the lane's partials about the first CTA's mean, x0: sums with no
    // division a partial, then the lane's (n, mean, M2) (each CTA's mean is
    // near x0, so the sums do not cancel)
    const float x0 = p[k];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int g = lane; g < G; g += 32) {
      const float n = p[g], d = p[k + g] - x0;
      a += n;
      s1 = fmaf(n, d, s1);
      s2 += p[2 * k + g] + n * d * d;
    }
    if (a > 0.f) {
      b = x0 + s1 / a;
      m = s2 - s1 * s1 / a;
      m = m < 0.f ? 0.f : m;  // a NaN stays NaN
    }
  } else {
#pragma unroll 4
    for (int g = lane; g < G; g += 32) {
      a += p[g];
      b += p[k + g];
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    const float ao = __shfl_down_sync(0xffffffffu, a, off);
    const float bo = __shfl_down_sync(0xffffffffu, b, off);
    const float mo = __shfl_down_sync(0xffffffffu, m, off);
    if constexpr (kStats) {
      chan_merge(a, b, m, ao, bo, mo);
    } else {
      a += ao;
      b += bo;
    }
  }
  if (lane != 0) return;
  if constexpr (kStats) {
    const float s2 = m / a;
    mean[c] = b;
    var[c] = s2;
    if (running_mean != nullptr) {
      running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * b;
      running_var[c] = (1.f - momentum) * running_var[c] + momentum * s2;
    }
  } else {
    sums[c] = a;
    sums[C + c] = b * (1.f / sqrtf(var[c] + eps));
  }
}

__device__ __forceinline__ float relu(float x) { return (x > 0.f || isnan(x)) ? x : 0.f; }

// Apply: one thread a (window, 8 channels) item; items = B * Ho * Wo * V in
// NHWC order, so item i's output vector and code bytes sit at i * 8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ y, int H, int W, int C, int Ho, int Wo, long long items,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ weight, const float* __restrict__ bias, float eps,
                 const uint8_t* __restrict__ keep, float scale, T* __restrict__ out,
                 uint8_t* __restrict__ code) {
  __shared__ float alpha_s[kMaxC], beta_s[kMaxC];
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = weight[c] * (1.f / sqrtf(var[c] + eps));
    alpha_s[c] = a;
    beta_s[c] = bias[c] - mean[c] * a;
  }
  __syncthreads();
  const int V = C / kVec;
  const long long row = (long long)W * C;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < items;
       i += (long long)gridDim.x * kThreads) {
    const int v = (int)(i % V);
    long long t = i / V;
    const int wo = (int)(t % Wo);
    t /= Wo;
    const int ho = (int)(t % Ho);
    const long long b = t / Ho;
    const T* p = y + ((b * H + 2 * ho) * W + 2 * wo) * C + v * kVec;
    float x[4][kVec];
    Vec<T>::load(p, x[0]);
    Vec<T>::load(p + C, x[1]);
    Vec<T>::load(p + row, x[2]);
    Vec<T>::load(p + row + C, x[3]);
    uint2 kept = make_uint2(0x01010101u, 0x01010101u);
    if (keep != nullptr) kept = *reinterpret_cast<const uint2*>(keep + b * C + v * kVec);
    float o[kVec];
    uint2 cw = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float a = alpha_s[v * kVec + j], sh = beta_s[v * kVec + j];
      float best = -INFINITY;
      int at = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float r = relu(Vec<T>::round(fmaf(x[k][j], a, sh)));
        if (r > best || isnan(r)) {
          best = r;
          at = k;
        }
      }
      const bool k = byte_of(kept, j) != 0;
      const bool live = k && (best > 0.f || isnan(best));
      o[j] = keep == nullptr ? best : (k ? Vec<T>::round(best * scale) : 0.f);
      const uint32_t cb = (uint32_t)(live ? at : kNoGradient) << (8 * (j & 3));
      if (j < 4) cw.x |= cb; else cw.y |= cb;
    }
    Vec<T>::store(out + i * kVec, o);
    if (code != nullptr) *reinterpret_cast<uint2*>(code + i * kVec) = cw;
  }
}

// Reduce: per-CTA sums of dy and dy (x - mean) over the windows it visits,
// dy at each window's winner. Partials [2][C][G].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                  const uint8_t* __restrict__ code, int H, int W, int C, int Ho, int Wo,
                  long long items, const float* __restrict__ mean, float scale,
                  float* __restrict__ part) {
  __shared__ float sh[2][kThreads * kVec];
  const int V = C / kVec, slots = kThreads / V;
  const int v = threadIdx.x % V, slot = threadIdx.x / V;  // i % V == v: kThreads % V == 0
  const long long row = (long long)W * C;
  float mu[kVec], s0[kVec], s1[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mu[j] = mean[v * kVec + j];
    s0[j] = s1[j] = 0.f;
  }
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < items;
       i += (long long)gridDim.x * kThreads) {
    const uint2 cw = *reinterpret_cast<const uint2*>(code + i * kVec);
    if (cw.x == kNoGradientWord && cw.y == kNoGradientWord) continue;
    long long t = i / V;
    const int wo = (int)(t % Wo);
    t /= Wo;
    const int ho = (int)(t % Ho);
    const long long b = t / Ho;
    const T* p = y + ((b * H + 2 * ho) * W + 2 * wo) * C + v * kVec;
    float gv[kVec], x[4][kVec];
    Vec<T>::load(g + i * kVec, gv);
    Vec<T>::load(p, x[0]);
    Vec<T>::load(p + C, x[1]);
    Vec<T>::load(p + row, x[2]);
    Vec<T>::load(p + row + C, x[3]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int at = byte_of(cw, j);
      if (at < kNoGradient) {
        const float dy = Vec<T>::round(gv[j] * scale);
        const float xw = at == 0 ? x[0][j] : at == 1 ? x[1][j] : at == 2 ? x[2][j] : x[3][j];
        s0[j] += dy;
        s1[j] = fmaf(dy, xw - mu[j], s1[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = slot * C + v * kVec + j;
    sh[0][i] = s0[j];
    sh[1][i] = s1[j];
  }
  cta_partial<2>(sh, slots, C, part);
}

// dx: one thread a (pixel, 8 channels) item; items = B * H * W * V in NHWC
// order, so item i's y and dx vectors sit at i * 8. inv_n = 1 / n with batch
// statistics, 0 with running ones.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ y, const T* __restrict__ g, const uint8_t* __restrict__ code,
              int H, int W, int C, int Ho, int Wo, long long items,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ weight, const float* __restrict__ sums, float eps,
              float inv_n, float scale, T* __restrict__ dx) {
  __shared__ float mean_s[kMaxC], invstd_s[kMaxC], alpha_s[kMaxC], k1_s[kMaxC], k2_s[kMaxC];
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float invstd = 1.f / sqrtf(var[c] + eps);
    mean_s[c] = mean[c];
    invstd_s[c] = invstd;
    alpha_s[c] = weight[c] * invstd;
    k1_s[c] = sums[c] * inv_n;
    k2_s[c] = sums[C + c] * inv_n;
  }
  __syncthreads();
  const int V = C / kVec;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < items;
       i += (long long)gridDim.x * kThreads) {
    const int v = (int)(i % V);
    long long t = i / V;
    const int w = (int)(t % W);
    t /= W;
    const int h = (int)(t % H);
    const long long b = t / H;
    float x[kVec], dy[kVec];
    Vec<T>::load(y + i * kVec, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dy[j] = 0.f;
    if (h < 2 * Ho && w < 2 * Wo) {
      const long long wi = ((b * Ho + (h >> 1)) * Wo + (w >> 1)) * V + v;
      const int pos = (h & 1) * 2 + (w & 1);
      const uint2 cw = *reinterpret_cast<const uint2*>(code + wi * kVec);
      float gv[kVec];
      Vec<T>::load(g + wi * kVec, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (byte_of(cw, j) == pos) dy[j] = Vec<T>::round(gv[j] * scale);
    }
    float o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = v * kVec + j;
      const float xh = (x[j] - mean_s[c]) * invstd_s[c];
      o[j] = alpha_s[c] * (dy[j] - k1_s[c] - xh * k2_s[c]);
    }
    Vec<T>::store(dx + i * kVec, o);
  }
}

// The grid of a kernel that walks `items` threads' work: as many CTAs as
// fit the device at once (asked of the runtime once a kernel and device),
// no more than the items need.
template <auto Kernel>
cudaError_t walk_grid(int device, long long items, int& grid) {
  constexpr int kDevices = 64;
  static long long fit[kDevices];  // 0: not asked yet
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (fit[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    fit[device] = (long long)per_sm * sms;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  grid = (int)(need < fit[device] ? need : fit[device]);
  return cudaSuccess;
}

bool shape_ok(int batch, int h, int w, int c) {
  return batch >= 1 && h >= 2 && w >= 2 && c >= kVec && c % kVec == 0 && c <= kMaxC &&
         kThreads % (c / kVec) == 0;
}

template <typename T>
int forward(int device, const void* y, int batch, int h, int w, int c, const void* weight,
            const void* bias, float eps, float momentum, void* mean, void* var,
            void* running_mean, void* running_var, void* batches, void* part, int blocks,
            const void* keep, float scale, void* out, void* code, cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2, v = c / kVec;
  const long long rows = (long long)batch * h * w;
  if (blocks > 0) {
    stats_kernel<T><<<blocks, kThreads, 0, stream>>>((const T*)y, rows, c, (float*)part);
    finalize_kernel<true><<<(c + kFinalChannels - 1) / kFinalChannels, kThreads, 0, stream>>>(
        (const float*)part, blocks, c, (float*)mean, (float*)var, (float*)running_mean,
        (float*)running_var, (long long*)batches, momentum, eps, nullptr);
  }
  const long long items = (long long)batch * ho * wo * v;
  int grid = 0;
  cudaError_t err = walk_grid<apply_kernel<T>>(device, items, grid);
  if (err != cudaSuccess) return (int)err;
  apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)y, h, w, c, ho, wo, items, (const float*)mean, (const float*)var,
      (const float*)weight, (const float*)bias, eps, (const uint8_t*)keep, scale, (T*)out,
      (uint8_t*)code);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(int device, const void* y, const void* g, const void* code, int batch, int h,
             int w, int c, const void* mean, const void* var, const void* weight, float eps,
             int batch_stats, float scale, void* part, int blocks, void* sums, void* dx,
             cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2, v = c / kVec;
  const long long windows = (long long)batch * ho * wo * v;
  reduce_kernel<T><<<blocks, kThreads, 0, stream>>>((const T*)y, (const T*)g,
                                                    (const uint8_t*)code, h, w, c, ho, wo,
                                                    windows, (const float*)mean, scale,
                                                    (float*)part);
  finalize_kernel<false><<<(c + kFinalChannels - 1) / kFinalChannels, kThreads, 0, stream>>>(
      (const float*)part, blocks, c, nullptr, (float*)var, nullptr, nullptr, nullptr, 0.f, eps,
      (float*)sums);
  const long long items = (long long)batch * h * w * v;
  int grid = 0;
  cudaError_t err = walk_grid<dx_kernel<T>>(device, items, grid);
  if (err != cudaSuccess) return (int)err;
  const float inv_n = batch_stats ? 1.f / (float)((long long)batch * h * w) : 0.f;
  dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)y, (const T*)g, (const uint8_t*)code, h, w, c, ho, wo, items,
      (const float*)mean, (const float*)var, (const float*)weight, (const float*)sums, eps,
      inv_n, scale, (T*)dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 f32, 1 f16, 2 bf16. y (B, C, H, W) channels-last; weight, bias,
// mean, var (C,) f32. blocks > 0: batch statistics, Stats on `blocks` CTAs
// into part [3][C][blocks], mean and var written, running_mean / running_var
// (may be null) moved and *batches (int64, may be null) incremented; blocks
// == 0: mean and var are read (the running statistics). keep (B, C) bytes or
// null (no dropout; scale is then not read); code (B, H/2, W/2, C) bytes or
// null (not written); out (B, C, H/2, W/2) channels-last.
int conv_epilogue_forward(int device, int dtype, const void* y, int batch, int h, int w, int c,
                          const void* weight, const void* bias, float eps, float momentum,
                          void* mean, void* var, void* running_mean, void* running_var,
                          void* batches, void* part, int blocks, const void* keep, float scale,
                          void* out, void* code, void* stream) {
  if (!shape_ok(batch, h, w, c) || blocks < 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return forward<float>(device, y, batch, h, w, c, weight, bias, eps, momentum, mean, var,
                          running_mean, running_var, batches, part, blocks, keep, scale, out,
                          code, s);
  if (dtype == 1)
    return forward<__half>(device, y, batch, h, w, c, weight, bias, eps, momentum, mean, var,
                           running_mean, running_var, batches, part, blocks, keep, scale, out,
                           code, s);
  return forward<__nv_bfloat16>(device, y, batch, h, w, c, weight, bias, eps, momentum, mean,
                                var, running_mean, running_var, batches, part, blocks, keep,
                                scale, out, code, s);
}

// g (B, C, H/2, W/2) channels-last in y's dtype; code, mean, var as the
// forward left them; Reduce on `blocks` CTAs into part [2][C][blocks];
// sums (2, C) f32: sum(dy) (the bias gradient), sum(dy x_hat) (the weight
// gradient); dx like y. batch_stats: 1 if the forward used batch statistics.
// scale: the forward's (1 without dropout).
int conv_epilogue_backward(int device, int dtype, const void* y, const void* g, const void* code,
                           int batch, int h, int w, int c, const void* mean, const void* var,
                           const void* weight, float eps, int batch_stats, float scale,
                           void* part, int blocks, void* sums, void* dx, void* stream) {
  if (!shape_ok(batch, h, w, c) || blocks < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return backward<float>(device, y, g, code, batch, h, w, c, mean, var, weight, eps,
                           batch_stats, scale, part, blocks, sums, dx, s);
  if (dtype == 1)
    return backward<__half>(device, y, g, code, batch, h, w, c, mean, var, weight, eps,
                            batch_stats, scale, part, blocks, sums, dx, s);
  return backward<__nv_bfloat16>(device, y, g, code, batch, h, w, c, mean, var, weight, eps,
                                 batch_stats, scale, part, blocks, sums, dx, s);
}

}  // extern "C"
