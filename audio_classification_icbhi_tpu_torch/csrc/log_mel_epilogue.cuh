// The per-example epilogue shared by the log-mel front-end kernels: port of
// `_fused_epilogue` (audio_classification_icbhi_tpu/ops/pallas_mel.py:683),
// which every fused TPU log-mel kernel ends in.
//
// Input: a (B, n_frames, n_mels) f32 dB scratch that a spectrum kernel wrote.
// Per example: top_db against its own peak, then (training form) the
// SpecAugment mask, then normalize with the mean and the ddof=1 std over the
// valid T x n_mels cells -> (B, n_mels, n_frames) f32.
//
// The training form (`with_masks` of the TPU kernels) takes per-example
// bounds (B, 4) f32 (f_start, f_width, t_start, t_width): a cell (t, m) is
// zeroed when f_start <= m < f_start + f_width or t_start <= t < t_start +
// t_width, compared in f32 as the TPU epilogue does (pallas_mel.py:706-713).
// The mask falls after top_db (the peak is the unmasked one) and before
// normalize, so the statistics count the zeros.
//
// The TPU grid ran in order and carried each example's statistics across its
// steps. Hopper blocks run in no order, so the epilogue is a kernel of its
// own, one block per example, after the spectrum kernel.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEpilogueThreads = 1024;

template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch free from any earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  v = scratch[0];
  for (int i = 1; i < n_warps; ++i) v = op(v, scratch[i]);
  return v;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ double operator()(double a, double b) const { return a + b; }
};

// Per-example SpecAugment bounds; `on` is false for the inference form.
struct MaskBounds {
  bool on;
  float f_start, f_end, t_start, t_end;
  __device__ bool masks(int t, int m) const {
    const float fm = (float)m, ft = (float)t;
    return on && ((fm >= f_start && fm < f_end) || (ft >= t_start && ft < t_end));
  }
};

__global__ void __launch_bounds__(kEpilogueThreads) log_mel_epilogue_kernel(
    const float* __restrict__ db,      // (B, n_frames, n_mels)
    int n_frames, int n_mels, int has_top_db, float top_db, int normalize, float eps,
    const float* __restrict__ bounds,  // (B, 4) or null
    float* __restrict__ out) {         // (B, n_mels, n_frames)
  __shared__ float fscratch[32];
  __shared__ double dscratch[32];
  const int n = n_frames * n_mels;
  const float* x = db + (size_t)blockIdx.x * n;
  float* y = out + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  MaskBounds mask{bounds != nullptr, 0.0f, 0.0f, 0.0f, 0.0f};
  if (mask.on) {
    const float* bd = bounds + (size_t)blockIdx.x * 4;
    mask.f_start = bd[0];
    mask.f_end = bd[0] + bd[1];
    mask.t_start = bd[2];
    mask.t_end = bd[2] + bd[3];
  }

  float floor_db = -INFINITY;
  if (has_top_db) {
    float peak = -INFINITY;
    for (int i = tid; i < n; i += blockDim.x) peak = fmaxf(peak, x[i]);
    floor_db = block_reduce(peak, MaxOp(), fscratch) - top_db;
  }
  // The value of cell i = t * n_mels + m after top_db and the mask.
  auto cell = [&](int i) {
    const int t = i / n_mels;
    return mask.masks(t, i - t * n_mels) ? 0.0f : fmaxf(x[i], floor_db);
  };
  float mean = 0.0f, denom = 1.0f;
  if (normalize) {
    double s = 0.0;
    for (int i = tid; i < n; i += blockDim.x) s += cell(i);
    const double mean_d = block_reduce(s, SumOp(), dscratch) / n;
    double ss = 0.0;
    for (int i = tid; i < n; i += blockDim.x) {
      const double d = (double)cell(i) - mean_d;
      ss += d * d;
    }
    const double var = block_reduce(ss, SumOp(), dscratch) / (n > 1 ? n - 1 : 1);
    mean = (float)mean_d;
    denom = sqrtf((float)var) + eps;
  }
  for (int i = tid; i < n; i += blockDim.x) {
    const int m = i / n_frames;
    const int t = i - m * n_frames;
    const float v = cell(t * n_mels + m);
    y[i] = normalize ? (v - mean) / denom : v;
  }
}

// Epilogue pass: dB scratch (B, n_frames, n_mels) -> (B, n_mels, n_frames).
// `bounds` is null for the inference form, (B, 4) f32 for the training form.
inline int launch_log_mel_epilogue(int device, const void* db, int batch, int n_frames,
                                   int n_mels, int has_top_db, float top_db, int normalize,
                                   float eps, const void* bounds, void* out, void* stream) {
  if (batch < 1 || n_frames < 1 || n_mels < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  log_mel_epilogue_kernel<<<(unsigned)batch, kEpilogueThreads, 0, (cudaStream_t)stream>>>(
      (const float*)db, n_frames, n_mels, has_top_db, top_db, normalize, eps,
      (const float*)bounds, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace
