// Log-mel front end for Hopper (sm_90a) at any n_fft = P * m (P a power of
// two, m odd) and any hop: one spectrum kernel for four TPU kernels of
// audio_classification_icbhi_tpu/ops/pallas_mel.py, and their epilogue
// `_fused_epilogue` (:683):
//   row 3 `_kernel_radix4dif_fused` (:1037, via `_log_mel_radix4dif_fused` :1111),
//   row 4 `_kernel_radix4_fused` (:861, via `_log_mel_radix4_fused` :947),
//   row 5 `_kernel_radix2_fused` (:723, via `_log_mel_radix2_fused` :783),
//   row 6 `_kernel_radix2` (:633, via `_log_mel_radix2` :1542).
// It runs every log-mel algorithm (rows 1-2 too) at each n_fft that
// log_mel_radix8dif.cu does not take: all but 512, 1024, 2048, 4096 and 8192,
// where that kernel, one warp a frame, is the faster (chip_smoke.py phase 16
// times the two). So rows 3-6 run here at their own shapes (768/256,
// 800/200, 1536/384, ...), and on log_mel_radix8dif.cu at n_fft 512 (row 3's
// 512/128) and 2048 (row 4's 2048/512).
//
// Function: reflect-padded (B, L + N) f32 waveform -> frames at t * hop ->
// periodic Hann -> |rfft|^2 -> banded mel projection -> 10*log10(max(., 1e-10))
// into a (B, T, n_mels) dB scratch; then the per-example epilogue of
// log_mel_epilogue.cuh (top_db, the optional SpecAugment bounds, normalize)
// -> (B, n_mels, T) f32. Rows 3-5 take both epilogue forms; row 6 is dB only
// in the TPU package, with top_db and normalize after it, which is the same
// epilogue without bounds.
//
// Why one kernel: the four TPU decompositions (radix-4 DIF, radix-4 DIT over
// mod-4 streams, radix-2 DIT over even/odd streams, row-tiled radix-2) exist to
// cut the DFT into GEMMs that fit the MXU's 128-lane tiles. They compute one
// function, and on this card an FFT in f32 on the CUDA cores computes it for
// every shape. So none of them is carried over.
//
// The decomposition, decimation in time over the odd factor. With N = P * m,
// split a frame pair's complex sequence z into the m stride-m subsequences
// z_r[n] = z[r + m n], n < P, and take their P-point DFTs Y_r. Then
//   Z[k] = sum_{r < m} W_N^{rk} Y_r[k mod P].
// Y_r comes from an in-place radix-2 DIT FFT in shared memory (bit-reversed
// load, log2 P stages, one barrier each). The m-point combine costs 2m complex
// products a bin (Z[k] and Z[N - k]); at m = 1 it is a read. m = 3 (n_fft 768,
// 1536, 3072, 6144) and m = 5 (1280, 5120) cost little; a large m (n_fft 400 =
// 16 * 25) costs 50 products a bin and stays correct.
//
// Two real frames per complex FFT: frame t as the real part and frame t + 1 of
// the same example as the imaginary part, unpacked by conjugate symmetry:
// X_a[k] = (Z[k] + conj Z[N-k]) / 2,
// X_b[k] = (Z[k] - conj Z[N-k]) / 2i. The unpacking's f32 error scales with
// the louder frame of the pair, so pairs never straddle two examples, whose
// levels can differ by tens of dB; an odd T leaves each example's last frame
// alone.
//
// What bounds it on this card: at a 512/128 serving shape (128 clips of 5 s,
// 128 mels, 626 frames a clip) the function reads 41 MB of padded waveform and
// writes 41 MB of log-mel: 0.025 ms of HBM time. Its f32 work (one 512-point
// complex FFT per two frames, power, banded mel sums, ~1.1 GFLOP) is 0.016 ms
// at the CUDA-core peak. Bytes bound it; the dB scratch between the two passes
// adds 82 MB, this two-pass design's own floor. In practice the barriers of the
// in-block FFT and latency set the pace (a right kernel first: making it fast
// is later work).
//
// What the design does about that:
// - One block per frame pair, sized to the FFT (n_fft / 4 threads, 64 to 512):
//   at n_fft 512 a block is 128 threads and 6 KB of shared memory, so 16
//   blocks share an SM and hide each other's barriers and loads.
// - Frames are read straight from the padded waveform at t * hop (any hop,
//   which row 6 needs); no framed copy goes to HBM.
// - One twiddle table W_N^j (j < N), built in float64 on the host and stored
//   in f32, serves both the FFT stages (W_{2h}^j = W_N^{j N / 2h}) and the
//   combine; it, the window and the packed mel bands are read through the
//   read-only cache, so a block stages nothing but its own frame pair.
// - Everything stays f32, as in the other log-mel sources.
//
// Limits: shared memory a block is 12 * n_fft + 8 bytes (the N complex values,
// then the two frames' power spectra); this entry point refuses an n_fft whose
// block exceeds the device's opt-in (232,448 bytes on Hopper). The wrappers
// state the limit (`MIXED_RADIX_MAX_N_FFT` in ops/mel_kernels.py, from the same
// formula): the largest power of two that fits, 16,384 (196,616 bytes), and
// raise NotImplementedError above it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"

namespace {

constexpr int kMaxThreads = 512;

// Threads a block: about four samples a thread, a whole number of warps.
inline int spectrum_threads(int n_fft) {
  const int t = (n_fft / 4 + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// Shared memory a block, in bytes: N float2, then 2 (N/2 + 1) floats.
inline size_t spectrum_smem_bytes(int n_fft) {
  return 8 * (size_t)n_fft + 8 * (size_t)(n_fft / 2 + 1);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kMaxThreads) log_mel_mixed_radix_kernel(
    const float* __restrict__ x_pad,       // (B, padded_len)
    int padded_len, int n_fft, int p, int log2_p, int m, int hop, int n_frames,
    int pairs_per_example,
    const float* __restrict__ window,      // (N)
    const float2* __restrict__ twiddle,    // (N): W_N^j = exp(-2 pi i j / N)
    const int* __restrict__ mel_start,     // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,    // (n_mels + 1): band k is weights[off[k], off[k+1])
    const float* __restrict__ mel_weight,  // (nnz)
    int n_mels,
    float* __restrict__ db) {              // (B, n_frames, n_mels)
  extern __shared__ float4 smem_f4[];
  float2* y = reinterpret_cast<float2*>(smem_f4);  // row r = Y_r, P values each
  const int n_bins = n_fft / 2 + 1;
  float* pw = reinterpret_cast<float*>(y + n_fft);  // power of frame f0, then f0 + 1
  const int tid = threadIdx.x;

  const int b = blockIdx.x / pairs_per_example;
  const int t0 = 2 * (blockIdx.x - b * pairs_per_example);
  const bool pair = t0 + 1 < n_frames;
  const float* src0 = x_pad + (size_t)b * padded_len + (size_t)t0 * hop;
  const float* src1 = src0 + hop;  // read only when `pair`
  const size_t f0 = (size_t)b * n_frames + t0;  // row of frame t0 in the dB scratch

  // Windowed load: sample i = r + m n goes to row r at bit-reversed n.
  for (int i = tid; i < n_fft; i += blockDim.x) {
    const int n = i / m, r = i - n * m;
    const int rev = log2_p ? (int)(__brev((unsigned)n) >> (32 - log2_p)) : 0;
    const float w = __ldg(window + i);
    y[r * p + rev] = make_float2(src0[i] * w, pair ? src1[i] * w : 0.0f);
  }
  __syncthreads();

  // Radix-2 DIT stages over the m rows at once: butterfly j of a stage is
  // (row, jj) with jj < P/2; its twiddle is W_{2 half}^pos = W_N^{pos N / 2 half}.
  const int half_p = p >> 1;
  const int butterflies = m * half_p;
  for (int half = 1, stride = n_fft >> 1; half < p; half <<= 1, stride >>= 1) {
    for (int j = tid; j < butterflies; j += blockDim.x) {
      const int row = j >> (log2_p - 1);
      const int jj = j - row * half_p;
      const int pos = jj & (half - 1);
      const int i0 = row * p + ((jj - pos) << 1) + pos;
      const int i1 = i0 + half;
      const float2 t = cmul(__ldg(twiddle + pos * stride), y[i1]);
      const float2 a = y[i0];
      y[i0] = make_float2(a.x + t.x, a.y + t.y);
      y[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }

  // Combine over the odd factor for bins k and N - k, then unpack the two
  // real frames' power.
  for (int k = tid; k < n_bins; k += blockDim.x) {
    const int kn = k ? n_fft - k : 0;
    const int ka = k & (p - 1), kb = kn & (p - 1);
    float2 za = y[ka], zb = y[kb];  // r = 0: W^0 = 1
    for (int r = 1, ia = k, ib = kn; r < m; ++r) {
      const float2 wa = __ldg(twiddle + ia), wb = __ldg(twiddle + ib);
      const float2 ya = cmul(wa, y[r * p + ka]), yb = cmul(wb, y[r * p + kb]);
      za.x += ya.x;
      za.y += ya.y;
      zb.x += yb.x;
      zb.y += yb.y;
      ia += k;
      if (ia >= n_fft) ia -= n_fft;
      ib += kn;
      if (ib >= n_fft) ib -= n_fft;
    }
    const float ar = za.x + zb.x, ai = za.y - zb.y;
    const float br = za.x - zb.x, bi = za.y + zb.y;
    pw[k] = 0.25f * (ar * ar + ai * ai);
    pw[n_bins + k] = 0.25f * (br * br + bi * bi);
  }
  __syncthreads();

  // Banded mel sums over each filter's nonzero weights, then dB.
  const int n_out = (pair ? 2 : 1) * n_mels;
  for (int idx = tid; idx < n_out; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int mel = idx - f * n_mels;
    const int lo = __ldg(mel_offset + mel), hi = __ldg(mel_offset + mel + 1);
    const float* pf = pw + f * n_bins + __ldg(mel_start + mel);
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc += __ldg(mel_weight + j) * pf[j - lo];
    db[(f0 + f) * n_mels + mel] = 10.0f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: (B, padded_len) -> dB scratch (B, n_frames, n_mels), for any
// n_fft from 2 whose block fits the shared memory, and any hop.
int log_mel_mixed_radix_launch(int device, const void* x_pad, int batch, int padded_len,
                               int n_fft, int hop, int n_frames, const void* window,
                               const void* twiddle, const void* mel_start,
                               const void* mel_offset, const void* mel_weight, int n_mels,
                               void* db, void* stream) {
  if (n_fft < 2 || batch < 1 || n_frames < 1 || n_mels < 1 || hop < 1 ||
      (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len)
    return (int)cudaErrorInvalidValue;
  const int pairs_per_example = (n_frames + 1) / 2;
  const long long blocks = (long long)batch * pairs_per_example;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int p = n_fft & -n_fft;  // the largest power of two dividing n_fft
  int log2_p = 0;
  while ((1 << log2_p) < p) ++log2_p;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = spectrum_smem_bytes(n_fft);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log_mel_mixed_radix_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_mixed_radix_kernel<<<(unsigned)blocks, spectrum_threads(n_fft), smem,
                               (cudaStream_t)stream>>>(
      (const float*)x_pad, padded_len, n_fft, p, log2_p, n_fft / p, hop, n_frames,
      pairs_per_example,
      (const float*)window, (const float2*)twiddle, (const int*)mel_start,
      (const int*)mel_offset, (const float*)mel_weight, n_mels, (float*)db);
  return (int)cudaGetLastError();
}

// Epilogue pass (log_mel_epilogue.cuh): dB scratch (B, n_frames, n_mels) ->
// (B, n_mels, n_frames). `bounds` is null for the inference form, (B, 4) f32
// for the training form.
int log_mel_epilogue_launch(int device, const void* db, int batch, int n_frames,
                            int n_mels, int has_top_db, float top_db, int normalize,
                            float eps, const void* bounds, void* out, void* stream) {
  return launch_log_mel_epilogue(device, db, batch, n_frames, n_mels, has_top_db, top_db,
                                 normalize, eps, bounds, out, stream);
}

}  // extern "C"
