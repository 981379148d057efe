// Log-mel front end for Hopper (sm_90a): port of the TPU kernel
// `_kernel_radix16dif_fused` / `_log_mel_radix16dif_fused`
// (audio_classification_icbhi_tpu/ops/pallas_mel.py:1270, :1374) and its
// epilogue `_fused_epilogue` (:683).
//
// Function: reflect-padded (B, L + n_fft) f32 waveform -> frames at hop ->
// periodic Hann -> |rfft|^2 -> banded mel projection -> 10*log10(max(., 1e-10))
// -> per example: top_db against its own peak, then (training form) the
// SpecAugment mask, then normalize with the mean and the ddof=1 std over the
// valid T x n_mels cells -> (B, n_mels, T) f32.
//
// The training form (`with_masks` of the TPU kernel) takes per-example bounds
// (B, 4) f32 (f_start, f_width, t_start, t_width): a cell (t, m) is zeroed
// when f_start <= m < f_start + f_width or t_start <= t < t_start + t_width,
// compared in f32 as the TPU epilogue does (pallas_mel.py:706-713). The mask
// falls after top_db (the peak is the unmasked one) and before normalize, so
// the statistics count the zeros. The FFT pass is the same for both forms.
//
// What bounds it on this card: at the serving shape (n_fft 2048, hop 512,
// 128 mels, 5 s clips) the function reads ~0.33 MB of padded waveform and
// writes ~80 KB a clip, and needs ~10 MFLOP of f32 work a clip on the CUDA
// cores (one 2048-point complex FFT per two frames, power, banded mel sums).
// Against HBM bandwidth and the f32 CUDA-core peak the operations bound it,
// just ahead of the bytes. The dB scratch between the two passes adds
// ~160 KB a clip, which makes bytes this design's own floor. The training
// form reads 16 bytes of bounds an example more and compares each cell
// against them: neither moves the bound.
//
// What the design does about that:
// - The TPU kernel's radix-16 DIF split into 30 bf16 hi/lo DFT GEMMs existed
//   because Mosaic has no f32 matmul. Here each frame gets an O(N log N)
//   radix-2 FFT in f32 in shared memory instead of an O(N^2) DFT, and two
//   real frames ride one complex FFT (frame t as the real part, frame t+1 as
//   the imaginary part), unpacked by conjugate symmetry: half the FFTs.
// - Frames are read straight from the padded waveform (no framed copy in
//   HBM); the window, twiddles and the banded mel weights sit in shared
//   memory; the mel projection sums only each filter's nonzero band.
// - The TPU grid ran in order and carried each example's statistics across
//   its steps. Hopper blocks run in no order, so the per-example epilogue is
//   a second kernel, one block per example, over a (B, T, n_mels) f32 dB
//   scratch that the first kernel writes. It lives in log_mel_epilogue.cuh,
//   which the radix-8 kernel (log_mel_radix8dif.cu) shares.
// - Everything stays f32: bf16 anywhere in the mel projection would break the
//   1e-3 dB budget.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"

namespace {

constexpr int kSpectrumThreads = 256;
constexpr int kFramesPerBlock = 16;  // even: frames go through the FFT in pairs

// Shared-memory carve-up of the spectrum kernel, in 4-byte words.
__host__ __device__ inline size_t spectrum_smem_words(int n_fft, int n_mels, int nnz) {
  const int n_bins = n_fft / 2 + 1;
  return 2 * (size_t)n_fft      // re, im
         + (size_t)n_fft        // twiddles: n_fft/2 complex
         + 2 * (size_t)n_bins   // power spectra of the two frames
         + (size_t)nnz          // packed mel weights
         + 2 * (size_t)n_mels + 1;  // band starts, band offsets
}

__global__ void __launch_bounds__(kSpectrumThreads) log_mel_spectrum_kernel(
    const float* __restrict__ x_pad,       // (B, padded_len)
    int padded_len, int n_fft, int log2_n, int hop, int n_frames, int tiles,
    const float* __restrict__ window,      // (n_fft)
    const float2* __restrict__ twiddle,    // (n_fft/2): exp(-2 pi i k / n_fft)
    const int* __restrict__ mel_start,     // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,    // (n_mels + 1): band m is weights[off[m], off[m+1])
    const float* __restrict__ mel_weight,  // (nnz)
    int n_mels, int nnz,
    float* __restrict__ db) {              // (B, n_frames, n_mels)
  extern __shared__ float4 smem_f4[];
  float* re = reinterpret_cast<float*>(smem_f4);
  float* im = re + n_fft;
  float2* tw = reinterpret_cast<float2*>(im + n_fft);
  float* pw = reinterpret_cast<float*>(tw + n_fft / 2);
  const int n_bins = n_fft / 2 + 1;
  float* w = pw + 2 * n_bins;
  int* band_start = reinterpret_cast<int*>(w + nnz);
  int* band_off = band_start + n_mels;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int t_begin = (blockIdx.x % tiles) * kFramesPerBlock;
  const int t_end = min(t_begin + kFramesPerBlock, n_frames);
  const int half_n = n_fft / 2;

  for (int i = tid; i < half_n; i += blockDim.x) tw[i] = twiddle[i];
  for (int i = tid; i < nnz; i += blockDim.x) w[i] = mel_weight[i];
  for (int i = tid; i < n_mels; i += blockDim.x) band_start[i] = mel_start[i];
  for (int i = tid; i <= n_mels; i += blockDim.x) band_off[i] = mel_offset[i];

  const float* xb = x_pad + (size_t)b * padded_len;
  for (int t = t_begin; t < t_end; t += 2) {
    const bool pair = t + 1 < t_end;
    __syncthreads();  // constants loaded / previous pair's spectra consumed
    // Windowed load in bit-reversed order: frame t -> re, frame t+1 -> im.
    const float* fa = xb + (size_t)t * hop;
    const float* fb = fa + hop;
    for (int n = tid; n < n_fft; n += blockDim.x) {
      const int r = (int)(__brev((unsigned)n) >> (32 - log2_n));
      const float wn = window[n];
      re[r] = fa[n] * wn;
      im[r] = pair ? fb[n] * wn : 0.0f;
    }
    __syncthreads();
    // Iterative radix-2 decimation-in-time butterflies.
    for (int half = 1, stride = half_n; half < n_fft; half <<= 1, stride >>= 1) {
      for (int j = tid; j < half_n; j += blockDim.x) {
        const int pos = j & (half - 1);
        const int i0 = ((j - pos) << 1) + pos;
        const int i1 = i0 + half;
        const float2 wv = tw[pos * stride];
        const float br = re[i1], bi = im[i1];
        const float tr = wv.x * br - wv.y * bi;
        const float ti = wv.x * bi + wv.y * br;
        const float ar = re[i0], ai = im[i0];
        re[i0] = ar + tr;
        im[i0] = ai + ti;
        re[i1] = ar - tr;
        im[i1] = ai - ti;
      }
      __syncthreads();
    }
    // Z = A + iB for real frames a, b: A[k] = (Z[k] + conj Z[N-k]) / 2,
    // B[k] = (Z[k] - conj Z[N-k]) / 2i.
    for (int k = tid; k < n_bins; k += blockDim.x) {
      const int kn = (n_fft - k) & (n_fft - 1);
      const float zr = re[k], zi = im[k], nr = re[kn], ni = im[kn];
      const float ar = zr + nr, ai = zi - ni;
      const float br = zr - nr, bi = zi + ni;
      pw[k] = 0.25f * (ar * ar + ai * ai);
      pw[n_bins + k] = 0.25f * (br * br + bi * bi);
    }
    __syncthreads();
    const int n_out = (pair ? 2 : 1) * n_mels;
    for (int idx = tid; idx < n_out; idx += blockDim.x) {
      const int f = idx / n_mels;
      const int m = idx - f * n_mels;
      const float* p = pw + f * n_bins + band_start[m];
      const int lo = band_off[m], hi = band_off[m + 1];
      float acc = 0.0f;
      for (int j = lo; j < hi; ++j) acc += w[j] * p[j - lo];
      db[((size_t)b * n_frames + t + f) * n_mels + m] = 10.0f * log10f(fmaxf(acc, 1e-10f));
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: (B, padded_len) -> dB scratch (B, n_frames, n_mels).
int log_mel_spectrum_launch(int device, const void* x_pad, int batch, int padded_len,
                            int n_fft, int hop, int n_frames, const void* window,
                            const void* twiddle, const void* mel_start,
                            const void* mel_offset, const void* mel_weight, int n_mels,
                            int nnz, void* db, void* stream) {
  if (n_fft < 2 || (n_fft & (n_fft - 1)) || batch < 1 || n_frames < 1 ||
      (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len)
    return (int)cudaErrorInvalidValue;
  int log2_n = 0;
  while ((1 << log2_n) < n_fft) ++log2_n;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = spectrum_smem_words(n_fft, n_mels, nnz) * 4;
  err = cudaFuncSetAttribute(log_mel_spectrum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n_frames + kFramesPerBlock - 1) / kFramesPerBlock;
  log_mel_spectrum_kernel<<<(unsigned)(batch * tiles), kSpectrumThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)x_pad, padded_len, n_fft, log2_n, hop, n_frames, tiles,
      (const float*)window, (const float2*)twiddle, (const int*)mel_start,
      (const int*)mel_offset, (const float*)mel_weight, n_mels, nnz, (float*)db);
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
