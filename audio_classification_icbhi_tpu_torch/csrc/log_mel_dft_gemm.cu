// Log-mel front end for Hopper (sm_90a) as a dense DFT on the tensor cores:
// port of the TPU kernels `_kernel_f32` and `_kernel_bf16x3` (one
// `pallas_call` in `log_mel_pallas`,
// audio_classification_icbhi_tpu/ops/pallas_mel.py:497, :518, :1681; constants
// `_constants` :43 and `_constants_bf16x3` :87), ROADMAP.md row B7. Both names
// run this one kernel. It takes any n_fft and any hop; the wrappers send it
// the n_fft with n_fft % 4 != 0 (ops/mel_kernels.py `cuda_route`), where the
// TPU package's policy picks bf16x3, and the other two sources take the rest.
//
// Function: reflect-padded (B, L + 2 (N/2)) f32 waveform -> frames at t * hop
// (at odd N the last frame's index clamps to the padded signal's last sample,
// as the JAX package's gather does) -> periodic Hann -> |rfft|^2 -> banded mel
// projection -> 10*log10(max(., 1e-10)) into a (B, T, n_mels) dB scratch;
// then the epilogue of log_mel_epilogue.cuh without bounds (top_db and
// normalize, which the TPU package runs after its kernel) -> (B, n_mels, T).
//
// Why a GEMM: at n_fft % 4 != 0 the power-of-two factor of N is 1 or 2, so an
// FFT over it (log_mel_mixed_radix.cu) is left with a direct combine of N or
// N/2 terms a bin on the CUDA cores, itself a dense DFT. Here that dense DFT is
// a product on the tensor cores: frames (M = frames, K = N samples) times the
// [cos | sin] DFT matrix (K x 2 (N/2 + 1) columns).
//
// Precision. TF32 keeps 10 of f32's 23 mantissa bits. Each operand x splits
// into hi = tf32(x) and lo = tf32(x - hi), and each product runs as three
// m16n8k8 TF32 MMAs (lo*hi + hi*lo + hi*hi): the TPU kernel's bf16x3 split
// carried to TF32, about 21 bits an operand. The tensor cores' f32
// accumulation truncates, so one accumulator carried over all K biases the
// sum toward zero: on an H100 that missed the f64 plain version by 9.4e-4
// dB on noise at 1001/250 (cells far below their frame's level). So each
// 8-deep step's three MMAs start from zero, and the step's result is added
// into the running f32 sum on the CUDA cores, which round to nearest. Then
// the H100 stays within 2.3e-4 dB of the f64 plain version on noise and
// within 6e-5 of the f64 golden over the parity battery at 2050/512 (1.5e-5
// in the 25 dB active region at every shape), inside the 1e-3 gates of
// PERF.md section 2 (chip_smoke.py phase 18). So both names run it, the one
// function every log-mel row computes; the wrappers accept `dft_passes` and
// ignore it.
//
// What bounds it on this card: the function (a padded waveform in, a log-mel
// out) is bound by bytes, about 0.02 ms at 128 clips of 5 s. The dense DFT is
// not: at 1001/250 (M = 41,088 frames, K = 1,001, N = 1,002 columns) it is
// 82 GFLOP, 247 GFLOP of TF32 MMA work at three products, about 0.5 ms at the
// card's dense TF32 peak. So this kernel is bound by tensor-core operations
// and by how fast it feeds them; it does O(N) work a bin that an FFT over the
// odd factors would cut to O(log N) (ROADMAP.md B item 2).
//
// What the design does about that:
// - A block owns 64 frames of one example and loops over the bins itself, 64
//   at a time (128 columns: cos and sin). The mel sums accumulate in a 64 x
//   n_mels f32 array in shared memory, the counterpart of the TPU kernel's
//   `acc_ref`, in a fixed order (one thread a cell, bin tiles in order): no
//   atomics, so a run repeats bit for bit.
// - A operand: windowed samples read straight from the padded waveform at
//   t * hop + n (no framed copy in HBM), 32 samples a chunk, staged in shared
//   memory with rows padded to 36 words, so the fragment loads hit 32 banks.
// - B operand: cos / sin of 2 pi ((n k) mod N) / N, read from an N-entry
//   table W_N^j built in float64 on the host (`_twiddles_mixed_radix`). The
//   index (n k) mod N advances by additions, no division in the loop. The
//   constants are O(N); the TPU's dense windowed matrices are O(N^2), about
//   1 GB each in f32 at N = 16,383.
// - Eight warps: four along the frames (16 rows each) and two along the bins
//   (32 bins each). A warp computes the cos and the sin columns of the same
//   bins, so each thread holds matching fragments of both and forms the power
//   in registers before it goes to shared memory for the mel sums.
// - A simple kernel first: no cp.async / TMA pipeline and no wgmma; making it
//   fast is later work (ROADMAP.md B item 2).
//
// Limits: shared memory a block is 4 (64 x 36 + 32 x 136 + 64 n_mels) bytes
// (59,392 at 128 mels), so n_mels up to 804 fits the device's 232,448-byte
// opt-in; the entry point refuses more. The wrappers hold n_fft to the port's
// one limit for every log-mel row, 16,384 (`MIXED_RADIX_MAX_N_FFT`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"

namespace {

constexpr int kTileT = 64;                    // frames a block (M)
constexpr int kTileBins = 64;                 // bins a bin tile (N = 128: cos, then sin)
constexpr int kTileK = 32;                    // samples a K chunk
constexpr int kStrideA = kTileK + 4;          // A row (a frame), in words
constexpr int kStrideB = 2 * kTileBins + 8;   // B row (a sample), in words
constexpr int kStrideP = kTileBins + 1;       // power row (a frame), in words
constexpr int kThreads = 256;                 // 8 warps: 4 along frames x 2 along bins

// Shared memory a block, in bytes: the A and B chunks (the power tile reuses
// them once the product is done), then the mel accumulator.
inline size_t dft_gemm_smem_bytes(int n_mels) {
  return 4 * ((size_t)kTileT * kStrideA + (size_t)kTileK * kStrideB + (size_t)kTileT * n_mels);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds, in two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~= hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major fragment) * b (8 x 8, column fragment), TF32 in,
// f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) log_mel_dft_gemm_kernel(
    const float* __restrict__ x_pad,       // (B, padded_len)
    int padded_len, int n_fft, int hop, int n_frames, int tiles_per_example,
    const float* __restrict__ window,      // (N)
    const float2* __restrict__ twiddle,    // (N): W_N^j = exp(-2 pi i j / N)
    const int* __restrict__ mel_start,     // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,    // (n_mels + 1): band m is weights[off[m], off[m+1])
    const float* __restrict__ mel_weight,  // (nnz)
    int n_mels,
    float* __restrict__ db) {              // (B, n_frames, n_mels)
  extern __shared__ float4 smem_f4[];
  float* a_s = reinterpret_cast<float*>(smem_f4);  // [kTileT][kStrideA]: frame x sample
  float* b_s = a_s + kTileT * kStrideA;            // [kTileK][kStrideB]: sample x (cos | sin)
  float* p_s = a_s;                                // [kTileT][kStrideP]: power, after the product
  float* acc_s = b_s + kTileK * kStrideB;          // [kTileT][n_mels]: mel sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .. +16, bins 32 wn .. +32 of the tile
  const int g = lane >> 2, q = lane & 3;    // the MMA fragments' row group and column pair
  const int b = blockIdx.x / tiles_per_example;
  const int t0 = (blockIdx.x - b * tiles_per_example) * kTileT;
  const float* xb = x_pad + (size_t)b * padded_len;
  const int n_bins = n_fft / 2 + 1;
  const int n_cells = kTileT * n_mels;

  for (int i = tid; i < n_cells; i += kThreads) acc_s[i] = 0.0f;

  // B staging: thread -> bin column fill_j of the tile, samples 8 fill_s .. +8
  // of each chunk. Its twiddle index (n k) mod N for the first of them,
  // advanced by (32 k) mod N a chunk.
  const int fill_j = tid & (kTileBins - 1), fill_s = tid / kTileBins;

  for (int k_base = 0; k_base < n_bins; k_base += kTileBins) {
    const int bin = k_base + fill_j;
    const bool bin_ok = bin < n_bins;
    int idx = (int)((long long)(8 * fill_s) * bin % n_fft);
    const int step = (int)((long long)kTileK * bin % n_fft);
    float acc[4][2][4];  // [n-tile of 8 bins][cos, sin][fragment]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int cs = 0; cs < 2; ++cs)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][cs][e] = 0.0f;

    for (int n0 = 0; n0 < n_fft; n0 += kTileK) {
      __syncthreads();  // the last chunk's fragments, or the power tile, are read
      // A: 64 frames x 32 windowed samples; a warp reads one frame's 32 samples
      for (int i = tid; i < kTileT * kTileK; i += kThreads) {
        const int r = i / kTileK, c = i - r * kTileK;
        const int t = t0 + r, n = n0 + c;
        float v = 0.0f;
        if (t < n_frames && n < n_fft)
          v = xb[min(t * hop + n, padded_len - 1)] * __ldg(window + n);
        a_s[r * kStrideA + c] = v;
      }
      // B: cos and sin of this thread's bin at its 8 samples
      {
        int j = idx;
        float* col = b_s + (8 * fill_s) * kStrideB + fill_j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float2 w = make_float2(0.0f, 0.0f);
          if (bin_ok && n0 + 8 * fill_s + i < n_fft) w = __ldg(twiddle + j);
          col[i * kStrideB] = w.x;
          col[i * kStrideB + kTileBins] = w.y;
          j += bin;
          if (j >= n_fft) j -= n_fft;
        }
        idx += step;
        if (idx >= n_fft) idx -= n_fft;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 8) {
        uint32_t ah[4], al[4];
        const float* ap = a_s + (16 * wm + g) * kStrideA + kk + q;
        split_tf32(ap[0], ah[0], al[0]);                 // row g,     col q
        split_tf32(ap[8 * kStrideA], ah[1], al[1]);      // row g + 8, col q
        split_tf32(ap[4], ah[2], al[2]);                 // row g,     col q + 4
        split_tf32(ap[8 * kStrideA + 4], ah[3], al[3]);  // row g + 8, col q + 4
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int cs = 0; cs < 2; ++cs) {
            const float* bp = b_s + (kk + q) * kStrideB + cs * kTileBins + 32 * wn + 8 * nt + g;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bp[0], bh0, bl0);              // k = q,     n = g
            split_tf32(bp[4 * kStrideB], bh1, bl1);   // k = q + 4, n = g
            float prod[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this step's products
            mma_tf32(prod, al, bh0, bh1);
            mma_tf32(prod, ah, bl0, bl1);
            mma_tf32(prod, ah, bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][cs][e] += prod[e];  // rounds to nearest
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the last chunk: the power tile reuses it
    // power from matching cos / sin accumulators: element e of a fragment is
    // row g + 8 (e / 2), column 2 q + (e % 2)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wm + g + 8 * (e >> 1);
        const int c = 32 * wn + 8 * nt + 2 * q + (e & 1);
        const float re = acc[nt][0][e], im = acc[nt][1][e];
        p_s[r * kStrideP + c] = re * re + im * im;
      }
    __syncthreads();
    // mel sums over this tile's bins: one thread a (frame, mel) cell, the
    // band's bins in order (the next chunk's first barrier orders this pass
    // before the power tile is overwritten)
    const int k_end = min(k_base + kTileBins, n_bins);
    for (int i = tid; i < n_cells; i += kThreads) {
      const int r = i / n_mels, m = i - r * n_mels;
      const int start = __ldg(mel_start + m), off = __ldg(mel_offset + m);
      const int lo = max(start, k_base);
      const int hi = min(start + __ldg(mel_offset + m + 1) - off, k_end);
      if (lo >= hi) continue;
      const float* pr = p_s + r * kStrideP - k_base;
      const float* wr = mel_weight + off - start;
      float s = acc_s[i];
      for (int k = lo; k < hi; ++k) s += __ldg(wr + k) * pr[k];
      acc_s[i] = s;
    }
  }
  // each cell is read back by the thread that summed it
  for (int i = tid; i < n_cells; i += kThreads) {
    const int r = i / n_mels, m = i - r * n_mels;
    if (t0 + r < n_frames)
      db[((size_t)b * n_frames + t0 + r) * n_mels + m] = 10.0f * log10f(fmaxf(acc_s[i], 1e-10f));
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: (B, padded_len) -> dB scratch (B, n_frames, n_mels), for any
// n_fft from 2 and any hop. The last frame may run one sample past the padded
// signal (odd n_fft); its index clamps.
int log_mel_dft_gemm_launch(int device, const void* x_pad, int batch, int padded_len,
                            int n_fft, int hop, int n_frames, const void* window,
                            const void* twiddle, const void* mel_start, const void* mel_offset,
                            const void* mel_weight, int n_mels, void* db, void* stream) {
  if (n_fft < 2 || batch < 1 || n_frames < 1 || n_mels < 1 || hop < 1 ||
      (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len + 1 ||
      (size_t)padded_len + n_fft > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  const int tiles_per_example = (n_frames + kTileT - 1) / kTileT;
  const long long blocks = (long long)batch * tiles_per_example;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = dft_gemm_smem_bytes(n_mels);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log_mel_dft_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  log_mel_dft_gemm_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x_pad, padded_len, n_fft, hop, n_frames, tiles_per_example,
      (const float*)window, (const float2*)twiddle, (const int*)mel_start,
      (const int*)mel_offset, (const float*)mel_weight, n_mels, (float*)db);
  return (int)cudaGetLastError();
}

// Epilogue pass (log_mel_epilogue.cuh): dB scratch (B, n_frames, n_mels) ->
// (B, n_mels, n_frames); the B7 rows never take SpecAugment bounds, so
// `bounds` is null from the wrappers.
int log_mel_epilogue_launch(int device, const void* db, int batch, int n_frames,
                            int n_mels, int has_top_db, float top_db, int normalize,
                            float eps, const void* bounds, void* out, void* stream) {
  return launch_log_mel_epilogue(device, db, batch, n_frames, n_mels, has_top_db, top_db,
                                 normalize, eps, bounds, out, stream);
}

}  // extern "C"
