// Log-mel front end for Hopper (sm_90a) by radix-8 decimation in frequency:
// port of the TPU kernel `_kernel_radix8dif_fused` / `_log_mel_radix8dif_fused`
// (audio_classification_icbhi_tpu/ops/pallas_mel.py:1193, :1456; constants
// `_constants_radix8dif` :307-395) and its epilogue `_fused_epilogue` (:683).
// It takes n_fft 1024, 2048, 4096 and 8192 at any hop, and there it runs every
// log-mel algorithm: row 1 `_kernel_radix16dif_fused` (:1270) at config.yaml's
// 2048/512, and rows 3-6 at those n_fft. At each of them it is faster than
// log_mel_mixed_radix.cu, which takes every other n_fft (chip_smoke.py phase
// 16 times the two).
//
// Function: reflect-padded (B, L + N) f32 waveform -> frames at hop ->
// periodic Hann -> |rfft|^2 -> banded mel projection -> 10*log10(max(., 1e-10))
// -> the per-example epilogue of log_mel_epilogue.cuh (top_db, the optional
// SpecAugment bounds, normalize) -> (B, n_mels, T) f32.
//
// The decomposition (pallas_mel.py:311-338). A windowed frame x of N samples
// splits into eight contiguous eighth-blocks b_j[n] = x[jE + n], E = N/8, and
//   X[8m + r] = DFT_E{ u_r[n] W_N^{rn} }[m],   u_r[n] = sum_j W_8^{rj} b_j[n].
// The W_8 coefficients are 0, +-1, +-sqrt(1/2): u_0 and u_4 are real, u_1,
// u_2, u_3 complex. For real input only r = 0..4 are needed: bins with
// 8m + r > N/2 are the conjugates of bins N - (8m + r) (classes 7, 6, 5), so
// they carry the same power and land on those bins. Class 0 keeps m <= E/2
// and class 4 keeps m < E/2 (its other half repeats it mirrored).
//
// Why u_0 and u_4 W_N^{4n} do not share one complex FFT: the two-for-one
// trick (z = a + i b, unpacked by conjugate symmetry) needs two REAL
// sequences, and u_4 W_N^{4n} is complex (its DFT is u_4's at half-integer
// frequencies). Each class therefore gets its own E-point complex FFT: five
// per frame, u_0's with a zero imaginary part.
//
// What bounds it on this card: at the analyzer's shape (n_fft 1024, hop 256,
// 128 mels, 64 windows of 0.5 s = 2,048 frames) the function reads ~2.3 MB
// of padded waveform and writes ~1 MB: about 1 us of HBM time, and ~61 MFLOP
// of f32 work, about 1 us of CUDA-core time. Neither binds: the kernel is
// bound by latency and by how many frames it keeps in flight. (One 256-thread
// block running one FFT at a time behind a block barrier per stage would give
// 128 blocks of 16 serialised frames.)
//
// What the design does about that:
// - One warp per frame, eight warps a block, every frame of the batch in
//   flight at once (2,048 warps over 132 SMs at the analyzer's shape).
// - Lane l owns the samples n = l + 32i of every eighth-block (i < E/32), so
//   neighbouring lanes read neighbouring addresses. It windows them and does
//   the W_8 butterflies in registers with the TPU kernel's own expressions
//   (pallas_mel.py:1221-1236), then stores u_0 .. u_4 to the warp's slice of
//   shared memory: the lane reads back only what it wrote, so no barrier.
// - Each class is twiddled by W_N^{rn} from a table in shared memory (laid
//   out [r-1][n], conflict-free) and goes through an E-point radix-2 DIF FFT
//   held in registers: the stages whose butterflies stay inside a lane first,
//   then five stages across lanes by __shfl_xor_sync. No shared memory and
//   no barrier inside the FFT; the stage twiddles W_{2h}^j sit in one table
//   at [h - 1 + j], so a warp reads consecutive words.
// - The FFT leaves bin m in bit-reversed position; each lane writes the power
//   of its bins at their natural index k = 8m + r (or N - k) into the warp's
//   power buffer, skewed by one word every 32 to spread the banks. Then, after
//   one __syncwarp, lane l sums the mel bands l, l + 32, ... over their nonzero
//   weights only (`mel_bands` in ops/mel_kernels.py) and writes dB to the
//   (B, T, n_mels) scratch, neighbouring lanes to neighbouring mels.
// - The TPU kernel's bf16 hi/lo DFT GEMMs exist because Mosaic has no f32
//   matmul. Here everything stays f32: a bf16 mel projection alone would
//   break the 1e-3 dB budget.
// - The epilogue is log_mel_epilogue.cuh's kernel, shared with
//   log_mel_mixed_radix.cu, so the training form (nullable (B, 4) bounds)
//   comes with it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Index of power bin k in a warp's power buffer: one word of skew every 32
// bins, so that the 32 lanes' bit-reversed bins (k = 32q + c at P = 4) fall
// on distinct banks.
__device__ __forceinline__ int pw_index(int k) { return k + (k >> 5); }

// Shared-memory carve-up, in 4-byte words: the block's constants, then one
// slice per warp (the five sequences u_r, 8E words, then its power buffer).
struct SmemLayout {
  int e, n_mels, nnz;
  __host__ __device__ int tw_rn() const { return 0; }                  // 4E float2
  __host__ __device__ int tw_fft() const { return 8 * e; }             // E float2
  __host__ __device__ int weights() const { return 10 * e; }           // nnz floats
  __host__ __device__ int starts() const { return 10 * e + nnz; }      // n_mels ints
  __host__ __device__ int offsets() const { return starts() + n_mels; }  // n_mels + 1
  __host__ __device__ int warp0() const { return offsets() + n_mels + 1; }
  __host__ __device__ int pw_words() const { return 4 * e + 1 + ((4 * e + 1) >> 5) + 1; }
  __host__ __device__ int warp_words() const { return 8 * e + pw_words(); }
  __host__ __device__ size_t bytes(int warps) const {
    return 4 * ((size_t)warp0() + (size_t)warps * warp_words());
  }
};

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

// In-place E-point radix-2 DIF FFT, E = 32P, of the warp's sequence whose
// element p = lane + 32i sits in (re[i], im[i]). On return element p holds
// bin bitrev(p). tw[h - 1 + j] = W_{2h}^j = exp(-2 pi i j / 2h).
template <int P>
__device__ __forceinline__ void fft_dif(float (&re)[P], float (&im)[P], int lane,
                                        const float2* __restrict__ tw) {
  // Stages with half-length 32h >= 32: both butterfly inputs sit in one lane.
#pragma unroll
  for (int h = P / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i & h) continue;
      const float ar = re[i], ai = im[i], br = re[i + h], bi = im[i + h];
      re[i] = ar + br;
      im[i] = ai + bi;
      re[i + h] = ar - br;
      im[i + h] = ai - bi;
      cmul(re[i + h], im[i + h], tw[32 * h - 1 + lane + 32 * (i & (h - 1))]);
    }
  }
  // Stages with half-length 16 .. 1: the partner is lane ^ half.
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = lane & half;
    const float2 w = tw[half - 1 + (lane & (half - 1))];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float pr = __shfl_xor_sync(kFullMask, re[i], half);
      const float pi = __shfl_xor_sync(kFullMask, im[i], half);
      if (!upper) {
        re[i] += pr;
        im[i] += pi;
      } else {
        re[i] = pr - re[i];
        im[i] = pi - im[i];
        cmul(re[i], im[i], w);
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32) log_mel_radix8dif_kernel(
    const float* __restrict__ x_pad,        // (B, padded_len)
    int padded_len, int hop, int n_frames, long long total_frames,
    const float* __restrict__ window,       // (N)
    const float2* __restrict__ twiddle_rn,  // (4, E): W_N^{rn}, r = 1..4
    const float2* __restrict__ twiddle_fft, // (E - 1): W_{2h}^j at [h - 1 + j]
    const int* __restrict__ mel_start,      // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,     // (n_mels + 1): band m is weights[off[m], off[m+1])
    const float* __restrict__ mel_weight,   // (nnz)
    int n_mels, int nnz,
    float* __restrict__ db) {               // (B, n_frames, n_mels)
  constexpr int E = 32 * P;
  constexpr int N = 8 * E;
  constexpr float kH = 0.70710678118654752f;  // sqrt(1/2)
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const SmemLayout lay{E, n_mels, nnz};
  float2* tw_rn = reinterpret_cast<float2*>(smem + lay.tw_rn());
  float2* tw_fft = reinterpret_cast<float2*>(smem + lay.tw_fft());
  float* w = smem + lay.weights();
  int* band_start = reinterpret_cast<int*>(smem + lay.starts());
  int* band_off = reinterpret_cast<int*>(smem + lay.offsets());

  for (int i = threadIdx.x; i < 4 * E; i += blockDim.x) tw_rn[i] = twiddle_rn[i];
  for (int i = threadIdx.x; i < E - 1; i += blockDim.x) tw_fft[i] = twiddle_fft[i];
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) w[i] = mel_weight[i];
  for (int i = threadIdx.x; i < n_mels; i += blockDim.x) band_start[i] = mel_start[i];
  for (int i = threadIdx.x; i <= n_mels; i += blockDim.x) band_off[i] = mel_offset[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* u = smem + lay.warp0() + warp * lay.warp_words();  // u[s * E + n], 8 rows
  float* pw = u + 8 * E;                                    // power by bin, skewed
  constexpr int kLog2E = (P == 4 ? 7 : P == 8 ? 8 : P == 16 ? 9 : 10);

  for (long long f = (long long)blockIdx.x * warps + warp; f < total_frames;
       f += (long long)gridDim.x * warps) {
    const long long b = f / n_frames;
    const int t = (int)(f - b * n_frames);
    const float* src = x_pad + b * padded_len + (long long)t * hop;

    // Window and W_8 butterflies (pallas_mel.py:1221-1236) in registers;
    // rows of u: u0, u4, u1 re/im, u2 re/im, u3 re/im.
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int n = lane + 32 * i;
      float bj[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bj[j] = src[j * E + n] * __ldg(window + j * E + n);
      const float ev = (bj[0] + bj[4]) + (bj[2] + bj[6]);
      const float od = (bj[1] + bj[5]) + (bj[3] + bj[7]);
      const float d04 = bj[0] - bj[4], d26 = bj[2] - bj[6];
      const float s17 = bj[1] + bj[7], s35 = bj[3] + bj[5];
      const float hs = kH * ((bj[5] + bj[7]) - (bj[1] + bj[3]));
      u[0 * E + n] = ev + od;
      u[1 * E + n] = ev - od;
      u[2 * E + n] = d04 + kH * (s17 - s35);
      u[3 * E + n] = hs - d26;
      u[4 * E + n] = (bj[0] + bj[4]) - (bj[2] + bj[6]);
      u[5 * E + n] = (bj[3] + bj[7]) - (bj[1] + bj[5]);
      u[6 * E + n] = d04 + kH * (s35 - s17);
      u[7 * E + n] = hs + d26;
    }

    // One E-point FFT per class r = 0, 4, 1, 2, 3; power at natural bins.
#pragma unroll 1
    for (int c = 0; c < 5; ++c) {
      const int r = c == 0 ? 0 : (c == 1 ? 4 : c - 1);
      const float* ur = u + (c == 0 ? 0 : c == 1 ? E : 2 * c * E - 2 * E);
      float re[P], im[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int n = lane + 32 * i;
        re[i] = ur[n];
        im[i] = c >= 2 ? ur[E + n] : 0.0f;
        if (r) cmul(re[i], im[i], tw_rn[(r - 1) * E + n]);
      }
      fft_dif<P>(re, im, lane, tw_fft);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int m = (int)(__brev((unsigned)(lane + 32 * i)) >> (32 - kLog2E));
        if ((r == 0 && m > E / 2) || (r == 4 && m >= E / 2)) continue;
        int k = 8 * m + r;
        if (k > N / 2) k = N - k;
        pw[pw_index(k)] = re[i] * re[i] + im[i] * im[i];
      }
    }
    __syncwarp();

    float* out = db + (size_t)f * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = band_off[m], hi = band_off[m + 1], k0 = band_start[m] - lo;
      float acc = 0.0f;
      for (int j = lo; j < hi; ++j) acc += w[j] * pw[pw_index(k0 + j)];
      out[m] = 10.0f * log10f(fmaxf(acc, 1e-10f));
    }
    __syncwarp();  // the power buffer is free for the next frame
  }
}

template <int P>
int launch_spectrum(const float* x_pad, int batch, int padded_len, int hop, int n_frames,
                    const float* window, const float2* twiddle_rn, const float2* twiddle_fft,
                    const int* mel_start, const int* mel_offset, const float* mel_weight,
                    int n_mels, int nnz, float* db, cudaStream_t stream, int device) {
  const SmemLayout lay{32 * P, n_mels, nnz};
  int smem_optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_optin,
                                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && lay.bytes(warps) > (size_t)smem_optin) --warps;
  const size_t smem = lay.bytes(warps);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  auto kernel = log_mel_radix8dif_kernel<P>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * n_frames;
  const long long wanted = (total + warps - 1) / warps;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(wanted < resident ? wanted : resident);
  kernel<<<grid, warps * 32, smem, stream>>>(x_pad, padded_len, hop, n_frames, total, window,
                                             twiddle_rn, twiddle_fft, mel_start, mel_offset,
                                             mel_weight, n_mels, nnz, db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: (B, padded_len) -> dB scratch (B, n_frames, n_mels).
// n_fft = 8E with E = 128, 256, 512 or 1024.
int log_mel_radix8dif_launch(int device, const void* x_pad, int batch, int padded_len,
                             int n_fft, int hop, int n_frames, const void* window,
                             const void* twiddle_rn, const void* twiddle_fft,
                             const void* mel_start, const void* mel_offset,
                             const void* mel_weight, int n_mels, int nnz, void* db,
                             void* stream) {
  if (batch < 1 || n_frames < 1 || n_mels < 1 || hop < 1 ||
      (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* x = (const float*)x_pad;
  const auto* win = (const float*)window;
  const auto* trn = (const float2*)twiddle_rn;
  const auto* tfft = (const float2*)twiddle_fft;
  const auto* ms = (const int*)mel_start;
  const auto* mo = (const int*)mel_offset;
  const auto* mw = (const float*)mel_weight;
  auto* out = (float*)db;
  auto s = (cudaStream_t)stream;
  switch (n_fft) {
    case 1024: return launch_spectrum<4>(x, batch, padded_len, hop, n_frames, win, trn, tfft,
                                         ms, mo, mw, n_mels, nnz, out, s, device);
    case 2048: return launch_spectrum<8>(x, batch, padded_len, hop, n_frames, win, trn, tfft,
                                         ms, mo, mw, n_mels, nnz, out, s, device);
    case 4096: return launch_spectrum<16>(x, batch, padded_len, hop, n_frames, win, trn, tfft,
                                          ms, mo, mw, n_mels, nnz, out, s, device);
    case 8192: return launch_spectrum<32>(x, batch, padded_len, hop, n_frames, win, trn, tfft,
                                          ms, mo, mw, n_mels, nnz, out, s, device);
    default: return (int)cudaErrorInvalidValue;
  }
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
