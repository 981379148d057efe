// Log-mel front end for Hopper (sm_90a) by radix-8 decimation in frequency:
// port of the TPU kernel `_kernel_radix8dif_fused` / `_log_mel_radix8dif_fused`
// (audio_classification_icbhi_tpu/ops/pallas_mel.py:1193, :1456; constants
// `_constants_radix8dif` :307-395) and its epilogue `_fused_epilogue` (:683).
// It takes n_fft 512, 1024, 2048, 4096 and 8192 at any hop, and at the n_fft
// `mel_kernels.cuda_route` sends here it runs every log-mel algorithm: row 1
// `_kernel_radix16dif_fused` (:1270) at config.yaml's 2048/512, row 2 at the
// analyzer's 1024/256, row 3 at 512/128, row 4 at 2048/512 (chip_smoke.py
// phase 16 times this source beside log_mel_mixed_radix.cu, which takes the
// other n_fft).
//
// Function: unpadded (B, L) f32 waveform -> frames at t * hop of its reflect
// padding by N/2 (numpy's "reflect", period 2(L - 1), index 0 when L = 1) ->
// periodic Hann -> |rfft|^2 -> banded mel projection -> 10*log10(max(., 1e-10))
// into a (B, T, n_mels) dB scratch; then the per-example epilogue of
// log_mel_epilogue.cuh (top_db, the optional SpecAugment bounds, normalize)
// -> (B, n_mels, T) f32. Two launches a call, no padded copy.
//
// The decomposition (pallas_mel.py:311-338). A windowed frame x of N samples
// splits into eight contiguous eighth-blocks b_j[n] = x[jE + n], E = N/8, and
//   X[8m + r] = DFT_E{ u_r[n] W_N^{rn} }[m],   u_r[n] = sum_j W_8^{rj} b_j[n].
// The W_8 coefficients are 0, +-1, +-sqrt(1/2): u_0 and u_4 are real, u_1,
// u_2, u_3 complex. For real input only r = 0..4 are needed: bins with
// 8m + r > N/2 are the conjugates of bins N - (8m + r) (classes 7, 6, 5), so
// they carry the same power and land on those bins. Class 0 keeps m <= E/2
// and class 4 keeps m < E/2 (its other half repeats it mirrored). u_4 W_N^{4n}
// is complex (u_4's DFT at half-integer frequencies), so u_0 and u_4 cannot
// share one complex FFT: five E-point FFTs a frame.
//
// What bounds it on this card. At config.yaml's serving shape (128 clips of
// 5 s, 2048/512, 128 mels: 20,096 frames) the function reads 41 MB and writes
// 10 MB (0.016 ms of HBM time) and does ~1.3 GFLOP of f32 work (0.019 ms at
// the CUDA-core peak). Neither binds: one warp a frame runs a chain of
// shuffles, loads and FMAs whose latency only other warps can hide. The
// previous design kept the five class sequences u_r in a per-warp slice of
// shared memory (8E words) beside the power buffer (4E words) and staged the
// twiddles and mel weights in every block (10E words + the bands): at 2048 a
// block of 8 warps took 118,760 bytes and an SM held one block, 8 warps, and
// each warp ran ~19 frames in sequence. Row 1 took 0.3987-0.4034 ms (the
// spectrum kernel 284 us of it, the wrapper's reflect-pad gather 58 us), row 2
// 0.5376-0.5397 ms at 2,400 x 0.5 s, row 4 0.4022-0.4053 ms (H100 80GB HBM3,
// 700 W; PERF.md).
//
// What the design does about it (each choice timed on the card, H100 80GB
// HBM3 at 700 W, spectrum kernel alone at 128 x 5 s):
// - One warp a frame, a persistent grid sized from the occupancy. Lane l owns
//   n = l + 32i of every eighth-block (i < P = E/32), so neighbouring lanes
//   read neighbouring addresses.
// - No u buffer at n_fft <= 2048: a lane forms its rows u_r[n] (the W_8
//   butterflies with the TPU kernel's own expressions, pallas_mel.py:1221-
//   1236) from its windowed samples once, keeps all 8P of them in registers
//   and runs the five classes unrolled from there. Registers set the
//   occupancy: 128 a thread at 512, 2048 and 4096, 64 at 1024, 255 at 8192
//   (launch bounds `min_blocks`): 16 / 32 / 16 warps an SM at 512 / 1024 / 2048 (8 before at
//   2048). Tighter caps that gave 24 warps at 2048 spilled, or reloaded the
//   samples for every class or two, and ran 13-160 % slower.
// - At 4096 and 8192 (8P = 128 and 256 values) the rows go to the warp's
//   slice of shared memory, each lane reading back only what it wrote, and
//   the five classes run as one loop: one FFT body in the code, where five
//   unrolled ones ran 18 % slower at 4096. 9 and 4 warps an SM (7 and 3
//   before).
// - Shared memory holds nothing else: the window, the class and stage
//   twiddles and the mel bands are read through the read-only cache
//   (__ldg), so a block needs no barrier. Staging the twiddles in shared
//   memory at 8192 cost a warp an SM and ran 8 % slower.
//   `log_mel_radix8dif_occupancy` reports each instance's launch shape.
// - Each class is twiddled by W_N^{rn} and goes through an E-point radix-2
//   DIF FFT in registers: the stages whose butterflies stay inside a lane
//   first, then five stages across lanes by __shfl_xor_sync, each an FMA
//   with the lane's sign and a twiddle of 1 in the lower lanes (no branch;
//   15 % faster than the branching form). The stage twiddles W_{2h}^j sit in
//   one table at [h - 1 + j].
// - The FFT leaves bin m in bit-reversed position; each lane writes the power
//   of its bins at their natural index k = 8m + r (or N - k) into the warp's
//   power buffer, one word of skew every 32 bins. After one __syncwarp lane
//   l sums bands l, l + 32, ... over their nonzero weights (`mel_bands` in
//   ops/mel_kernels.py) in four interleaved accumulators, added as (a0 + a1)
//   + (a2 + a3): a chain a quarter as long, in a fixed order, so two calls
//   give equal bits.
// - Reflect padding inside the kernel: a frame within N/2 of either end maps
//   each sample index through the reflection; every other frame reads the
//   waveform directly. The wrapper launches two kernels, no gather.
// - Everything stays f32: the TPU kernel's bf16 hi/lo DFT GEMMs exist because
//   Mosaic has no f32 matmul, and a bf16 mel projection alone would break the
//   1e-3 dB budget.
// - The epilogue is log_mel_epilogue.cuh's kernel, shared with the other
//   log-mel sources, so the training form (nullable (B, 4) bounds) comes
//   with it.
//
// Measured (the same card): the spectrum kernel alone 0.156 ms at 2048/512
// (0.284 before, with the gather 0.342), row 1 0.18 ms a call. What bounds
// it now is instructions: by a count of the code, a frame at 2048 is ~4,000
// warp instructions, ~40 % of them the cross-lane FFT stages, issued at
// about half the SM's rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"
#include "log_mel_reflect.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int p) { return p <= 1 ? 0 : 1 + ilog2(p / 2); }

// Where a lane keeps its rows of the class sequences. Up to P = 8 (8P
// values) in registers, the five classes unrolled. At P = 16 and 32 in the
// warp's slice of shared memory (8E words, each lane reading back only what
// it wrote), the classes one loop over a class index: one FFT body, where
// five unrolled ones ran slower.
__host__ __device__ constexpr bool rows_in_smem(int p) { return p >= 16; }

// Blocks of 8 warps an SM must hold within the register file (the launch
// bounds): 64 registers a thread at P = 4, 128 at P = 2, 8 and 16, 255 at
// P = 32. Chosen by timing each instance's spectrum under other caps: more
// warps with fewer registers spilled and ran slower.
constexpr int kMaxWarpsPerBlock = 8;
__host__ __device__ constexpr int min_blocks(int p) { return p == 4 ? 4 : p == 32 ? 1 : 2; }

// Words of a warp's power buffer: bins 0 .. 4E, one word of skew every 32.
__host__ __device__ constexpr int pw_words(int e) { return 4 * e + ((4 * e) >> 5) + 1; }

// Words of a warp's slice: its power buffer, then its rows where they live
// in shared memory.
__host__ __device__ constexpr int warp_words(int e) {
  return pw_words(e) + (rows_in_smem(e / 32) ? 8 * e : 0);
}

// Index of power bin k in a warp's power buffer: one word of skew every 32
// bins, so that the 32 lanes' bit-reversed bins (k = 32q + c at P = 4) fall
// on distinct banks.
__device__ __forceinline__ int pw_index(int k) { return k + (k >> 5); }

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

// Rows of the class sequences a lane holds, for n = lane + 32i: 0 u_0, 1 u_4,
// 2-3 u_1 (re, im), 4-5 u_2, 6-7 u_3; u[row][i] in registers, or us[row * E
// + n] in the warp's shared slice (kSmem).
//
// Window and W_8 butterflies (pallas_mel.py:1221-1236) of the frame whose
// first padded sample is waveform index `base`. kEdge: the frame reaches
// into the padding, so each index is reflected.
template <int P, bool kEdge, bool kSmem>
__device__ __forceinline__ void form_rows_at(const float* __restrict__ wave, int base, int length,
                                             int lane, const float* __restrict__ window,
                                             float (&u)[8][P], float* us) {
  constexpr int E = 32 * P;
  constexpr float kH = 0.70710678118654752f;  // sqrt(1/2)
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int n = lane + 32 * i;
    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = base + j * E + n;
      bj[j] = __ldg(wave + (kEdge ? reflect_index(o, length) : o)) * __ldg(window + j * E + n);
    }
    const float ev = (bj[0] + bj[4]) + (bj[2] + bj[6]);
    const float od = (bj[1] + bj[5]) + (bj[3] + bj[7]);
    const float d04 = bj[0] - bj[4], d26 = bj[2] - bj[6];
    const float s17 = bj[1] + bj[7], s35 = bj[3] + bj[5];
    const float hs = kH * ((bj[5] + bj[7]) - (bj[1] + bj[3]));
    const float rows[8] = {ev + od,
                           ev - od,
                           d04 + kH * (s17 - s35),
                           hs - d26,
                           (bj[0] + bj[4]) - (bj[2] + bj[6]),
                           (bj[3] + bj[7]) - (bj[1] + bj[5]),
                           d04 + kH * (s35 - s17),
                           hs + d26};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if constexpr (kSmem)
        us[r * E + n] = rows[r];
      else
        u[r][i] = rows[r];
    }
  }
}

template <int P, bool kSmem>
__device__ __forceinline__ void form_rows(bool edge, const float* __restrict__ wave, int base,
                                          int length, int lane, const float* __restrict__ window,
                                          float (&u)[8][P], float* us) {
  if (edge)
    form_rows_at<P, true, kSmem>(wave, base, length, lane, window, u, us);
  else
    form_rows_at<P, false, kSmem>(wave, base, length, lane, window, u, us);
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
      cmul(re[i + h], im[i + h],
           __ldg(tw + 32 * h - 1 + lane + 32 * (i & (h - 1))));
    }
  }
  // Stages with half-length 16 .. 1: the partner is lane ^ half. The lower
  // lane keeps self + partner, the upper partner - self times W_{2 half}^j:
  // one FMA with the sign s, and a twiddle of 1 in the lower lanes, so that
  // no lane branches; the last stage's twiddles are all 1.
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = lane & half;
    const float s = upper ? -1.0f : 1.0f;
    float2 w = make_float2(1.0f, 0.0f);
    if (half > 1 && upper) w = __ldg(tw + half - 1 + (lane & (half - 1)));
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float pr = __shfl_xor_sync(kFullMask, re[i], half);
      const float pi = __shfl_xor_sync(kFullMask, im[i], half);
      re[i] = fmaf(s, re[i], pr);
      im[i] = fmaf(s, im[i], pi);
      if (half > 1) cmul(re[i], im[i], w);
    }
  }
}

// Class r of the frame from its rows (re, im) in place: twiddled by
// W_N^{rn}, transformed, and its power written at the natural bins. r is a
// constant where the classes are unrolled.
template <int P>
__device__ __forceinline__ void class_power(int r, float (&re)[P], float (&im)[P], int lane,
                                            const float2* __restrict__ twiddle_rn,
                                            const float2* __restrict__ twiddle_fft, float* pw) {
  constexpr int E = 32 * P, N = 8 * E, kLog2E = 5 + ilog2(P);
  if (r) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      cmul(re[i], im[i], __ldg(twiddle_rn + (r - 1) * E + lane + 32 * i));
  }
  fft_dif<P>(re, im, lane, twiddle_fft);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int m = (int)(__brev((unsigned)(lane + 32 * i)) >> (32 - kLog2E));
    if ((r == 0 && m > E / 2) || (r == 4 && m >= E / 2)) continue;
    int k = 8 * m + r;
    if (k > N / 2) k = N - k;
    pw[pw_index(k)] = re[i] * re[i] + im[i] * im[i];
  }
}

// Class R from its rows in registers (ui unread for the real classes 0, 4).
template <int P, int R>
__device__ __forceinline__ void class_from_registers(const float (&ur)[P], const float (&ui)[P],
                                                     int lane, const float2* __restrict__ twiddle_rn,
                                                     const float2* __restrict__ twiddle_fft,
                                                     float* pw) {
  float re[P], im[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    re[i] = ur[i];
    im[i] = (R == 0 || R == 4) ? 0.0f : ui[i];
  }
  class_power<P>(R, re, im, lane, twiddle_rn, twiddle_fft, pw);
}

// Class r (a runtime index) from its rows in the warp's shared slice.
template <int P>
__device__ __forceinline__ void class_from_smem(int r, const float* us, int lane,
                                                const float2* __restrict__ twiddle_rn,
                                                const float2* __restrict__ twiddle_fft,
                                                float* pw) {
  constexpr int E = 32 * P;
  const int row = r == 0 ? 0 : r == 4 ? 1 : 2 * r;
  const bool real_class = r == 0 || r == 4;
  float re[P], im[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    re[i] = us[row * E + lane + 32 * i];
    im[i] = real_class ? 0.0f : us[(row + 1) * E + lane + 32 * i];
  }
  class_power<P>(r, re, im, lane, twiddle_rn, twiddle_fft, pw);
}

template <int P>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, min_blocks(P)) log_mel_radix8dif_kernel(
    const float* __restrict__ x,            // (B, length), unpadded
    int length, int hop, int n_frames, long long total_frames,
    const float* __restrict__ window,       // (N)
    const float2* __restrict__ twiddle_rn,  // (4, E): W_N^{rn}, r = 1..4
    const float2* __restrict__ twiddle_fft, // (E - 1): W_{2h}^j at [h - 1 + j]
    const int* __restrict__ mel_start,      // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,     // (n_mels + 1): band m is weights[off[m], off[m+1])
    const float* __restrict__ mel_weight,   // (nnz)
    int n_mels,
    float* __restrict__ db) {               // (B, n_frames, n_mels)
  constexpr int E = 32 * P, N = 8 * E;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* pw = smem + warp * warp_words(E);  // power by bin, skewed
  float* us = pw + pw_words(E);             // the rows, where they live here

  for (long long f = (long long)blockIdx.x * warps + warp; f < total_frames;
       f += (long long)gridDim.x * warps) {
    const long long b = f / n_frames;
    const int t = (int)(f - b * n_frames);
    const float* wave = x + b * length;
    const int base = t * hop - N / 2;  // waveform index of the frame's first padded sample
    const bool edge = base < 0 || base + N > length;

    float u[8][P];
    form_rows<P, rows_in_smem(P)>(edge, wave, base, length, lane, window, u, us);
    if constexpr (rows_in_smem(P)) {
#pragma unroll 1
      for (int c = 0; c < 5; ++c)
        class_from_smem<P>(c == 0 ? 0 : c == 1 ? 4 : c - 1, us, lane, twiddle_rn, twiddle_fft, pw);
    } else {
      class_from_registers<P, 0>(u[0], u[0], lane, twiddle_rn, twiddle_fft, pw);
      class_from_registers<P, 4>(u[1], u[1], lane, twiddle_rn, twiddle_fft, pw);
      class_from_registers<P, 1>(u[2], u[3], lane, twiddle_rn, twiddle_fft, pw);
      class_from_registers<P, 2>(u[4], u[5], lane, twiddle_rn, twiddle_fft, pw);
      class_from_registers<P, 3>(u[6], u[7], lane, twiddle_rn, twiddle_fft, pw);
    }
    __syncwarp();

    // Mel bands l, l + 32, ...: four interleaved accumulators over the
    // band's weights, added in a fixed order.
    float* out = db + (size_t)f * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = __ldg(mel_offset + m), hi = __ldg(mel_offset + m + 1);
      const int k0 = __ldg(mel_start + m) - lo;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int j = lo;
      for (; j + 4 <= hi; j += 4) {
        a0 += __ldg(mel_weight + j) * pw[pw_index(k0 + j)];
        a1 += __ldg(mel_weight + j + 1) * pw[pw_index(k0 + j + 1)];
        a2 += __ldg(mel_weight + j + 2) * pw[pw_index(k0 + j + 2)];
        a3 += __ldg(mel_weight + j + 3) * pw[pw_index(k0 + j + 3)];
      }
      if (j < hi) a0 += __ldg(mel_weight + j) * pw[pw_index(k0 + j)];
      if (j + 1 < hi) a1 += __ldg(mel_weight + j + 1) * pw[pw_index(k0 + j + 1)];
      if (j + 2 < hi) a2 += __ldg(mel_weight + j + 2) * pw[pw_index(k0 + j + 2)];
      out[m] = 10.0f * log10f(fmaxf((a0 + a1) + (a2 + a3), 1e-10f));
    }
    __syncwarp();  // the power buffer is free for the next frame
  }
}

// The launch shape of instance P on `device`: the block of <= 8 warps that
// puts the most warps on an SM, its blocks an SM, registers a thread and
// dynamic shared memory a block. Computed once per device and cached.
struct Occupancy {
  int warps, blocks_per_sm, regs, sms;
  size_t smem;
};

template <int P>
cudaError_t occupancy(int device, Occupancy* occ) {
  constexpr int kDevices = 64;
  static Occupancy cached[kDevices];
  static bool known[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (known[device]) {
    *occ = cached[device];
    return cudaSuccess;
  }
  auto kernel = log_mel_radix8dif_kernel<P>;
  const size_t per_warp = 4 * (size_t)warp_words(32 * P);
  int smem_optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_optin,
                                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t most = per_warp * kMaxWarpsPerBlock < (size_t)smem_optin
                          ? per_warp * kMaxWarpsPerBlock : (size_t)smem_optin;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  Occupancy best{0, 0, attr.numRegs, sms, 0};
  for (int w = kMaxWarpsPerBlock; w >= 1; --w) {
    const size_t smem = w * per_warp;
    if (smem > most) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, w * 32, smem);
    if (err != cudaSuccess) return err;
    if (blocks * w > best.blocks_per_sm * best.warps) {
      best.warps = w;
      best.blocks_per_sm = blocks;
      best.smem = smem;
    }
  }
  if (best.warps == 0) return cudaErrorInvalidConfiguration;
  cached[device] = best;
  known[device] = true;
  *occ = best;
  return cudaSuccess;
}

template <int P>
int launch_spectrum(const float* x, int batch, int length, int hop, int n_frames,
                    const float* window, const float2* twiddle_rn, const float2* twiddle_fft,
                    const int* mel_start, const int* mel_offset, const float* mel_weight,
                    int n_mels, float* db, cudaStream_t stream, int device) {
  Occupancy occ;
  cudaError_t err = occupancy<P>(device, &occ);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)batch * n_frames;
  const long long wanted = (total + occ.warps - 1) / occ.warps;
  const long long resident = (long long)occ.blocks_per_sm * occ.sms;
  const unsigned grid = (unsigned)(wanted < resident ? wanted : resident);
  log_mel_radix8dif_kernel<P><<<grid, occ.warps * 32, occ.smem, stream>>>(
      x, length, hop, n_frames, total, window, twiddle_rn, twiddle_fft, mel_start, mel_offset,
      mel_weight, n_mels, db);
  return (int)cudaGetLastError();
}

template <int P>
int occupancy_entry(int device, int* out) {
  Occupancy occ;
  const cudaError_t err = occupancy<P>(device, &occ);
  if (err != cudaSuccess) return (int)err;
  out[0] = occ.warps;
  out[1] = occ.blocks_per_sm;
  out[2] = occ.regs;
  out[3] = (int)occ.smem;
  return 0;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: unpadded (B, length) -> dB scratch (B, n_frames, n_mels),
// frame t at padded offset t * hop of the reflect padding by n_fft / 2.
// n_fft = 8E with E = 64, 128, 256, 512 or 1024.
int log_mel_radix8dif_launch(int device, const void* x, int batch, int length, int n_fft,
                             int hop, int n_frames, const void* window, const void* twiddle_rn,
                             const void* twiddle_fft, const void* mel_start,
                             const void* mel_offset, const void* mel_weight, int n_mels,
                             void* db, void* stream) {
  if (batch < 1 || length < 1 || n_frames < 1 || n_mels < 1 || hop < 1 ||
      (long long)(n_frames - 1) * hop > (long long)length)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* xs = (const float*)x;
  const auto* win = (const float*)window;
  const auto* trn = (const float2*)twiddle_rn;
  const auto* tfft = (const float2*)twiddle_fft;
  const auto* ms = (const int*)mel_start;
  const auto* mo = (const int*)mel_offset;
  const auto* mw = (const float*)mel_weight;
  auto* out = (float*)db;
  auto s = (cudaStream_t)stream;
  switch (n_fft) {
    case 512: return launch_spectrum<2>(xs, batch, length, hop, n_frames, win, trn, tfft, ms,
                                        mo, mw, n_mels, out, s, device);
    case 1024: return launch_spectrum<4>(xs, batch, length, hop, n_frames, win, trn, tfft, ms,
                                         mo, mw, n_mels, out, s, device);
    case 2048: return launch_spectrum<8>(xs, batch, length, hop, n_frames, win, trn, tfft, ms,
                                         mo, mw, n_mels, out, s, device);
    case 4096: return launch_spectrum<16>(xs, batch, length, hop, n_frames, win, trn, tfft, ms,
                                          mo, mw, n_mels, out, s, device);
    case 8192: return launch_spectrum<32>(xs, batch, length, hop, n_frames, win, trn, tfft, ms,
                                          mo, mw, n_mels, out, s, device);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape of the n_fft instance on `device`, into out[4]: warps a
// block, blocks an SM, registers a thread, dynamic shared bytes a block.
int log_mel_radix8dif_occupancy(int device, int n_fft, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (n_fft) {
    case 512: return occupancy_entry<2>(device, out);
    case 1024: return occupancy_entry<4>(device, out);
    case 2048: return occupancy_entry<8>(device, out);
    case 4096: return occupancy_entry<16>(device, out);
    case 8192: return occupancy_entry<32>(device, out);
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
