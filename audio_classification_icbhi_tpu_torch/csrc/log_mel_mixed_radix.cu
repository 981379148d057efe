// Log-mel front end for Hopper (sm_90a) at every n_fft = P * m (P a power of
// two, m odd) that log_mel_radix8dif.cu does not take, and any hop: one
// spectrum source for four TPU kernels of
// audio_classification_icbhi_tpu/ops/pallas_mel.py, and their epilogue
// `_fused_epilogue` (:683):
//   row 3 `_kernel_radix4dif_fused` (:1037, via `_log_mel_radix4dif_fused` :1111),
//   row 4 `_kernel_radix4_fused` (:861, via `_log_mel_radix4_fused` :947),
//   row 5 `_kernel_radix2_fused` (:723, via `_log_mel_radix2_fused` :783),
//   row 6 `_kernel_radix2` (:633, via `_log_mel_radix2` :1542).
// It runs every log-mel algorithm (rows 1-2 too) at each n_fft % 4 == 0 up to
// 16,384 but 512, 1024, 2048, 4096 and 8192 (`mel_kernels.cuda_route`): row 5
// at 768/256 and 1280/256, row 6 at 800/200 and 400/160, row 3 at 1536/384,
// rows 1-2 at 3072, 6144, 12288 and 16384. The four TPU decompositions cut
// the DFT into GEMMs for the MXU; none is carried over.
//
// Function: unpadded (B, L) f32 waveform -> frames at t * hop of its reflect
// padding by N/2 (numpy's "reflect", log_mel_reflect.cuh) -> periodic Hann
// -> |rfft|^2 -> banded mel projection -> 10*log10(max(., 1e-10)) into a
// (B, T, n_mels) dB scratch; then the per-example epilogue of
// log_mel_epilogue.cuh (top_db, the optional SpecAugment bounds, normalize)
// -> (B, n_mels, T) f32. Two launches a call, no padded copy.
//
// Two real frames share one complex FFT: frame t (even) of an example as the
// real part, frame t + 1 of the same example as the imaginary part, unpacked
// by conjugate symmetry, X_a[k] = (Z[k] + conj Z[N-k]) / 2 and X_b[k] =
// (Z[k] - conj Z[N-k]) / 2i. The unpacking's f32 error scales with the
// louder frame, so a pair never straddles two examples (levels differ by
// tens of dB); an odd T leaves each example's last frame alone.
//
// The four-step form of N = P * m: with z_r[n] = z[r + m n] (n < P),
//   Z[k0 + P q] = sum_{r < m} W_m^{rq} (W_N^{r k0} Y_r[k0]),  Y_r = DFT_P(z_r):
// (1) the m P-point FFTs of the stride-m rows, (2) the twiddle W_N^{r k0},
// (3) the m-point DFTs over the rows for each k0.
//
// What bounded the previous design on this card (one block a frame pair,
// n_fft / 4 threads, a radix-2 DIT in shared memory with a block barrier a
// stage, then a direct m-point combine of 2(m - 1) complex products a bin,
// behind the wrapper's reflect-padded copy): barriers and shared-memory
// round trips at m = 3 (10 barriers a pair at 768, ~2 butterflies a thread
// between them), the O(m^2) combine at m = 25 (~90 % of the arithmetic at
// 800), and a third launch. Row 5 took 0.4029-0.4099 ms at 768/256 and row 6
// 0.8617-0.8675 at 800/200, 22-43x their bytes bounds (128 x 5 s, H100
// 80GB HBM3, 700 W; PERF.md).
//
// The design, by path (the launch function's switch over
// MIXED_RADIX_WARP_INSTANCES: the n_fft decides, never an error):
// - Warp path (n_fft 400, 448, 480, 768, 800, 1280, 1536, 3072, 6144): one
//   warp a frame pair (P >= 32), or one group of L = P lanes a pair and
//   32 / L pairs a warp (P < 32: 400 = 16 * 25), a persistent grid sized
//   from the occupancy, no block barrier: only __syncwarp and shuffles.
//   Lane l of a group owns row elements n = l + L i (i < Q = P / L) of every
//   row, so after the row FFT it holds Y_r[k0] for the same k0 in every row
//   and steps (2) and (3) run in its registers.
//   - The frame pair is staged windowed into the warp's slice of shared
//     memory (N float2, coalesced reads of the waveform); each lane then
//     reads its rows z[m n + r], a contiguous block of m words a lane
//     (stride m across lanes, odd: no bank conflict), and owns that block
//     from then on, so no barrier is needed until the power pass.
//   - Step 1: a P-point radix-2 DIF FFT in registers, the radix-8 source's
//     stages: those inside a lane first, then log2 L across lanes by
//     __shfl_xor_sync, each an FMA with the lane's sign. Bin k0 =
//     bitrev(n) ends where n began.
//   - Step 3: the odd factor factored into hand-written radix-3, 5 and 7
//     butterflies (m = 25: two radix-5 passes, ~10 complex products a bin
//     where the previous combine took 48), unrolled at compile time.
//   - Where m * Q <= 48 complex values the lane keeps every row in
//     registers; above (3072, 6144) the rows stay in the lane's own block of
//     shared memory and one row or one k0 is in registers at a time.
//   - Z goes back into the lane's own block; after one __syncwarp each lane
//     unpacks the bins k <= N/2 it owns (the partner N - k read from its
//     owner's block) and overwrites Z[k] with the two frames' power.
//   - The mel pass: lane l of a group sums bands l, l + L, ... for both
//     frames at once (one float2 load gives both powers), over each band's
//     nonzero weights in four interleaved accumulators added as (a0 + a1) +
//     (a2 + a3): a fixed order, so two calls give equal bits.
//   - Window, stage twiddles W_{2h}^j, the per-lane twiddles W_N^{r k0}, the
//     odd factor's W_m^j and the mel bands are read by __ldg, built in
//     float64 on the host (`_twiddles_mixed_radix` in ops/mel_kernels.py).
// - Block path (every other n_fft: a prime factor of m above 7, such as
//   4036 = 4 * 1009; m with no warp instance; 12,288 and 16,384, whose pair
//   a warp's slice cannot hold): the previous design, one block a frame
//   pair, a radix-2 DIT in shared memory and the direct per-bin combine,
//   now reading the unpadded waveform through the same reflection. Its
//   shared memory a block, 12 * n_fft + 8 bytes, sets the one n_fft limit
//   of every log-mel route (`MIXED_RADIX_MAX_N_FFT` = 16,384, 196,616 bytes).
// - Everything stays f32.
//
// `log_mel_mixed_radix_occupancy` reports each n_fft's path, warps a block,
// blocks an SM, registers and shared bytes (chip_smoke.py phase 16 prints
// them): 24 warps an SM at 80 registers a thread at 400-800, 16 at 128 at
// 1280/1536, 8 and 4 at 255 at 3072/6144 (shared memory bound).
//
// Measured (chip_smoke.py phase 16, and `--parent` beside the previous
// design in the same call; H100 80GB HBM3, 700 W, 128 x 5 s; PERF.md
// section 6): the spectrum kernel alone 0.138 ms at 768/256, 0.145 at
// 800/200, 0.21 at 1536/384, 0.125 at 400/160, 0.25 at 1280/256; a row-5
// call 0.19 ms (0.40 before, with the gather), row 6 0.21 (0.86), row 3 at
// 1536/384 0.25 (0.53). The block path's calls take the time they took
// with the gather: the gather's time is now inside the kernel, which
// reflects its edge pairs. What bounds the warp path now is instructions
// and their latency, not bytes (7x the 0.018 ms bytes bound at 768/256):
// five cross-lane stages a value (two shuffles, two FMAs and a complex
// product each) are about 40 % of a pair's instructions by a count of the
// code, and the mel pass's bit-reversed positions another 10 %. The
// register caps (kMinBlocks) and kRegValues were chosen by timing builds
// with other values; as m = 1 instances, n_fft 512 and 1024 ran 7-28 %
// slower than log_mel_radix8dif.cu, so the route keeps those n_fft there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"
#include "log_mel_reflect.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
// Complex values a lane may keep in registers on the warp path (m * Q);
// above it the rows stay in the lane's block of shared memory.
constexpr int kRegValues = 48;

__host__ __device__ constexpr int ilog2(int p) { return p <= 1 ? 0 : 1 + ilog2(p / 2); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// ---------------------------------------------------------------------------
// Warp path

// Lanes a frame pair (L) and row elements a lane (Q) of a P-point row.
__host__ __device__ constexpr int lanes_of(int p) { return p < 32 ? p : 32; }
__host__ __device__ constexpr int per_lane(int p) { return p / lanes_of(p); }

// The warp instance of P and m: lanes a pair (L), row elements a lane (Q),
// pairs a warp (G); whether the rows live in shared memory.
template <int P, int M>
struct Warp {
  static constexpr int N = P * M;
  static constexpr int L = lanes_of(P);
  static constexpr int Q = per_lane(P);
  static constexpr int G = 32 / L;
  static constexpr int kLogP = ilog2(P);
  static constexpr bool kSmem = M * Q > kRegValues;
  // Blocks of 8 warps an SM within the register file (launch bounds), timed
  // on the card: 80 registers a thread up to 25 values a lane (400-800;
  // 128 ran 3-9 % slower), 128 at 40-48 (1280, 1536; 80 ran 10-22 %
  // slower), 255 with the rows in shared memory (3072, 6144; 80 ran 24-96 %
  // slower).
  static constexpr int kMinBlocks = kSmem ? 1 : M * Q <= 25 ? 3 : 2;
};

// cos and sin of 2 pi t / R, t < R, for the odd radices
template <int R>
__device__ __forceinline__ float cos_2pi(int t) {
  if constexpr (R == 3) {
    constexpr float c[3] = {1.0f, -0.5f, -0.5f};
    return c[t];
  } else if constexpr (R == 5) {
    constexpr float c[5] = {1.0f, 3.090169944e-01f, -8.090169944e-01f, -8.090169944e-01f,
                            3.090169944e-01f};
    return c[t];
  } else {
    constexpr float c[7] = {1.0f, 6.234898019e-01f, -2.225209340e-01f, -9.009688679e-01f,
                            -9.009688679e-01f, -2.225209340e-01f, 6.234898019e-01f};
    return c[t];
  }
}

template <int R>
__device__ __forceinline__ float sin_2pi(int t) {
  if constexpr (R == 3) {
    constexpr float s[3] = {0.0f, 8.660254038e-01f, -8.660254038e-01f};
    return s[t];
  } else if constexpr (R == 5) {
    constexpr float s[5] = {0.0f, 9.510565163e-01f, 5.877852523e-01f, -5.877852523e-01f,
                            -9.510565163e-01f};
    return s[t];
  } else {
    constexpr float s[7] = {0.0f, 7.818314825e-01f, 9.749279122e-01f, 4.338837391e-01f,
                            -4.338837391e-01f, -9.749279122e-01f, -7.818314825e-01f};
    return s[t];
  }
}

// In-place R-point DFT (R = 3, 5, 7), W_R = exp(-2 pi i / R), by the
// symmetric pairs a_j = x_j + x_{R-j}, b_j = x_j - x_{R-j}:
//   X[q] = x_0 + sum_j cos(2 pi jq / R) a_j -/+ i sum_j sin(2 pi jq / R) b_j
// for X[q] and X[R - q], q = 1 .. (R - 1) / 2.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&x)[R]) {
  constexpr int H = (R - 1) / 2;
  float2 a[H + 1], b[H + 1];
  float2 sum = x[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    a[j] = cadd(x[j], x[R - j]);
    b[j] = csub(x[j], x[R - j]);
    sum = cadd(sum, a[j]);
  }
  const float2 x0 = x[0];
  x[0] = sum;
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 c = x0, s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int t = (j * q) % R;
      const float cj = cos_2pi<R>(t), sj = sin_2pi<R>(t);
      c = make_float2(fmaf(cj, a[j].x, c.x), fmaf(cj, a[j].y, c.y));
      s = make_float2(fmaf(sj, b[j].x, s.x), fmaf(sj, b[j].y, s.y));
    }
    x[q] = make_float2(c.x + s.y, c.y - s.x);
    x[R - q] = make_float2(c.x - s.y, c.y + s.x);
  }
}

__host__ __device__ constexpr int smallest_factor(int m) {
  return m % 3 == 0 ? 3 : m % 5 == 0 ? 5 : 7;
}

// In-place M-point DFT of x (natural order in and out), M a product of 3, 5
// and 7, by decimation in time over its smallest factor R = M / S:
//   X[k + S q] = sum_{j < R} W_R^{jq} (W_M^{jk} DFT_S(x_j)[k]),  x_j[n] = x[j + R n].
// tw holds W_top^t for the top-level size top = M * kStride, so W_M^t =
// tw[t * kStride].
template <int M, int kStride>
__device__ __forceinline__ void dft(float2 (&x)[M], const float2* __restrict__ tw) {
  if constexpr (M == 3 || M == 5 || M == 7) {
    butterfly<M>(x);
  } else if constexpr (M > 1) {
    constexpr int R = smallest_factor(M), S = M / R;
    float2 y[R][S];
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int n = 0; n < S; ++n) y[j][n] = x[j + R * n];
      dft<S, kStride * R>(y[j], tw);
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      float2 c[R];
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = (j * k) % M == 0 ? y[j][k] : cmul(y[j][k], __ldg(tw + ((j * k) % M) * kStride));
      butterfly<R>(c);
#pragma unroll
      for (int q = 0; q < R; ++q) x[k + S * q] = c[q];
    }
  }
}

// bitrev over log2 P bits
template <int P>
__device__ __forceinline__ int bitrev(int v) {
  return (int)(__brev((unsigned)v) >> (32 - ilog2(P)));
}

// In-place P-point radix-2 DIF FFT of one row over a group of L lanes:
// element n = lg + L i sits in v[i]; on return v[i] holds bin bitrev(n).
// tw[h - 1 + j] = W_{2h}^j. Stages inside a lane first (half-length L h),
// then across lanes (partner lg ^ half; the lower lane keeps self +
// partner, the upper partner - self times W_{2 half}^j: an FMA with the
// lane's sign, no branch).
template <int P>
__device__ __forceinline__ void fft_row(float2 (&v)[per_lane(P)], int lg,
                                        const float2* __restrict__ tw) {
  constexpr int L = lanes_of(P), Q = per_lane(P);
#pragma unroll
  for (int h = Q / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (i & h) continue;
      const float2 a = v[i], b = v[i + h];
      v[i] = cadd(a, b);
      v[i + h] = cmul(csub(a, b), __ldg(tw + L * h - 1 + lg + L * (i & (h - 1))));
    }
  }
#pragma unroll
  for (int half = L / 2; half >= 1; half >>= 1) {
    const bool upper = lg & half;
    const float s = upper ? -1.0f : 1.0f;
    float2 w = make_float2(1.0f, 0.0f);
    if (half > 1 && upper) w = __ldg(tw + half - 1 + (lg & (half - 1)));
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float pr = __shfl_xor_sync(kFullMask, v[i].x, half);
      const float pi = __shfl_xor_sync(kFullMask, v[i].y, half);
      v[i] = make_float2(fmaf(s, v[i].x, pr), fmaf(s, v[i].y, pi));
      if (half > 1) v[i] = cmul(v[i], w);
    }
  }
}

// Stage the windowed frame pair into the group's slice: z[j] = (frame a,
// frame b) at sample j. kEdge: a frame reaches into the padding, so each
// index is reflected.
template <int N, int L, bool kEdge>
__device__ __forceinline__ void stage_pair(float2* z, const float* __restrict__ wave, int start,
                                           int hop, int length, bool valid, bool pair, int lg,
                                           const float* __restrict__ window) {
#pragma unroll 4
  for (int j = lg; j < N; j += L) {
    const float w = __ldg(window + j);
    const int oa = start + j, ob = oa + hop;
    const float a = valid ? __ldg(wave + (kEdge ? reflect_index(oa, length) : oa)) : 0.0f;
    const float b = pair ? __ldg(wave + (kEdge ? reflect_index(ob, length) : ob)) : 0.0f;
    z[j] = make_float2(a * w, b * w);
  }
}

template <int P, int M>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32, Warp<P, M>::kMinBlocks)
log_mel_mixed_radix_warp_kernel(
    const float* __restrict__ x,            // (B, length), unpadded
    int length, int hop, int n_frames, int pairs_per_example, long long total_pairs,
    const float* __restrict__ window,       // (N)
    const float2* __restrict__ tw_fft,      // (P - 1): W_{2h}^j at [h - 1 + j]
    const float2* __restrict__ tw_rk,       // (M - 1, P): W_N^{r k0}, r = 1 .. M - 1
    const float2* __restrict__ tw_m,        // (M): W_M^j
    const int* __restrict__ mel_start,      // (n_mels): first bin of each band
    const int* __restrict__ mel_offset,     // (n_mels + 1): band k is weights[off[k], off[k+1])
    const float* __restrict__ mel_weight,   // (nnz)
    int n_mels,
    float* __restrict__ db) {               // (B, n_frames, n_mels)
  using W = Warp<P, M>;
  constexpr int N = W::N, L = W::L, Q = W::Q, G = W::G;
  extern __shared__ float4 smem_f4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane / L, lg = lane % L;
  float2* z = reinterpret_cast<float2*>(smem_f4) + (size_t)(warp * G + g) * N;

  // the loop bound is the warp's, so every lane runs every trip; a group
  // past the last pair computes on zeros and stores nothing
  for (long long first = ((long long)blockIdx.x * warps + warp) * G; first < total_pairs;
       first += (long long)gridDim.x * warps * G) {
    const long long pr = first + g;
    const bool valid = pr < total_pairs;
    const long long b = valid ? pr / pairs_per_example : 0;
    const int t0 = valid ? 2 * (int)(pr - b * pairs_per_example) : 0;
    const bool pair = valid && t0 + 1 < n_frames;
    const float* wave = x + b * length;
    const int start = t0 * hop - N / 2;  // waveform index of frame t0's first padded sample
    if (start < 0 || start + hop + N > length)
      stage_pair<N, L, true>(z, wave, start, hop, length, valid, pair, lg, window);
    else
      stage_pair<N, L, false>(z, wave, start, hop, length, valid, pair, lg, window);
    __syncwarp();

    // Steps 1-3. Lane lg owns the block z[M n .. M n + M) of each of its
    // row elements n = lg + L i: rows in, Z[bitrev(n) + P q] at z[M n + q] out.
    if constexpr (W::kSmem) {
#pragma unroll 1
      for (int r = 0; r < M; ++r) {
        float2 v[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) v[i] = z[M * (lg + L * i) + r];
        fft_row<P>(v, lg, tw_fft);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const float2 y = r ? cmul(v[i], __ldg(tw_rk + (r - 1) * P + bitrev<P>(lg + L * i))) : v[i];
          z[M * (lg + L * i) + r] = y;
        }
      }
#pragma unroll 1
      for (int i = 0; i < Q; ++i) {
        float2* row = z + M * (lg + L * i);
        float2 c[M];
#pragma unroll
        for (int q = 0; q < M; ++q) c[q] = row[q];
        dft<M, 1>(c, tw_m);
#pragma unroll
        for (int q = 0; q < M; ++q) row[q] = c[q];
      }
    } else {
      float2 v[M][Q];
#pragma unroll
      for (int r = 0; r < M; ++r) {
#pragma unroll
        for (int i = 0; i < Q; ++i) v[r][i] = z[M * (lg + L * i) + r];
      }
#pragma unroll
      for (int r = 0; r < M; ++r) fft_row<P>(v[r], lg, tw_fft);
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int k0 = bitrev<P>(lg + L * i);
        float2 c[M];
        c[0] = v[0][i];
#pragma unroll
        for (int r = 1; r < M; ++r) c[r] = cmul(v[r][i], __ldg(tw_rk + (r - 1) * P + k0));
        dft<M, 1>(c, tw_m);
        float2* row = z + M * (lg + L * i);
#pragma unroll
        for (int q = 0; q < M; ++q) row[q] = c[q];
      }
    }
    __syncwarp();

    // Unpack: the owner of bin k <= N/2 reads Z[k] and Z[N - k] (from the
    // owner of N - k, which skips its own, as N - k > N/2) and writes the
    // two frames' power over Z[k], which no other lane reads. k = k0 + P q
    // with k0 < P lies past N/2 for every q > (M - 1) / 2.
#pragma unroll 1
    for (int i = 0; i < Q; ++i) {
      const int n = lg + L * i;
      const int k0 = bitrev<P>(n);
      const int k0p = (P - k0) & (P - 1);
      const int np = bitrev<P>(k0p);
#pragma unroll
      for (int q = 0; q <= (M - 1) / 2; ++q) {
        if (q == (M - 1) / 2 && 2 * k0 > P) continue;
        const int qp = k0 ? M - 1 - q : (M - q) % M;
        const float2 za = z[M * n + q], zb = z[M * np + qp];
        const float ar = za.x + zb.x, ai = za.y - zb.y;
        const float br = za.x - zb.x, bi = za.y + zb.y;
        z[M * n + q] = make_float2(0.25f * (ar * ar + ai * ai), 0.25f * (br * br + bi * bi));
      }
    }
    __syncwarp();

    // Mel bands lg, lg + L, ... of both frames: bin k's powers at
    // z[M bitrev(k mod P) + k / P]; four interleaved accumulators a frame,
    // added in a fixed order.
    float* out = db + ((size_t)b * n_frames + t0) * n_mels;
    for (int m = lg; m < n_mels; m += L) {
      const int lo = __ldg(mel_offset + m), hi = __ldg(mel_offset + m + 1);
      const int k0 = __ldg(mel_start + m) - lo;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
      auto power = [&](int k) { return z[M * bitrev<P>(k & (P - 1)) + (k >> W::kLogP)]; };
      int j = lo;
      for (; j + 4 <= hi; j += 4) {
        const float w0 = __ldg(mel_weight + j), w1 = __ldg(mel_weight + j + 1);
        const float w2 = __ldg(mel_weight + j + 2), w3 = __ldg(mel_weight + j + 3);
        const float2 p0 = power(k0 + j), p1 = power(k0 + j + 1);
        const float2 p2 = power(k0 + j + 2), p3 = power(k0 + j + 3);
        a0 += w0 * p0.x;
        b0 += w0 * p0.y;
        a1 += w1 * p1.x;
        b1 += w1 * p1.y;
        a2 += w2 * p2.x;
        b2 += w2 * p2.y;
        a3 += w3 * p3.x;
        b3 += w3 * p3.y;
      }
      if (j < hi) {
        const float w = __ldg(mel_weight + j);
        const float2 p = power(k0 + j);
        a0 += w * p.x;
        b0 += w * p.y;
      }
      if (j + 1 < hi) {
        const float w = __ldg(mel_weight + j + 1);
        const float2 p = power(k0 + j + 1);
        a1 += w * p.x;
        b1 += w * p.y;
      }
      if (j + 2 < hi) {
        const float w = __ldg(mel_weight + j + 2);
        const float2 p = power(k0 + j + 2);
        a2 += w * p.x;
        b2 += w * p.y;
      }
      if (valid) out[m] = 10.0f * log10f(fmaxf((a0 + a1) + (a2 + a3), 1e-10f));
      if (pair) out[n_mels + m] = 10.0f * log10f(fmaxf((b0 + b1) + (b2 + b3), 1e-10f));
    }
    __syncwarp();  // the slice is free for the next pair
  }
}

// ---------------------------------------------------------------------------
// Block path: one block a frame pair, the previous design

constexpr int kMaxBlockThreads = 512;

// Threads a block: about four samples a thread, a whole number of warps.
inline int block_threads(int n_fft) {
  const int t = (n_fft / 4 + 31) / 32 * 32;
  return t < 64 ? 64 : (t > kMaxBlockThreads ? kMaxBlockThreads : t);
}

// Shared memory a block, in bytes: N float2, then 2 (N/2 + 1) floats.
inline size_t block_smem_bytes(int n_fft) {
  return 8 * (size_t)n_fft + 8 * (size_t)(n_fft / 2 + 1);
}

// The block's windowed load of its frame pair: sample i = r + m n to row r
// at bit-reversed n. kEdge: a frame reaches into the padding.
template <bool kEdge>
__device__ __forceinline__ void block_load(float2* y, const float* __restrict__ wave, int start,
                                           int hop, int length, bool pair, int n_fft, int p,
                                           int log2_p, int m, const float* __restrict__ window) {
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
    const int n = i / m, r = i - n * m;
    const int rev = log2_p ? (int)(__brev((unsigned)n) >> (32 - log2_p)) : 0;
    const float w = __ldg(window + i);
    const int oa = start + i, ob = oa + hop;
    const float a = __ldg(wave + (kEdge ? reflect_index(oa, length) : oa));
    const float b = pair ? __ldg(wave + (kEdge ? reflect_index(ob, length) : ob)) : 0.0f;
    y[r * p + rev] = make_float2(a * w, b * w);
  }
}

__global__ void __launch_bounds__(kMaxBlockThreads) log_mel_mixed_radix_block_kernel(
    const float* __restrict__ x,            // (B, length), unpadded
    int length, int n_fft, int p, int log2_p, int m, int hop, int n_frames,
    int pairs_per_example,
    const float* __restrict__ window,       // (N)
    const float2* __restrict__ twiddle,     // (N): W_N^j = exp(-2 pi i j / N)
    const int* __restrict__ mel_start,
    const int* __restrict__ mel_offset,
    const float* __restrict__ mel_weight,
    int n_mels,
    float* __restrict__ db) {               // (B, n_frames, n_mels)
  extern __shared__ float4 smem_f4[];
  float2* y = reinterpret_cast<float2*>(smem_f4);  // row r = Y_r, P values each
  const int n_bins = n_fft / 2 + 1;
  float* pw = reinterpret_cast<float*>(y + n_fft);  // power of frame t0, then t0 + 1
  const int tid = threadIdx.x;

  const int b = blockIdx.x / pairs_per_example;
  const int t0 = 2 * (blockIdx.x - b * pairs_per_example);
  const bool pair = t0 + 1 < n_frames;
  const float* wave = x + (size_t)b * length;
  const int start = t0 * hop - n_fft / 2;
  const size_t f0 = (size_t)b * n_frames + t0;  // row of frame t0 in the dB scratch

  // Windowed load: sample i = r + m n goes to row r at bit-reversed n.
  if (start < 0 || start + hop + n_fft > length)
    block_load<true>(y, wave, start, hop, length, pair, n_fft, p, log2_p, m, window);
  else
    block_load<false>(y, wave, start, hop, length, pair, n_fft, p, log2_p, m, window);
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

  // The direct combine over the odd factor for bins k and N - k, then the
  // two real frames' power.
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

// ---------------------------------------------------------------------------
// Launch shapes

enum Path { kBlock = 0, kRegisters = 1, kShared = 2 };

struct Occupancy {
  int path, warps, blocks_per_sm, regs, sms;
  size_t smem;
};

// The warp instance's launch shape on `device`: the block of <= 8 warps that
// puts the most warps on an SM. Computed once per device and cached.
template <int P, int M>
cudaError_t warp_occupancy(int device, Occupancy* occ) {
  using W = Warp<P, M>;
  constexpr int kDevices = 64;
  static Occupancy cached[kDevices];
  static bool known[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (known[device]) {
    *occ = cached[device];
    return cudaSuccess;
  }
  auto kernel = log_mel_mixed_radix_warp_kernel<P, M>;
  const size_t per_warp = 8 * (size_t)W::N * W::G;
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
  Occupancy best{W::kSmem ? kShared : kRegisters, 0, 0, attr.numRegs, sms, 0};
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

struct Args {
  const float* x;
  int batch, length, n_fft, hop, n_frames;
  const float* window;
  const float2 *tw_n, *tw_fft, *tw_rk, *tw_m;
  const int *mel_start, *mel_offset;
  const float* mel_weight;
  int n_mels;
  float* db;
  cudaStream_t stream;
  int device;
};

template <int P, int M>
int launch_warp(const Args& a) {
  using W = Warp<P, M>;
  Occupancy occ;
  cudaError_t err = warp_occupancy<P, M>(a.device, &occ);
  if (err != cudaSuccess) return (int)err;
  const int pairs_per_example = (a.n_frames + 1) / 2;
  const long long total = (long long)a.batch * pairs_per_example;
  const long long per_block = (long long)occ.warps * W::G;
  const long long wanted = (total + per_block - 1) / per_block;
  const long long resident = (long long)occ.blocks_per_sm * occ.sms;
  const unsigned grid = (unsigned)(wanted < resident ? wanted : resident);
  log_mel_mixed_radix_warp_kernel<P, M><<<grid, occ.warps * 32, occ.smem, a.stream>>>(
      a.x, a.length, a.hop, a.n_frames, pairs_per_example, total, a.window, a.tw_fft, a.tw_rk,
      a.tw_m, a.mel_start, a.mel_offset, a.mel_weight, a.n_mels, a.db);
  return (int)cudaGetLastError();
}

template <int P, int M>
int occupancy_warp(int device, Occupancy* occ) {
  return (int)warp_occupancy<P, M>(device, occ);
}

int block_occupancy(int device, int n_fft, Occupancy* occ) {
  int smem_optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&smem_optin,
                                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = block_smem_bytes(n_fft);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log_mel_mixed_radix_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, log_mel_mixed_radix_block_kernel);
  if (err != cudaSuccess) return (int)err;
  const int threads = block_threads(n_fft);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, log_mel_mixed_radix_block_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  *occ = Occupancy{kBlock, threads / 32, blocks, attr.numRegs, sms, smem};
  return 0;
}

int launch_block(const Args& a) {
  Occupancy occ;
  const int err0 = block_occupancy(a.device, a.n_fft, &occ);
  if (err0) return err0;
  const int pairs_per_example = (a.n_frames + 1) / 2;
  const long long blocks = (long long)a.batch * pairs_per_example;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int p = a.n_fft & -a.n_fft;  // the largest power of two dividing n_fft
  const int log2_p = ilog2(p);
  log_mel_mixed_radix_block_kernel<<<(unsigned)blocks, occ.warps * 32, occ.smem, a.stream>>>(
      a.x, a.length, a.n_fft, p, log2_p, a.n_fft / p, a.hop, a.n_frames, pairs_per_example,
      a.window, a.tw_n, a.mel_start, a.mel_offset, a.mel_weight, a.n_mels, a.db);
  return (int)cudaGetLastError();
}

// The warp instances, by n_fft: X(n_fft, P, m). Every other n_fft takes the
// block path. The one list of which n_fft takes which path: the wrapper
// passes every table either path reads, and `log_mel_mixed_radix_occupancy`
// reports the path.
#define MIXED_RADIX_WARP_INSTANCES(X) \
  X(400, 16, 25)                      \
  X(448, 64, 7)                       \
  X(480, 32, 15)                      \
  X(768, 256, 3)                      \
  X(800, 32, 25)                      \
  X(1280, 256, 5)                     \
  X(1536, 512, 3)                     \
  X(3072, 1024, 3)                    \
  X(6144, 2048, 3)

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: unpadded (B, length) -> dB scratch (B, n_frames, n_mels),
// frame t at padded offset t * hop of the reflect padding by n_fft / 2, for
// any n_fft % 4 == 0 whose block-path block fits the shared memory, and any
// hop. The tables of both paths, P the largest power of two dividing n_fft
// and m = n_fft / P: tw_n W_N^j (N), read by the block path; tw_fft the
// stage twiddles W_{2h}^j at [h - 1 + j] (P - 1), tw_rk W_N^{r k0} (m - 1, P)
// and tw_m W_m^j (m), read by the warp path.
int log_mel_mixed_radix_launch(int device, const void* x, int batch, int length, int n_fft,
                               int hop, int n_frames, const void* window, const void* tw_n,
                               const void* tw_fft, const void* tw_rk, const void* tw_m,
                               const void* mel_start, const void* mel_offset,
                               const void* mel_weight, int n_mels, void* db, void* stream) {
  if (n_fft < 4 || n_fft % 4 || batch < 1 || length < 1 || n_frames < 1 || n_mels < 1 ||
      hop < 1 || (long long)(n_frames - 1) * hop > (long long)length)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const float*)x, batch, length, n_fft, hop, n_frames, (const float*)window,
               (const float2*)tw_n, (const float2*)tw_fft, (const float2*)tw_rk,
               (const float2*)tw_m, (const int*)mel_start, (const int*)mel_offset, (const float*)mel_weight,
               n_mels, (float*)db, (cudaStream_t)stream, device};
  switch (n_fft) {
#define CASE(n, p, m) \
  case n:             \
    return launch_warp<p, m>(a);
    MIXED_RADIX_WARP_INSTANCES(CASE)
#undef CASE
    default:
      return launch_block(a);
  }
}

// The launch shape of n_fft on `device`, into out[5]: path (0 block, 1 warp
// with the rows in registers, 2 warp with the rows in shared memory), warps
// a block, blocks an SM, registers a thread, dynamic shared bytes a block.
int log_mel_mixed_radix_occupancy(int device, int n_fft, int* out) {
  if (n_fft < 4 || n_fft % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Occupancy occ;
  int e = 0;
  switch (n_fft) {
#define CASE(n, p, m)                 \
  case n:                             \
    e = occupancy_warp<p, m>(device, &occ); \
    break;
    MIXED_RADIX_WARP_INSTANCES(CASE)
#undef CASE
    default:
      e = block_occupancy(device, n_fft, &occ);
  }
  if (e) return e;
  out[0] = occ.path;
  out[1] = occ.warps;
  out[2] = occ.blocks_per_sm;
  out[3] = occ.regs;
  out[4] = (int)occ.smem;
  return 0;
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
