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
//   4036 = 4 * 1009 and 1100 = 4 * 5^2 * 11; m with no warp instance, such
//   as 1200 = 16 * 75; 12,288 and 16,384, whose pair a warp's slice cannot
//   hold): one block a frame pair, the pair in shared memory in natural
//   order, so row r is its stride-m subsequence, each complex value at a
//   XOR-swizzled slot within its group of 16 (`swz`: the power-of-two
//   strides of the passes and of the digit-reversed bins fall on distinct
//   banks; the previous design's direct combine and radix-2 stages had
//   neither). The plan (`block_plan`, mirrored by `mel_kernels.block_plan`)
//   takes about 16 complex values a thread, up to 1024 threads.
//   - Step 1: radix-8 passes (radix 2 or 4 at the smallest span) by
//     decimation in frequency, in place: a thread reads its butterfly's 8
//     values into registers, runs the 8-point DFT and the twiddles W_S^{s q}
//     (W_S^s by sincospif, its powers by products), and writes them back: a
//     barrier a pass where the previous design had one a radix-2 stage.
//     Bin k0 ends at its digit-reversed position; the last pass multiplies
//     by step 2's W_N^{r k0} as it writes.
//   - Step 3 for m of 3, 5 and 7: staged passes down each column over m's
//     prime factors, the smallest first, by the warp path's butterfly<R>
//     (m = 75: 3, 5, 5; about 12 complex products a bin where the direct
//     combine took 74).
//   - Step 3 for m with a prime factor above 7: Bluestein over the whole odd
//     factor, X_q = w_q sum_r (x_r w_r) conj(w_{q - r}), w_n = exp(-i pi
//     (n^2 mod 2m) / m): the chirped columns into a workspace of M (the
//     power of two >= 2m - 1) each, the forward passes, times DFT_M of the
//     conjugate chirp over M (built on the host in float64 and stored in
//     the forward passes' order), the same passes undone, times the chirp
//     (4036: two 2048-point FFTs a column where the direct combine made
//     1,009 products a bin). All P columns a round where the workspace
//     fits (one at 16,380, M = 8192).
//   - The unpacking and the mel pass find bin k at `bin_slot[k]` (host
//     table); a group of up to 32 lanes sums each band, a shuffle tree
//     adds them: a fixed order, two calls equal bits.
//   - Its shared memory a block, 8 (N + the workspace) bytes rounded to 16
//     values, sets the one n_fft limit of every log-mel route
//     (`MIXED_RADIX_MAX_N_FFT` = 16,384, 131,072 bytes; the most, 196,608,
//     at 16,380).
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
// 1536/384 0.25 (0.53). What bounds the warp path now is instructions and
// their latency, not bytes (7x the 0.018 ms bytes bound at 768/256): five
// cross-lane stages a value (two shuffles, two FMAs and a complex product
// each) are about 40 % of a pair's instructions by a count of the code, and
// the mel pass's bit-reversed positions another 10 %. The register caps
// (kMinBlocks) and kRegValues were chosen by timing builds with other
// values; as m = 1 instances, n_fft 512 and 1024 ran 7-28 % slower than
// log_mel_radix8dif.cu, so the route keeps those n_fft there. The block
// path's whole call: 0.36 ms at 1200/300 (1.94 before), 0.80 at 4036/1009
// (26.4), 0.80 at 12,288 (1.6), 1.15 at 16,384 (3.3), 1.27 at 1100 and 1.11
// at 16,380; what bounds it is instructions a butterfly and barriers a pass
// (16,384: the five row passes ~0.6 ms, the mel pass ~0.25, the staging,
// which reads each sample 16 times from L2, ~0.19).

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
// Block path: one block a frame pair, staged radix passes in shared memory

constexpr int kMaxBlockThreads = 1024;

// The pair sits in shared memory with each complex value a of a group of 16
// at a ^ h(a), h the XOR of the higher groups of four index bits: the
// power-of-two strides of the radix passes and of the digit-reversed bins
// fall on distinct banks. A permutation within each aligned group of 16, so
// a buffer takes its length rounded up to 16.
__host__ __device__ __forceinline__ int swz(int a) {
  return a ^ (((a >> 4) ^ (a >> 8) ^ (a >> 12)) & 15);
}
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// The block path's plan of n_fft = P * m (`mel_kernels.block_plan` mirrors
// it): Bluestein's length M (a power of two >= 2m - 1) where m has a prime
// factor above 7, else 0; the Bluestein columns transformed a round (all P
// where the workspace fits); threads a block (about 16 complex values a
// thread of the larger of the pair and a round's workspace); lanes a mel
// band; dynamic shared bytes (the pair, then the Bluestein workspace, each
// rounded up to 16 complex values).
struct BlockPlan {
  int n, p, log2_p, m, bluestein, columns, threads, mel_lanes;
  size_t smem;
};

inline BlockPlan block_plan(int n_fft, size_t smem_optin) {
  BlockPlan b{};
  b.n = n_fft;
  b.p = n_fft & -n_fft;
  b.log2_p = ilog2(b.p);
  b.m = n_fft / b.p;
  int rest = b.m;
  for (int f = 3; f <= 7; f += 2)
    while (rest % f == 0) rest /= f;
  if (rest > 1) {
    b.bluestein = 1;
    while (b.bluestein < 2 * b.m - 1) b.bluestein <<= 1;
  }
  auto bytes = [&](int cols) {
    return 8 * ((size_t)round16(n_fft) + (b.bluestein ? (size_t)round16(cols * b.bluestein) : 0));
  };
  b.columns = 1;
  if (b.bluestein) {
    b.columns = b.p;
    while (b.columns > 1 && bytes(b.columns) > smem_optin) b.columns /= 2;
  }
  b.smem = bytes(b.columns);
  const int work = n_fft > b.columns * b.bluestein ? n_fft : b.columns * b.bluestein;
  const int t = (work / 16 + 31) / 32 * 32;
  b.threads = t < 64 ? 64 : (t > kMaxBlockThreads ? kMaxBlockThreads : t);
  b.mel_lanes = 1;
  while (b.mel_lanes < 32 && 512 * b.mel_lanes <= n_fft) b.mel_lanes *= 2;
  return b;
}

// u / d for 0 <= u < 2^24 by the float reciprocal, corrected by one step.
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int div(int u) const {
    int q = __float2int_rz(__int2float_rn(u) * inv);
    const int r = u - q * d;
    if (r < 0) --q;
    else if (r >= d) ++q;
    return q;
  }
};

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// exp(-2 pi i u / d), 0 <= u < d, by sincospif: the argument 2u/d is exact
// for a power-of-two d and within an ulp otherwise, the result within an ulp
__device__ __forceinline__ float2 root(int u, int d) {
  float s, c;
  sincospif(-2.0f * (float)u / (float)d, &s, &c);
  return make_float2(c, s);
}

// a times -i (forward) or +i (inverse)
template <bool kInv>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-place R-point DFT, natural order in and out, by exp(-2 pi i / R)
// (forward) or exp(+2 pi i / R) (inverse, unscaled); R = 3, 5, 7 forward only.
template <int R, bool kInv>
__device__ __forceinline__ void small_dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else if constexpr (R == 4) {
    const float2 s02 = cadd(x[0], x[2]), d02 = csub(x[0], x[2]);
    const float2 s13 = cadd(x[1], x[3]), d13 = mul_i<kInv>(csub(x[1], x[3]));
    x[0] = cadd(s02, s13);
    x[2] = csub(s02, s13);
    x[1] = cadd(d02, d13);
    x[3] = csub(d02, d13);
  } else if constexpr (R == 8) {
    float2 e[4] = {x[0], x[2], x[4], x[6]}, o[4] = {x[1], x[3], x[5], x[7]};
    small_dft<4, kInv>(e);
    small_dft<4, kInv>(o);
    constexpr float h = 0.70710678118654752f;
    // W_8^k o[k], k = 1, 2, 3
    o[1] = kInv ? make_float2(h * (o[1].x - o[1].y), h * (o[1].x + o[1].y))
                : make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
    o[2] = mul_i<kInv>(o[2]);
    o[3] = kInv ? make_float2(-h * (o[3].x + o[3].y), h * (o[3].x - o[3].y))
                : make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = cadd(e[k], o[k]);
      x[k + 4] = csub(e[k], o[k]);
    }
  } else {
    static_assert(!kInv, "the odd radices run forward only");
    butterfly<R>(x);
  }
}

// A batch of equal-length transforms in shared memory: element e of
// transform j at buf[swz(j * bstride + e * estride)].
struct Batch {
  float2* buf;
  int len, count, bstride, estride;
};

// One radix-R pass over every transform of the batch at span S: the block of
// S elements from blk * S holds R sub-sequences, element s + t * (S / R) of
// the block the t-th of butterfly s. Forward (decimation in frequency): the
// R-point DFT, then output q times W_S^{s q}, in place. Inverse: the forward
// pass undone (times conj W_S^{s t}, then the inverse R-point DFT), unscaled.
// W_S^s comes from sincospif, its powers by products. `pre` (inverse): each
// element e times pre[e] as it is read. `post_bin` (forward): element e of
// transform j times W_N^{j post_bin[e]} as it is written (N = `post_n`). A
// butterfly an item; items go to threads transform-fastest where the
// transforms are adjacent words.
template <int R, bool kInv>
__device__ __forceinline__ void radix_pass(const Batch& a, int span,
                                           const float2* __restrict__ pre,
                                           const int* __restrict__ post_bin, int post_n) {
  const int sub = span / R, per = a.len / R, items = a.count * per;
  const bool count_fastest = a.bstride == 1 && a.count >= 16;
  // powers of two divide by shifts; the odd lengths by FastDiv
  constexpr bool kPow2 = (R & (R - 1)) == 0;
  const int log2_per = kPow2 ? __ffs(per) - 1 : 0, log2_sub = kPow2 ? __ffs(sub) - 1 : 0;
  const FastDiv by_count(a.count), by_per(per), by_sub(sub);
  for (int u = threadIdx.x; u < items; u += blockDim.x) {
    int j, jj;
    if (count_fastest) {
      jj = by_count.div(u);
      j = u - jj * a.count;
    } else {
      j = kPow2 ? u >> log2_per : by_per.div(u);
      jj = u - j * per;
    }
    const int blk = kPow2 ? jj >> log2_sub : by_sub.div(jj), s = jj - blk * sub;
    const int e0 = blk * span + s, base = j * a.bstride;
    float2 v[R];
    int at[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      at[t] = swz(base + (e0 + t * sub) * a.estride);
      v[t] = a.buf[at[t]];
      if (pre) v[t] = cmul(v[t], __ldg(pre + e0 + t * sub));
    }
    // W_S^{s q}, q = 1 .. R - 1
    float2 w[R];
    if (s) {
      w[1] = root(s, span);
#pragma unroll
      for (int q = 2; q < R; ++q) w[q] = cmul(w[q / 2], w[q - q / 2]);
    }
    if constexpr (kInv) {
      if (s) {
#pragma unroll
        for (int t = 1; t < R; ++t) v[t] = cmul_conj(v[t], w[t]);
      }
      small_dft<R, true>(v);
    } else {
      small_dft<R, false>(v);
      if (s) {
#pragma unroll
        for (int q = 1; q < R; ++q) v[q] = cmul(v[q], w[q]);
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float2 o = v[t];
      if (post_bin && j) o = cmul(o, root(j * __ldg(post_bin + e0 + t * sub), post_n));
      a.buf[at[t]] = o;
    }
  }
}

// The passes of a power-of-two length: radix 8 while the span holds 8, the
// rest (radix 2 or 4) at the smallest span. Forward from the whole length
// down, each output left at its digit-reversed position
// (`mel_kernels.digit_positions`); inverse the same passes undone from the
// smallest span up, which returns natural order. `pre` applies to the
// inverse's first pass, `post_bin` to the forward's last. A block barrier
// after each pass.
template <bool kInv>
__device__ void pow2_passes(const Batch& a, const float2* __restrict__ pre,
                            const int* __restrict__ post_bin, int post_n) {
  const int bits = __ffs(a.len) - 1;
  if (bits == 0) return;
  const int first = kInv ? (bits % 3 ? bits % 3 : 3) : bits;
  for (int s = first; kInv ? s <= bits : s > 0;) {
    const int r = s >= 3 ? 3 : s;
    const float2* p = kInv && s == first ? pre : nullptr;
    const int* pb = !kInv && s == r ? post_bin : nullptr;
    if (r == 3) radix_pass<8, kInv>(a, 1 << s, p, pb, post_n);
    else if (r == 2) radix_pass<4, kInv>(a, 1 << s, p, pb, post_n);
    else radix_pass<2, kInv>(a, 1 << s, p, pb, post_n);
    __syncthreads();
    s += kInv ? 3 : -r;
  }
}

// The forward passes of an odd length whose prime factors are 3, 5 and 7,
// the smallest first; output q at its digit-reversed position.
__device__ void odd_passes(const Batch& a) {
  for (int span = a.len; span > 1;) {
    const int r = smallest_factor(span);
    if (r == 3) radix_pass<3, false>(a, span, nullptr, nullptr, 0);
    else if (r == 5) radix_pass<5, false>(a, span, nullptr, nullptr, 0);
    else radix_pass<7, false>(a, span, nullptr, nullptr, 0);
    __syncthreads();
    span /= r;
  }
}

// The windowed frame pair, sample i at y[swz(i)]: row r of the four-step
// form (elements r + m n) is then the stride-m subsequence of the slice.
// kEdge: a frame reaches into the padding.
template <bool kEdge>
__device__ __forceinline__ void block_stage(float2* y, const float* __restrict__ wave, int start,
                                            int hop, int length, bool pair, int n,
                                            const float* __restrict__ window) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float w = __ldg(window + i);
    const int oa = start + i, ob = oa + hop;
    const float a = __ldg(wave + (kEdge ? reflect_index(oa, length) : oa));
    const float b = pair ? __ldg(wave + (kEdge ? reflect_index(ob, length) : ob)) : 0.0f;
    y[swz(i)] = make_float2(a * w, b * w);
  }
}

__global__ void __launch_bounds__(kMaxBlockThreads) log_mel_mixed_radix_block_kernel(
    const float* __restrict__ x,            // (B, length), unpadded
    int length, int hop, int n_frames, int pairs_per_example, BlockPlan plan,
    const float* __restrict__ window,       // (N)
    const int* __restrict__ col_bin,        // (P): the row bin at each position of a row
    const int* __restrict__ bin_slot,       // (N): where Z[k] ends, swizzled
    const float2* __restrict__ chirp,       // (m) or null: w_n = exp(-i pi (n^2 mod 2m) / m)
    const float2* __restrict__ chirp_hat,   // (M) or null: DFT_M(conj chirp) / M, forward order
    const int* __restrict__ mel_start, const int* __restrict__ mel_offset,
    const float* __restrict__ mel_weight, int n_mels,
    float* __restrict__ db) {               // (B, n_frames, n_mels)
  extern __shared__ float4 smem_f4[];
  const int n = plan.n, p = plan.p, m = plan.m, big_m = plan.bluestein;
  float2* y = reinterpret_cast<float2*>(smem_f4);  // the pair, then Z, then the power
  float2* ws = y + round16(n);                     // Bluestein's workspace
  const int tid = threadIdx.x, threads = blockDim.x;

  const int b = blockIdx.x / pairs_per_example;
  const int t0 = 2 * (blockIdx.x - b * pairs_per_example);
  const bool pair = t0 + 1 < n_frames;
  const float* wave = x + (size_t)b * length;
  const int start = t0 * hop - n / 2;
  const size_t f0 = (size_t)b * n_frames + t0;  // row of frame t0 in the dB scratch
  if (start < 0 || start + hop + n > length)
    block_stage<true>(y, wave, start, hop, length, pair, n, window);
  else
    block_stage<false>(y, wave, start, hop, length, pair, n, window);
  __syncthreads();

  // (1) The P-point FFTs of the m rows (row r: elements r + m n), the last
  // pass times (2) the twiddle W_N^{r k0} as it writes bin k0 of row r.
  pow2_passes<false>(Batch{y, p, m, 1, m}, nullptr, m > 1 ? col_bin : nullptr, n);
  // (3) The m-point DFT down each column (column c: elements c m + r).
  if (m > 1 && !big_m) {
    odd_passes(Batch{y, m, p, m, 1});
  } else if (m > 1) {
    // Bluestein: X_q = w_q sum_r (x_r w_r) conj(w_{q - r}), the convolution
    // by the M-point FFTs: the chirped column into the workspace, forward,
    // times DFT_M(conj w) / M (in the forward's order), inverse, times w_q.
    const int cols = plan.columns, log2_m = __ffs(big_m) - 1;
    const FastDiv by_m(m);
    for (int c0 = 0; c0 < p; c0 += cols) {
      for (int u = tid; u < cols * big_m; u += threads) {
        const int j = u >> log2_m, e = u & (big_m - 1);
        ws[swz(u)] = e < m ? cmul(y[swz((c0 + j) * m + e)], __ldg(chirp + e))
                           : make_float2(0.0f, 0.0f);
      }
      __syncthreads();
      const Batch w{ws, big_m, cols, big_m, 1};
      pow2_passes<false>(w, nullptr, nullptr, 0);
      pow2_passes<true>(w, chirp_hat, nullptr, 0);
      for (int u = tid; u < cols * m; u += threads) {
        const int j = by_m.div(u), q = u - j * m;
        y[swz((c0 + j) * m + q)] = cmul(ws[swz(j * big_m + q)], __ldg(chirp + q));
      }
      __syncthreads();
    }
  }

  // Z[k0 + P q] now sits at the odd passes' position of q plus m times the row
  // passes' position of k0, swizzled: `bin_slot[k]`.
  // Unpack: the thread of bin k <= N/2 reads Z[k] and Z[N - k] (whose slot
  // no thread writes, as N - k > N/2) and writes both frames' power over
  // Z[k], which only it reads.
  for (int k = tid; k <= n / 2; k += threads) {
    const int ia = __ldg(bin_slot + k), ib = __ldg(bin_slot + (k ? n - k : 0));
    const float2 za = y[ia], zb = y[ib];
    const float ar = za.x + zb.x, ai = za.y - zb.y;
    const float br = za.x - zb.x, bi = za.y + zb.y;
    y[ia] = make_float2(0.25f * (ar * ar + ai * ai), 0.25f * (br * br + bi * bi));
  }
  __syncthreads();

  // Mel bands: a group of mel_lanes lanes a band, lane l summing weights
  // l, l + mel_lanes, ... of both frames, then a shuffle tree in the group:
  // a fixed order, so two calls give equal bits. Group i takes bands i and
  // 2 groups - 1 - i of each pair of rounds, so that the wide high bands
  // spread over the groups.
  const int g = plan.mel_lanes, gl = tid & (g - 1), gid = tid / g, groups = threads / g;
  for (int mel0 = 0, round = 0; mel0 < n_mels; mel0 += groups, ++round) {
    const int mel = mel0 + (round & 1 ? groups - 1 - gid : gid);
    float a = 0.0f, c = 0.0f;
    if (mel < n_mels) {
      const int lo = __ldg(mel_offset + mel), hi = __ldg(mel_offset + mel + 1);
      const int k0 = __ldg(mel_start + mel) - lo;
#pragma unroll 4
      for (int j = lo + gl; j < hi; j += g) {
        const float w = __ldg(mel_weight + j);
        const float2 pw = y[__ldg(bin_slot + k0 + j)];
        a = fmaf(w, pw.x, a);
        c = fmaf(w, pw.y, c);
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(kFullMask, a, o);
      c += __shfl_xor_sync(kFullMask, c, o);
    }
    if (mel < n_mels && gl == 0) {
      db[f0 * n_mels + mel] = 10.0f * log10f(fmaxf(a, 1e-10f));
      if (pair) db[(f0 + 1) * n_mels + mel] = 10.0f * log10f(fmaxf(c, 1e-10f));
    }
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
  const float2 *tw_fft, *tw_rk, *tw_m;
  const int *col_bin, *bin_slot;
  const float2 *chirp, *chirp_hat;
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

// The block path's plan on `device`; the kernel's shared-memory opt-in is set
// once per device.
cudaError_t block_device_plan(int device, int n_fft, BlockPlan* plan, int* sms) {
  constexpr int kDevices = 64;
  static int optin[kDevices], sm_count[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (!optin[device]) {
    int smem_optin = 0, count = 0;
    cudaError_t err = cudaDeviceGetAttribute(&smem_optin,
                                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(log_mel_mixed_radix_block_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
    if (err != cudaSuccess) return err;
    sm_count[device] = count;
    optin[device] = smem_optin;
  }
  *plan = block_plan(n_fft, (size_t)optin[device]);
  *sms = sm_count[device];
  return plan->smem > (size_t)optin[device] ? cudaErrorInvalidValue : cudaSuccess;
}

int block_occupancy(int device, int n_fft, Occupancy* occ, BlockPlan* plan) {
  int sms = 0;
  cudaError_t err = block_device_plan(device, n_fft, plan, &sms);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, log_mel_mixed_radix_block_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, log_mel_mixed_radix_block_kernel,
                                                      plan->threads, plan->smem);
  if (err != cudaSuccess) return (int)err;
  *occ = Occupancy{kBlock, plan->threads / 32, blocks, attr.numRegs, sms, plan->smem};
  return 0;
}

int launch_block(const Args& a) {
  BlockPlan plan;
  int sms = 0;
  cudaError_t err = block_device_plan(a.device, a.n_fft, &plan, &sms);
  if (err != cudaSuccess) return (int)err;
  if (plan.bluestein && (!a.chirp || !a.chirp_hat)) return (int)cudaErrorInvalidValue;
  const int pairs_per_example = (a.n_frames + 1) / 2;
  const long long blocks = (long long)a.batch * pairs_per_example;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  log_mel_mixed_radix_block_kernel<<<(unsigned)blocks, plan.threads, plan.smem, a.stream>>>(
      a.x, a.length, a.hop, a.n_frames, pairs_per_example, plan, a.window, a.col_bin,
      a.bin_slot, a.chirp, a.chirp_hat, a.mel_start, a.mel_offset, a.mel_weight, a.n_mels,
      a.db);
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
// hop. The tables of both paths (`_twiddles_mixed_radix` and `_block_tables`
// in ops/mel_kernels.py), P the largest power of two dividing n_fft and m =
// n_fft / P: the warp path reads tw_fft, the stage twiddles W_{2h}^j at
// [h - 1 + j] (P - 1), tw_rk W_N^{r k0} (m - 1, P) and tw_m W_m^j (m); the
// block path col_bin (P), bin_slot (N) and, where m has a prime factor above
// 7, Bluestein's chirp (m) and chirp_hat (M), null elsewhere.
int log_mel_mixed_radix_launch(int device, const void* x, int batch, int length, int n_fft,
                               int hop, int n_frames, const void* window, const void* tw_fft,
                               const void* tw_rk, const void* tw_m, const void* col_bin,
                               const void* bin_slot, const void* chirp, const void* chirp_hat,
                               const void* mel_start, const void* mel_offset,
                               const void* mel_weight, int n_mels, void* db, void* stream) {
  if (n_fft < 4 || n_fft % 4 || batch < 1 || length < 1 || n_frames < 1 || n_mels < 1 ||
      hop < 1 || (long long)(n_frames - 1) * hop > (long long)length)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const float*)x, batch, length, n_fft, hop, n_frames, (const float*)window,
               (const float2*)tw_fft, (const float2*)tw_rk, (const float2*)tw_m,
               (const int*)col_bin, (const int*)bin_slot, (const float2*)chirp,
               (const float2*)chirp_hat, (const int*)mel_start,
               (const int*)mel_offset,
               (const float*)mel_weight, n_mels, (float*)db, (cudaStream_t)stream, device};
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

// The launch shape of n_fft on `device`, into out[7]: path (0 block, 1 warp
// with the rows in registers, 2 warp with the rows in shared memory), warps
// a block, blocks an SM, registers a thread, dynamic shared bytes a block;
// then the block path's Bluestein length M (0: the staged radix-3/5/7
// passes) and its columns a round (0 on the warp path).
int log_mel_mixed_radix_occupancy(int device, int n_fft, int* out) {
  if (n_fft < 4 || n_fft % 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Occupancy occ;
  BlockPlan plan{};
  int e = 0;
  switch (n_fft) {
#define CASE(n, p, m)                 \
  case n:                             \
    e = occupancy_warp<p, m>(device, &occ); \
    break;
    MIXED_RADIX_WARP_INSTANCES(CASE)
#undef CASE
    default:
      e = block_occupancy(device, n_fft, &occ, &plan);
  }
  if (e) return e;
  out[0] = occ.path;
  out[1] = occ.warps;
  out[2] = occ.blocks_per_sm;
  out[3] = occ.regs;
  out[4] = (int)occ.smem;
  out[5] = plan.bluestein;
  out[6] = plan.columns;
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

// The epilogue's plan of a call (log_mel_epilogue.cuh), into out[4]: CTAs an
// example, frames a CTA, resident (1) or re-read (0), shared bytes a CTA.
int log_mel_epilogue_plan(int device, int batch, int n_frames, int n_mels, int* out) {
  return log_mel_epilogue_plan_of(device, batch, n_frames, n_mels, out);
}

}  // extern "C"
