// Log-mel front end for Hopper (sm_90a) as a folded real-input DFT on
// `wgmma`, fed by a TMA ring: port of the TPU kernels `_kernel_f32` and
// `_kernel_bf16x3` (one `pallas_call` in `log_mel_pallas`,
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
// What bounds it. The function (a padded waveform in, a log-mel out) is bound
// by bytes: 0.0187 ms at 1001/250 for 128 clips of 5 s (chip_smoke.py
// `log_mel_bound_ms`). The design is bound by TF32 tensor-core operations: at
// 1001/250 (M = 41,088 frames, K = 500 folded samples padded to 512, 501 bins
// padded to 504) it runs 2 x 3 products of M x 504 x 512, 127 GFLOP, 0.257 ms
// at the card's dense TF32 peak (495 TFLOP/s): the folded floor. Issuing
// the instructions around the products (the fold, the loads, the CUDA-core
// adds of the precision remedy, the waits) keeps it from that floor; PERF.md
// section 6 has the measurements.
//
// The fold. The periodic Hann window has w[0] = 0 and w[N - n] = w[n], and
// cos(2 pi k (N - n) / N) = cos(2 pi k n / N), sin(2 pi k (N - n) / N) =
// -sin(2 pi k n / N). So with K = N / 2 (rounded down), s_n = x_n + x_{N-n}
// and d_n = x_n - x_{N-n} for 1 <= n <= K,
//   Re X_k =  sum_n s_n c_n w_n cos(2 pi k n / N),
//   Im X_k = -sum_n d_n w_n sin(2 pi k n / N),
// where c_n = 1, except c_{N/2} = 1/2 at even N: there x_{N-n} is x_n itself,
// so s_{N/2} = 2 x_{N/2} counts the single middle term twice (and d_{N/2} = 0,
// sin(pi k) = 0). The n = 0 term vanishes (w_0 = 0). The window and c_n go
// into the constant operand, C[k][n - 1] = c_n w_n cos(2 pi ((n k) mod N) / N)
// and S[k][n - 1] = w_n sin(2 pi ((n k) mod N) / N), built once per (n_fft,
// device) in float64 from the exact integer index (ops/mel_kernels.py
// `_dft_fold_constants`). The frame operand is then the fold alone: two f32
// loads, an add and a subtract a sample. That halves the DFT's K, and since
// the power ignores the sign of Im X_k, so does the work.
//
// Precision. TF32 keeps 10 of f32's 23 mantissa bits. Each operand x splits
// into hi = tf32(x) and lo = tf32(x - hi); the constants arrive split (four
// matrices: C_hi, C_lo, S_hi, S_lo), the frame operand is split in registers
// (s and d, once for each bin tile). Each product runs as three TF32 `wgmma`s,
// lo*hi + hi*lo + hi*hi. The tensor cores' f32 accumulation truncates, so one
// accumulator carried over all of K biases the sum toward zero (on the H100
// that missed the f64 plain version by 9.4e-4 dB at 1001/250). So a chain of
// `wgmma`s starts from zero (scale-d = 0) every kReset 8-deep steps, and its
// result is added into the running f32 sum on the CUDA cores, which round to
// nearest. kReset is 1. A CPU model of that arithmetic with truncating
// accumulation (tests/test_torch_mel_dft_fold.py; each `wgmma` rounds its sum
// toward zero) keeps every row-7 shape within 1e-4 dB of the f64 plain version
// on seeded noise at 1, 2 and 4 steps, so precision allowed a longer interval;
// speed did not: on the H100 the 2-step build (whose wgmmas ptxas serializes,
// C7514) and the 4-step one were both slower than this one, in a probe that is
// not committed.
//
// The pipeline. A block has three warpgroups and owns 128 frame rows of the
// flattened (B * T) frame axis (row r is example r / T, frame r % T; nothing
// is padded per example) and their bin tiles, all or half (below):
// warpgroup 0 is the producer, warpgroups 1 and 2 the consumers, 64 rows
// each. `setmaxnreg` gives the producer 40 registers and each consumer thread
// 232.
// - Producer: one thread walks the bin tiles (72 bins) and, in each, the K
//   chunks (32 folded samples), and keeps a ring of 3 stages in flight with
//   `cp.async.bulk.tensor` (TMA): one 3-D box a stage, 72 x 32 floats of each
//   of the four constant matrices (36,864 bytes), K-major with the 128-byte
//   swizzle that the `wgmma` descriptors name. `mbarrier`s: full (the TMA's
//   transaction bytes) and empty (the 256 consumer threads).
// - Consumers: for each bin tile, each chain runs `wgmma.mma_async`
//   m64n72k8 .f32.tf32.tf32 with A (the split fold) from registers and B from
//   the stage in shared memory: three for the cos product into one 72-column
//   product buffer, three for the sin product into another, each its own
//   commit group. The cos chain runs while the thread adds the last sin
//   product into its running sum (`wgmma.wait_group 1`) and starts the sin
//   chain; then it waits for both (`wait_group 0`: with 1 there, ptxas
//   serializes every wgmma), adds the cos product, folds and splits the next
//   samples (loaded a chain ahead) and starts the next cos chain. The two
//   consumer warpgroups run out of step, so one's products cover the other's
//   adds. A chunk's stage goes back to the producer at the next chunk's first
//   wait, which finds both of its last chains done.
// - After each bin tile: power = re^2 + im^2 from matching cos / sin
//   registers into a 64 x 73 tile in shared memory, then the mel sums: a
//   triangular filterbank puts a bin in at most one even and one odd band, so
//   thread (row, parity) walks the tile's bins in order with a per-bin table
//   (`mel_bin_table`) and adds each into its mel's cell of a 64 x (n_mels +
//   1) f32 accumulator in shared memory: a fixed order, no atomics, so a run
//   repeats bit for bit. Padded bins (past N/2 + 1) get zero constants and no
//   mel; padded K columns get zero constants and read clamped, finite
//   samples. Rows past the last frame read the first frame and are not stored.
//
// Numbers (128 mels; 1001/250, 128 x 5 s). Registers: each consumer thread
// holds 72 running sums (cos, sin), 72 product floats and 16 split operand
// registers within its 232; ptxas -v reports the 168 a thread of the launch
// and no spills. Shared memory a block: 3 x 36,864 ring + 48 barrier bytes +
// 2 x (4 x 64 x (73 + n_mels + 1) + 16 x 72) + 1,024 alignment = 217,392
// bytes, so n_mels up to 157 fits the 232,448-byte opt-in; the entry point
// refuses more. One block an SM: 321 row tiles fill 2.43 waves of 132 SMs,
// the last at 43 %. So where it fills the waves better (ops/mel_kernels.py
// `dft_fold_splits`), two blocks share a row tile, each taking a contiguous
// half of its bin tiles (642 blocks, 4.86 waves), and `combine_halves_kernel`
// adds the two halves' mel sums in a fixed order and takes them to dB. Each
// row tile streams all of B once from L2: 4.13 MB, 1.33 GB a call. The
// constants take 4 x K_pad x bins_pad x 4 bytes: 4.1 MB at n_fft 1001, 1.08 GB
// at 16,383 (the wrappers' limit is 16,384, `MIXED_RADIX_MAX_N_FFT`).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "log_mel_epilogue.cuh"

namespace {

constexpr int kBinTile = 72;                       // bins a tile: the wgmma N
constexpr int kAcc = kBinTile / 2;                 // accumulator floats a thread a product
constexpr int kKChunk = 32;                        // folded samples a stage: one 128-byte row
constexpr int kSteps = kKChunk / 8;                // 8-deep wgmma steps a stage
constexpr int kReset = 1;                          // steps a tensor-core chain sums from zero
constexpr int kChains = kSteps / kReset;           // chains a stage
constexpr int kStages = 3;                         // TMA ring depth
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kRowsPerWg = 64;                     // frame rows a consumer warpgroup
constexpr int kTileM = kRowsPerWg * kConsumers;    // frame rows a block
constexpr int kThreads = 128 * (1 + kConsumers);   // producer warpgroup + consumers
constexpr int kMatBytes = kBinTile * kKChunk * 4;  // one matrix's box: 9 x 1024 bytes
constexpr int kStageBytes = 4 * kMatBytes;         // C_hi, C_lo, S_hi, S_lo
constexpr int kStrideP = kBinTile + 1;             // power row (a frame), in words
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory a block, in bytes: alignment slack for the 1024-byte swizzle
// atoms, the ring, its barriers, then each consumer's power tile, mel sums
// (rows padded to n_mels + 1 words) and the bin tile's slice of the mel table.
inline size_t fold_smem_bytes(int n_mels) {
  return 1024 + (size_t)kStages * kStageBytes + 2 * kStages * 8 +
         (size_t)kConsumers * (4 * kRowsPerWg * (kStrideP + n_mels + 1) + 16 * kBinTile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at `dst`; the
// transfer's bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// named barrier over one consumer warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in program order around the asynchronous
// wgmma (the compiler must not read them before the wait that ends it).
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a K-major B operand with the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused for this layout), stride 1024
// bytes between 8-row groups (8 rows of 128 bytes), layout type 1 (B128).
// A k step of 8 floats inside the 128-byte row moves the start by 32 bytes.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 72, f32) = [d +] a (64 x 8, TF32, registers) * b (8 x 72, TF32,
// shared memory, K-major). a holds the thread's m16n8k8-style A fragment of
// its warp's 16 rows: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8,"
      " %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      " %18, %19, %20, %21, %22, %23, %24, %25, %26,"
      " %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d = the sum over kReset steps i of lo(a_i) hi(b_i) + hi(a_i) lo(b_i) +
// hi(a_i) hi(b_i), from zero: one chain. b_hi, b_lo are the descriptors of
// the chain's first step; step i starts 32 i bytes further (2 i in the
// descriptor's address field).
__device__ __forceinline__ void chain(float (&d)[kAcc], const uint32_t (&hi)[kReset][4],
                                      const uint32_t (&lo)[kReset][4], uint64_t b_hi,
                                      uint64_t b_lo) {
#pragma unroll
  for (int i = 0; i < kReset; ++i) {
    wgmma_tf32(d, lo[i], b_hi + 2 * i, i > 0);
    wgmma_tf32(d, hi[i], b_lo + 2 * i, 1);
    wgmma_tf32(d, hi[i], b_hi + 2 * i, 1);
  }
}

// The frames a consumer thread folds: rows g and g + 8 of its warp's 16.
struct FrameRows {
  const float* p0;
  const float* p1;
  int lim0, lim1;  // the last in-bounds offset from each row's first sample
};

// Row m of the flattened frame axis: its first sample in the padded
// waveform, and the largest offset that stays inside its example (the last
// frame at odd N reaches one past it: the clamp). Rows past the last frame
// read example 0's first frame; their results are never stored.
__device__ __forceinline__ const float* frame_row(const float* x_pad, int m, int n_rows,
                                                  int n_frames, int padded_len, int hop,
                                                  int& lim) {
  if (m >= n_rows) {
    lim = padded_len - 1;
    return x_pad;
  }
  const int b = m / n_frames, t = m - b * n_frames;
  lim = padded_len - 1 - t * hop;
  return x_pad + (size_t)b * padded_len + (size_t)t * hop;
}

// The samples of chain `chain`, steps j = kReset chain + i: x_n and x_{N-n}
// at n = 8 j + q + 1 and n + 4 (the fold's column is n - 1), for both rows,
// in fragment order. Columns past K repeat column K, whose constants are zero.
__device__ __forceinline__ void load_chain(float (&raw)[kReset][8], const FrameRows& r,
                                           int chain, int q, int k_half, int n_fft) {
#pragma unroll
  for (int i = 0; i < kReset; ++i) {
    const int n0 = 8 * (kReset * chain + i) + q + 1;
    const int na = min(n0, k_half), nb = min(n0 + 4, k_half);
    raw[i][0] = __ldg(r.p0 + na);
    raw[i][1] = __ldg(r.p0 + min(n_fft - na, r.lim0));
    raw[i][2] = __ldg(r.p1 + na);
    raw[i][3] = __ldg(r.p1 + min(n_fft - na, r.lim1));
    raw[i][4] = __ldg(r.p0 + nb);
    raw[i][5] = __ldg(r.p0 + min(n_fft - nb, r.lim0));
    raw[i][6] = __ldg(r.p1 + nb);
    raw[i][7] = __ldg(r.p1 + min(n_fft - nb, r.lim1));
  }
}

// s = x_n + x_{N-n} and d = x_n - x_{N-n}, each split into TF32 hi and lo:
// the A fragments of a cos chain and a sin chain.
__device__ __forceinline__ void fold(const float (&raw)[kReset][8], uint32_t (&s_hi)[kReset][4],
                                     uint32_t (&s_lo)[kReset][4], uint32_t (&d_hi)[kReset][4],
                                     uint32_t (&d_lo)[kReset][4]) {
#pragma unroll
  for (int i = 0; i < kReset; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(raw[i][2 * e] + raw[i][2 * e + 1], s_hi[i][e], s_lo[i][e]);
      split_tf32(raw[i][2 * e] - raw[i][2 * e + 1], d_hi[i][e], d_lo[i][e]);
    }
}

__global__ void __launch_bounds__(kThreads, 1) log_mel_dft_gemm_kernel(
    const __grid_constant__ CUtensorMap consts,  // (4, bins_pad, k_pad) f32: C_hi, C_lo, S_hi, S_lo
    const float* __restrict__ x_pad,             // (B, padded_len)
    int padded_len, int n_fft, int hop, int n_frames, int n_rows, int k_half, int k_chunks,
    int bin_tiles, int tiles_per_split, int n_bins,
    const int4* __restrict__ mel_table,  // (bins_pad): (even mel, its weight, odd mel, its weight)
    int n_mels,
    float* __restrict__ db,        // (B * n_frames, n_mels): dB, or split 0's mel sums
    float* __restrict__ partial) {  // split 1's mel sums, when gridDim.y == 2
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + kStages * kStageBytes, empty0 = full0 + 8 * kStages;
  float* wg_smem = reinterpret_cast<float*>(smem + kStages * kStageBytes + 16 * kStages);
  const int wg = threadIdx.x / 128;
  // this block's bin tiles: all of them, or one of two halves (gridDim.y)
  const int bt0 = blockIdx.y * tiles_per_split, bt1 = min(bt0 + tiles_per_split, bin_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, bin tile by bin tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int bt = bt0; bt < bt1; ++bt)
        for (int c = 0; c < k_chunks; ++c) {
          mbar_wait(empty0 + 8 * st, ph ^ 1);
          mbar_expect_tx(full0 + 8 * st, kStageBytes);
          tma_load_3d(ring + st * kStageBytes, &consts, full0 + 8 * st, c * kKChunk,
                      bt * kBinTile, 0);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cons = wg - 1, ct = threadIdx.x - 128 * wg;
    const int lane = ct & 31, w4 = ct >> 5, g = lane >> 2, q = lane & 3;
    const int stride_m = n_mels + 1;  // rows a word apart: at 128 mels, a mel's 16 rows in 16 banks
    float* p_s = wg_smem + (size_t)cons * (kRowsPerWg * (kStrideP + stride_m) + 4 * kBinTile);
    float* acc_s = p_s + kRowsPerWg * kStrideP;                    // [64][stride_m] mel sums
    int4* tab_s = reinterpret_cast<int4*>(acc_s + kRowsPerWg * stride_m);  // [kBinTile]
    const int row0 = blockIdx.x * kTileM + cons * kRowsPerWg;
    FrameRows rows;
    rows.p0 = frame_row(x_pad, row0 + 16 * w4 + g, n_rows, n_frames, padded_len, hop, rows.lim0);
    rows.p1 = frame_row(x_pad, row0 + 16 * w4 + g + 8, n_rows, n_frames, padded_len, hop,
                        rows.lim1);
    for (int i = ct; i < kRowsPerWg * stride_m; i += 128) acc_s[i] = 0.0f;

    const int n_chains = k_chunks * kChains;
    float raw[kReset][8];  // the samples of the next chain to fold, loaded a chain ahead
    load_chain(raw, rows, 0, q, k_half, n_fft);
    int st = 0, prev = 0;
    uint32_t ph = 0;
    constexpr uint64_t kMat = kMatBytes >> 4, kChainStep = 32 * kReset >> 4;  // descriptor units
    for (int bt = bt0; bt < bt1; ++bt) {
      float sum_c[kAcc], sum_s[kAcc], pc[kAcc], ps[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum_c[i] = sum_s[i] = pc[i] = ps[i] = 0.0f;
      uint32_t s_hi[kReset][4], s_lo[kReset][4], d_hi[kReset][4], d_lo[kReset][4];
      // this tile's slice of the mel table, loaded now, stored after the products
      constexpr int kTabWords = 4 * kBinTile, kTabLoads = (kTabWords + 127) / 128;
      const int* tab_g = reinterpret_cast<const int*>(mel_table) + bt * kTabWords;
      int tab[kTabLoads];
#pragma unroll
      for (int j = 0; j < kTabLoads; ++j)
        tab[j] = ct + 128 * j < kTabWords ? __ldg(tab_g + ct + 128 * j) : 0;
      // chain 0's cos product
      fold(raw, s_hi, s_lo, d_hi, d_lo);
      load_chain(raw, rows, 1, q, k_half, n_fft);
      mbar_wait(full0 + 8 * st, ph);
      {
        const uint64_t b0 = b_desc(ring + st * kStageBytes);
        wgmma_fence();
        chain(pc, s_hi, s_lo, b0, b0 + kMat);
        wgmma_commit();
      }
      for (int c = 0; c < k_chunks; ++c) {
        const uint64_t stage = b_desc(ring + st * kStageBytes);
#pragma unroll
        for (int h = 0; h < kChains; ++h) {
          const int j = c * kChains + h;
          wgmma_wait<1>();  // the sin chain j - 1 is done
          fence_acc(ps);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) sum_s[i] += ps[i];
          if (h == 0 && c > 0) mbar_arrive(empty0 + 8 * prev);  // chunk c - 1 is read
          wgmma_fence();
          chain(ps, d_hi, d_lo, stage + 2 * kMat + kChainStep * h,
                stage + 3 * kMat + kChainStep * h);
          wgmma_commit();
          // the cos chain j is done. wait_group 0, not 1: with 1, ptxas
          // serializes every wgmma (C7514, "reading accumulator registers
          // ... between start and end of the pipeline stage"); the other
          // consumer warpgroup keeps the tensor cores busy meanwhile
          wgmma_wait<0>();
          fence_acc(pc);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) sum_c[i] += pc[i];
          // chain j + 1's cos product. Every chain starts one, the last a
          // spare on the stage it holds (discarded), so the commit groups in
          // flight are the same on every path (else ptxas serializes, C7513)
          uint64_t next = stage + kChainStep * (h + 1);
          if (h == kChains - 1) {
            prev = st;
            if (++st == kStages) {
              st = 0;
              ph ^= 1;
            }
            next = stage;
            if (c + 1 < k_chunks) {
              mbar_wait(full0 + 8 * st, ph);
              next = b_desc(ring + st * kStageBytes);
            }
          }
          if (j + 1 < n_chains) {  // both chains of j are done: their registers are free
            fold(raw, s_hi, s_lo, d_hi, d_lo);
            load_chain(raw, rows, j + 2 < n_chains ? j + 2 : j + 2 - n_chains, q, k_half,
                       n_fft);  // wraps to the next tile
          }
          wgmma_fence();
          chain(pc, s_hi, s_lo, next, next + kMat);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();  // the last sin chain and the spare are done
      fence_acc(ps);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum_s[i] += ps[i];
      mbar_arrive(empty0 + 8 * prev);

      // power from matching cos / sin accumulators: element 4 j + e is row
      // g + 8 (e / 2) of the warp's 16, column 8 j + 2 q + (e % 2)
      warpgroup_sync(1 + cons);  // the last tile's mel pass is done with p_s and tab_s
      int* tab_w = reinterpret_cast<int*>(tab_s);
#pragma unroll
      for (int j = 0; j < kTabLoads; ++j)
        if (ct + 128 * j < kTabWords) tab_w[ct + 128 * j] = tab[j];
#pragma unroll
      for (int j = 0; j < kBinTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * w4 + g + 8 * (e >> 1), col = 8 * j + 2 * q + (e & 1);
          const float re = sum_c[4 * j + e], im = sum_s[4 * j + e];
          p_s[r * kStrideP + col] = re * re + im * im;
        }
      warpgroup_sync(1 + cons);
      // mel sums over this tile's bins: a triangular filterbank puts a bin in
      // at most two bands, an even and an odd mel (the table, built on the
      // host, says which), so thread (row r, parity) walks the tile's bins in
      // order and adds each into its mel of that parity, keeping the cell it
      // is on in a register. Each cell sums its band's bins in order, tile
      // after tile: a fixed order, no atomics.
      {
        const int r = ct >> 1, par = ct & 1;
        const float* pr = p_s + r * kStrideP;
        float* ar = acc_s + r * stride_m;
        const int k_count = min(kBinTile, n_bins - bt * kBinTile);
        int cur = -1;
        float acc = 0.0f;
        for (int k = 0; k < k_count; ++k) {
          const int4 t4 = tab_s[k];
          const int m = par ? t4.z : t4.x;
          if (m != cur) {
            if (cur >= 0) ar[cur] = acc;
            cur = m;
            if (m >= 0) acc = ar[m];
          }
          if (m >= 0) acc += __int_as_float(par ? t4.w : t4.y) * pr[k];
        }
        if (cur >= 0) ar[cur] = acc;
      }
    }
    warpgroup_sync(1 + cons);  // every cell's last sum is stored
    // dB, or with the bins split over two blocks each half's sums, which
    // combine_halves_kernel adds (half 0 + half 1) and takes to dB
    float* out = blockIdx.y == 0 ? db : partial;
    for (int i = ct; i < kRowsPerWg * n_mels; i += 128) {
      const int r = i / n_mels, m = i - r * n_mels;
      const float v = acc_s[r * stride_m + m];
      if (row0 + r < n_rows)
        out[(size_t)(row0 + r) * n_mels + m] =
            gridDim.y > 1 ? v : 10.0f * log10f(fmaxf(v, 1e-10f));
    }
  }
}

__global__ void combine_halves_kernel(float* __restrict__ db, const float* __restrict__ partial,
                                      size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    db[i] = 10.0f * log10f(fmaxf(db[i] + partial[i], 1e-10f));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Spectrum pass: (B, padded_len) -> dB scratch (B, n_frames, n_mels), for any
// n_fft from 2 and any hop. `consts` is (4, bins_pad, k_pad) f32 (C_hi, C_lo,
// S_hi, S_lo; ops/mel_kernels.py `_dft_fold_constants`) with k_pad = N / 2
// rounded up to 32 and bins_pad = N / 2 + 1 rounded up to 72; `mel_table` is
// (bins_pad) int4 (ops/mel_kernels.py `mel_bin_table`). `splits` (1 or 2):
// the blocks a row tile's bin tiles are split over (ops/mel_kernels.py
// `dft_fold_splits`); at 2, `partial` is a second (B, n_frames, n_mels)
// scratch. The last frame may run one sample past the padded signal (odd
// n_fft); its index clamps.
int log_mel_dft_gemm_launch(int device, const void* x_pad, int batch, int padded_len,
                            int n_fft, int hop, int n_frames, const void* consts, int k_pad,
                            int bins_pad, const void* mel_table, int n_mels, void* db,
                            int splits, void* partial, void* stream) {
  const int k_half = n_fft / 2, n_bins = n_fft / 2 + 1;
  if (n_fft < 2 || batch < 1 || n_frames < 1 || n_mels < 1 || hop < 1 ||
      (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len + 1 ||
      (size_t)padded_len + n_fft > 0x7fffffffu ||
      k_pad != (k_half + kKChunk - 1) / kKChunk * kKChunk ||
      bins_pad != (n_bins + kBinTile - 1) / kBinTile * kBinTile || splits < 1 || splits > 2 ||
      (splits == 2 && (partial == nullptr || bins_pad < 2 * kBinTile)))
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)batch * n_frames;
  if (n_rows + kTileM > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rows + kTileM - 1) / kTileM);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fold_smem_bytes(n_mels);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)k_pad, (cuuint64_t)bins_pad, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)k_pad * 4, (cuuint64_t)k_pad * bins_pad * 4};
  const cuuint32_t box[3] = {kKChunk, kBinTile, 4};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(consts), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log_mel_dft_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bin_tiles = bins_pad / kBinTile, per_split = (bin_tiles + splits - 1) / splits;
  log_mel_dft_gemm_kernel<<<dim3(blocks, splits), kThreads, smem, (cudaStream_t)stream>>>(
      map, (const float*)x_pad, padded_len, n_fft, hop, n_frames, (int)n_rows, k_half,
      k_pad / kKChunk, bin_tiles, per_split, n_bins, (const int4*)mel_table, n_mels,
      (float*)db, (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_halves_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      (float*)db, (const float*)partial, (size_t)n_rows * n_mels);
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
