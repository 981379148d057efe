// Fused eval ConvBlocks 2 and 3 of LightweightCNN for Hopper (sm_90a): port
// of the TPU kernel `_kernel_packed`, launched by `_fused_conv_packed` for
// `fused_conv_block2` (32 -> 64) and `fused_conv_block3` (64 -> 128)
// (audio_classification_icbhi_tpu/ops/pallas_conv.py:157, :207, :263, :279).
//
// Function: (B, H, W, ci) bf16 NHWC, of which the first `w_valid` columns are
// read -> conv3x3 ci->co (pad 1) with the eval BatchNorm folded into the taps
// -> + bias (f32) -> ReLU -> maxpool 2x2 (floor) -> (B, H/2, out_w, co) bf16,
// columns w_valid/2 .. out_w - 1 zero. Rounding as on the TPU: bf16 input and
// taps, exact products summed in f32 (the tensor cores' bf16 -> f32 product),
// f32 bias, ReLU and max, one rounding to bf16 at the store.
//
// What bounds it on this card: at serving, block 2 is (128, 64, 78, 32) ->
// (128, 32, 39, 64) and block 3 (128, 32, 39, 64) -> (128, 16, 19, 128); each
// is 23.6 GFLOP, 0.0238 / 0.0232 ms on the bf16 tensor cores at 989 TFLOP/s,
// against 0.0183 / 0.0091 ms for their bytes at 3.35 TB/s: operations.
//
// The design: a persistent implicit GEMM on `wgmma`, fed by TMA.
// - M is pre-pool pixels, N the output channels (all co in one `wgmma`:
//   m64n64k16 at block 2, m64n128k16 at block 3), K = 9 * ci ordered
//   (tap = dh * 3 + dw, c_in), one tap at a time.
// - A CTA is two consumer warpgroups and one producer warp, and stays on its
//   SM for the whole call (grid = the CTAs that fit at once). It loads all
//   taps into shared memory once, one bulk copy a tap, each on its own
//   `mbarrier` (the first m64 tile starts on tap 0 while the rest arrive),
//   in the layout that a `wgmma` B descriptor reads: for each tap a K-major
//   co x ci block with the 128-byte (ci 64) or 64-byte (ci 32) swizzle,
//   built on the host (ops/conv_kernels.py `wgmma_tap_image`).
// - Output tiles are `rows` pooled rows x 4 * `slots` pooled columns of one
//   example (ops/conv_kernels.py `packed_schedule`). The producer walks the
//   CTA's tiles and keeps a ring of two stages full by TMA: one 4-D box a
//   tile, (2 rows + 2) x (8 slots + 2) pixels x ci channels from the origin
//   (2 h2_0 - 1, 2 w2_0 - 1) of a tensor map over (B, H, w_valid, ci) whose
//   row pitch is w_pitch * ci * 2 bytes. TMA zero-fills the halo outside the
//   image and every column at or past w_valid, so no load is checked, and
//   swizzles each pixel's ci * 2 bytes as the B blocks are swizzled.
//   `mbarrier`s: full (the box's bytes), empty (one arrival a slot).
// - A slot is 4 pooled windows of one pooled row: the 16 pre-pool pixels of
//   one warp's 16 rows of a `wgmma` m64 tile. Row g (0..7) of the warp is the
//   top pixel of window g & 3, left for g < 4, right for g >= 4; row g + 8 is
//   the pixel under it. So each thread's accumulator holds the top and bottom
//   pixel of one window column (max in registers), and the other column is in
//   lane ^ 16 (one shuffle). The 8 rows of an `ldmatrix` phase are then 8
//   consecutive pixels of the staged box, whose swizzle phases differ: no
//   bank conflict.
// - The CTA's slots are numbered through its tiles (a tile holds rows x
//   slots of them) and a consumer warpgroup takes 4 consecutive slots, an m64
//   tile, in turn with the other: the two stay balanced whatever a tile's
//   slot count, and an m64 tile may span two stages (each warp waits on its
//   own slot's stage). A tile has at least 8 slots, so every warp meets every
//   tile, which keeps the parity waits one phase apart and the ring free of
//   deadlock.
// - A from registers: per tap, each warp's `ldmatrix.x4` loads of the staged
//   box are the implicit im2col (lane = one (pixel, 8 channels) row, the
//   swizzle's XOR applied to the address); B by descriptor from the resident
//   taps. At block 3 the next tap's fragments load while this tap's
//   `wgmma`s run (two register sets, `wgmma.wait_group 1`); at block 2 the
//   other warpgroups cover the load.
// - Epilogue per warp: the 2 x 2 max (registers, one shuffle), bias, ReLU,
//   bf16, staged through 1 KB of shared memory, then 16 bytes a lane: the
//   slot's 4 windows x co channels are one contiguous run of the output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_grid.cuh"

namespace {

constexpr int kConsumers = 2;                     // consumer warpgroups a CTA
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kStages = 2;                        // TMA ring depth
constexpr int kMinTileSlots = 4 * kConsumers;     // see the slot walk above

template <int CI, int CO>
struct Cfg {
  static constexpr int kPixBytes = 2 * CI;                 // one pixel: one swizzle row
  static constexpr int kTapBlock = CO * kPixBytes;         // one tap's B block
  static constexpr int kTapBytes = 9 * kTapBlock;
  static constexpr int kKSteps = CI / 16;                  // 16-deep k-steps a tap
  static constexpr int kAcc = CO / 2;                      // accumulator floats a thread
  static constexpr int kWinPitch = 2 * CO + 32;            // staged window, bytes
  static constexpr int kStagingBytes = kConsumers * 4 * 4 * kWinPitch;
  static constexpr int kMinBlocks = CO == 64 ? 2 : 1;      // CTAs an SM
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of `bar` with this parity; a wait past 4 seconds
// traps (a launch error) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries++ == 0) t0 = global_ns();
    else if ((tries & 1023) == 0 && global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` contiguous bytes from global memory into shared memory at `dst`,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of `map` into shared memory at `dst`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// Pins accumulator registers after the wait that ends the asynchronous
// `wgmma`s (the compiler must not read them earlier).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a K-major B block, rows of `kPixBytes` with
// the matching swizzle: start >> 4, leading offset 1 (unused when swizzled),
// 8 rows between core-matrix groups, layout 1 (128-byte) or 2 (64-byte).
template <int CI>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t kSbo = (8 * 2 * CI) >> 4;
  constexpr uint64_t kLayout = CI == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (kSbo << 32) | (kLayout << 62);
}

// d (64 x N, f32) [+]= a (64 x 16 bf16, registers: each warp's m16n8k16 A
// fragment of its 16 rows) * b (16 x N bf16, shared memory, K-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int CO>
__device__ __forceinline__ void wgmma_tile(float (&d)[CO / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (CO == 64)
    wgmma_n64(d, a, desc, scale_d);
  else
    wgmma_n128(d, a, desc, scale_d);
}

// This lane's `ldmatrix` rows of one tap: pixel p of the staged box, its 16
// byte chunks 2 kc + khalf for each k-step kc, with the swizzle's XOR (the
// chunk index XOR address bits 7.. of the pixel's row).
template <int CI>
__device__ __forceinline__ void load_tap(uint32_t (&a)[CI / 16][4], uint32_t box, int p,
                                         int khalf, bool valid) {
  if (!valid) {
#pragma unroll
    for (int kc = 0; kc < CI / 16; ++kc) a[kc][0] = a[kc][1] = a[kc][2] = a[kc][3] = 0u;
    return;
  }
  const uint32_t row = box + (uint32_t)p * (2 * CI);
  const uint32_t sw = CI == 64 ? (uint32_t)p & 7u : ((uint32_t)p >> 1) & 3u;
#pragma unroll
  for (int kc = 0; kc < CI / 16; ++kc)
    ldmatrix_x4(a[kc], row + 16u * (((uint32_t)(2 * kc + khalf)) ^ sw));
}

template <int CI, int CO>
__global__ void __launch_bounds__(kThreads, Cfg<CI, CO>::kMinBlocks) fused_conv_packed_kernel(
    const __grid_constant__ CUtensorMap x_map,  // (B, H, w_valid, CI) bf16
    const uint8_t* __restrict__ taps,           // wgmma_tap_image: 9 x CO x CI bf16, swizzled
    const float* __restrict__ bias,             // (CO)
    __nv_bfloat16* __restrict__ out,            // (B, H/2, out_w, CO)
    int h2n, int w2n, int out_w, int rows, int slots, int row_tiles, int col_tiles,
    int n_tiles, int stage_bytes) {
  using C = Cfg<CI, CO>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t s_taps = smem_u32(smem);
  const uint32_t s_ring = s_taps + C::kTapBytes;
  uint8_t* staging = smem + C::kTapBytes + kStages * stage_bytes;
  const uint32_t bars = smem_u32(staging + C::kStagingBytes);
  const uint32_t full0 = bars, empty0 = bars + 8 * kStages, taps0 = bars + 16 * kStages;

  const int tile_slots = rows * slots, box_w = 8 * slots + 2;
  const int n_local =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, tile_slots);
    }
    for (int tap = 0; tap < 9; ++tap) mbar_init(taps0 + 8 * tap, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // producer: the taps once, then this CTA's tiles through the ring
    if (lane == 0) {
      for (int tap = 0; tap < 9; ++tap) {
        mbar_expect_tx(taps0 + 8 * tap, C::kTapBlock);
        bulk_load(s_taps + tap * C::kTapBlock, taps + tap * C::kTapBlock, C::kTapBlock,
                  taps0 + 8 * tap);
      }
      const uint32_t box_bytes = (uint32_t)(2 * rows + 2) * box_w * C::kPixBytes;
      for (int k = 0; k < n_local; ++k) {
        const int s = k % kStages;
        mbar_wait(empty0 + 8 * s, ((k / kStages) & 1) ^ 1);
        const int tile = blockIdx.x + k * gridDim.x;
        const int b = tile / (row_tiles * col_tiles), rc = tile % (row_tiles * col_tiles);
        const int h2_0 = (rc / col_tiles) * rows, w2_0 = (rc % col_tiles) * 4 * slots;
        mbar_expect_tx(full0 + 8 * s, box_bytes);
        tma_load_4d(s_ring + s * stage_bytes, &x_map, full0 + 8 * s, 0, 2 * w2_0 - 1,
                    2 * h2_0 - 1, b);
      }
    }
    return;
  }

  // consumers
  const int cons = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row: matrix lane / 8 (bit 0: bottom pixel row, bit
  // 1: channels 8..15 of the k-step), row g' = lane % 8 of the warp's 16,
  // the pixel 2 (g' & 3) + (g' >> 2) of the slot's 8 pre-pool columns
  const int mi = lane >> 3, r = lane & 7;
  const int bottom = mi & 1, khalf = mi >> 1, col_in_slot = 2 * (r & 3) + (r >> 2);
  const bool right = g >= 4;  // after the shuffle: odd n8 tiles, else even
  uint8_t* stage_out = staging + (size_t)warp * 4 * C::kWinPitch;
  float bias_r[CO / 16][2];
#pragma unroll
  for (int jj = 0; jj < CO / 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias_r[jj][e] = bias[8 * (2 * jj + right) + 2 * t + e];

  const int n_sub = (n_local * tile_slots + 3) / 4;
  // This warp's slots are sigma = 4 q + wq for q = cons, cons + 2, ...:
  // 4 kConsumers = 8 apart. Its place (tile k, pooled row lr and slot sc in the tile) steps
  // along without a division; a tile holds at least 8 slots, so a step
  // crosses at most one tile edge. (h2_0, w2_0, b): tile k's origin.
  int k = 0, lr = 0, sc = 4 * cons + wq, b = 0, h2_0 = 0, w2_0 = 0;
  auto origin = [&]() {
    const int tile = blockIdx.x + k * gridDim.x;
    b = tile / (row_tiles * col_tiles);
    const int rc = tile - b * row_tiles * col_tiles;
    h2_0 = (rc / col_tiles) * rows;
    w2_0 = (rc % col_tiles) * 4 * slots;
  };
  while (sc >= slots) sc -= slots, ++lr;
  origin();
  float acc[C::kAcc];  // each m64 tile's first wgmma overwrites it (scale-d 0)
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.0f;
  for (int q = cons; q < n_sub; q += kConsumers) {
    if (q != cons) {
      sc += 4 * kConsumers;
      while (sc >= slots) sc -= slots, ++lr;
      if (lr >= rows) {
        lr -= rows;
        ++k;
        if (k < n_local) origin();
      }
    }
    const bool valid = k < n_local;
    const int stage = k % kStages;
    const uint32_t box = s_ring + stage * stage_bytes;
    const int p0 = (2 * lr + bottom) * box_w + 8 * sc + col_in_slot;
    if (valid) mbar_wait(full0 + 8 * stage, (k / kStages) & 1);

    uint32_t a[2][C::kKSteps][4];
    load_tap<CI>(a[0], box, p0, khalf, valid);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if (q == cons) mbar_wait(taps0 + 8 * tap, 0);  // the CTA's first m64 tile
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < C::kKSteps; ++kc)
        wgmma_tile<CO>(acc, a[tap & 1][kc], b_desc<CI>(s_taps + tap * C::kTapBlock + 32 * kc),
                       tap + kc > 0);
      wgmma_commit();
      if (tap + 1 < 9) {
        // tap - 1's group is done: its registers are free. Block 2 waits for
        // this tap's group too: its m64n64 groups are short, and on the H100
        // the deeper wait ran slower there (and faster at block 3)
        if constexpr (CO == 64)
          wgmma_wait<0>();
        else if (tap > 0)
          wgmma_wait<1>();
        const int nt = tap + 1;
        load_tap<CI>(a[nt & 1], box, p0 + (nt / 3) * box_w + nt % 3, khalf, valid);
      }
    }
    // every ldmatrix of this slot has returned: its stage may be refilled
    if (valid) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    const int h2 = h2_0 + lr;
    if (!valid || h2 >= h2n) continue;
    const int w2s = w2_0 + 4 * sc;  // the slot's first pooled column
    // pool: element 4j + e is row g (top), 4j + 2 + e row g + 8 (bottom), of
    // column 8j + 2t + e; the window's other column is in lane ^ 16
#pragma unroll
    for (int jj = 0; jj < CO / 16; ++jj) {
      float res[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float even = fmaxf(acc[8 * jj + e], acc[8 * jj + 2 + e]);
        const float odd = fmaxf(acc[8 * jj + 4 + e], acc[8 * jj + 6 + e]);
        const float got = __shfl_xor_sync(0xffffffffu, right ? even : odd, 16);
        res[e] = fmaxf(fmaxf(right ? odd : even, got) + bias_r[jj][e], 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(stage_out + (g & 3) * C::kWinPitch +
                                          2 * (8 * (2 * jj + right) + 2 * t)) =
          __floats2bfloat162_rn(res[0], res[1]);
    }
    __syncwarp();
    // the slot's 4 windows x CO channels: one contiguous run of the output
    constexpr int kChunks = 4 * CO / 8, kPerWin = CO / 8;
    __nv_bfloat16* o = out + (((size_t)b * h2n + h2) * out_w + w2s) * CO;
#pragma unroll
    for (int c = lane; c < kChunks; c += 32) {
      const int win = c / kPerWin, part = c % kPerWin;
      if (w2s + win < out_w) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (w2s + win < w2n)
          v = *reinterpret_cast<const uint4*>(stage_out + win * C::kWinPitch + 16 * part);
        *reinterpret_cast<uint4*>(o + (size_t)win * CO + 8 * part) = v;
      }
    }
    __syncwarp();
  }
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

inline size_t stage_bytes_of(int ci, int rows, int slots) {
  const size_t box = (size_t)(2 * rows + 2) * (8 * slots + 2) * 2 * ci;
  return (box + 1023) / 1024 * 1024;
}

template <int CI, int CO>
size_t smem_bytes(int rows, int slots) {
  using C = Cfg<CI, CO>;
  return 1024 + C::kTapBytes + kStages * stage_bytes_of(CI, rows, slots) + C::kStagingBytes +
         8 * (2 * kStages + 9);
}

template <int CI, int CO>
int launch(int device, const void* x, int batch, int h, int w_pitch, int w_valid,
           const void* taps, const void* bias, void* out, int out_w, int rows, int slots,
           int col_tiles, cudaStream_t stream) {
  auto kernel = fused_conv_packed_kernel<CI, CO>;
  const int h2n = h / 2, w2n = w_valid / 2;
  const int row_tiles = (h2n + rows - 1) / rows;
  const long long n_tiles = (long long)batch * row_tiles * col_tiles;
  const size_t pitch = (size_t)w_pitch * CI * 2;
  if (rows < 1 || slots < 1 || rows * slots < kMinTileSlots || 2 * rows + 2 > 256 ||
      8 * slots + 2 > 256 || (long long)col_tiles * 4 * slots < out_w ||
      (long long)(col_tiles - 1) * 4 * slots >= out_w || pitch % 16 || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CI, CO>(rows, slots);
  int per_sm = 0, sms = 0;
  cudaError_t err =
      grid_limits<&fused_conv_packed_kernel<CI, CO>>(device, kThreads, smem, per_sm, sms);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)CI, (cuuint64_t)w_valid, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)CI * 2, pitch, pitch * h};
  const cuuint32_t box[4] = {(cuuint32_t)CI, (cuuint32_t)(8 * slots + 2),
                             (cuuint32_t)(2 * rows + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CI == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : (long long)per_sm * sms);
  kernel<<<grid, kThreads, smem, stream>>>(
      map, (const uint8_t*)taps, (const float*)bias, (__nv_bfloat16*)out, h2n, w2n, out_w, rows,
      slots, row_tiles, col_tiles, (int)n_tiles, (int)stage_bytes_of(CI, rows, slots));
  return (int)cudaGetLastError();
}

template <int CI, int CO>
int occupancy(int device, int rows, int slots, int* out) {
  auto kernel = fused_conv_packed_kernel<CI, CO>;
  const size_t smem = smem_bytes<CI, CO>(rows, slots);
  int sms = 0;
  cudaError_t err =
      grid_limits<&fused_conv_packed_kernel<CI, CO>>(device, kThreads, smem, out[0], sms);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = (int)smem;
  return 0;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// (B, H, w_pitch, ci) bf16, first w_valid columns -> (B, H/2, out_w, co)
// bf16; (ci, co) = (32, 64) or (64, 128). `taps` is wgmma_tap_image's
// layout; `rows`, `slots`, `col_tiles` are packed_schedule's (a tile is
// rows pooled rows x 4 slots pooled columns; the column tiles cover out_w).
// The row pitch w_pitch * ci * 2 must be a multiple of 16 bytes (TMA).
int fused_conv_packed_launch(int device, int ci, int co, const void* x, int batch, int h,
                             int w_pitch, int w_valid, const void* taps, const void* bias,
                             void* out, int out_w, int rows, int slots, int col_tiles,
                             void* stream) {
  if (batch < 1 || h < 2 || w_valid < 2 || w_valid > w_pitch || out_w < w_valid / 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = (cudaStream_t)stream;
  if (ci == 32 && co == 64)
    return launch<32, 64>(device, x, batch, h, w_pitch, w_valid, taps, bias, out, out_w, rows,
                          slots, col_tiles, s);
  if (ci == 64 && co == 128)
    return launch<64, 128>(device, x, batch, h, w_pitch, w_valid, taps, bias, out, out_w, rows,
                           slots, col_tiles, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs an SM, registers a thread and shared bytes a CTA of the (ci, co)
// instance at a tile of rows x slots, into out[0..2].
int fused_conv_packed_occupancy(int device, int ci, int co, int rows, int slots, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ci == 32 && co == 64) return occupancy<32, 64>(device, rows, slots, out);
  if (ci == 64 && co == 128) return occupancy<64, 128>(device, rows, slots, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
