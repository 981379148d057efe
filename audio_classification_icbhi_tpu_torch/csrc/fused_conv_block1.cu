// Fused eval ConvBlock 1 of LightweightCNN for Hopper (sm_90a): port of the
// TPU kernels `_kernel_block1` / `fused_conv_block1` and
// `_kernel_block1_batched` / `fused_conv_block1_batched`
// (audio_classification_icbhi_tpu/ops/pallas_conv.py:92, :292, :334, :381).
//
// Function: (B, H, W) f32 log-mel -> conv3x3 1->32 (pad 1) with the eval
// BatchNorm folded into the taps -> + bias -> ReLU -> maxpool 2x2 (floor)
// -> (B, H/2, out_w, 32) bf16 NHWC, columns W/2 .. out_w - 1 zero (the
// wrappers' `pad_out_w`). Rounding as on the TPU: the input is rounded to
// bf16, the taps and the bias arrive as bf16 values (in f32), the nine
// products are exact and summed in f32, then the 2x2 max, bias and ReLU in
// f32, one rounding to bf16 at the store.
//
// What bounds it on this card: at serving (128 x 128 x 157) it reads 10.3 MB
// of f32 input and writes 40.9 MB of bf16 output, 0.0153 ms at 3.35 TB/s:
// bytes. Its 1.48 GFLOP would floor it at 0.022 ms on the CUDA cores in f32
// (67 TFLOP/s), so the products run on the tensor cores, as the TPU kernel
// put them on its matrix unit (pallas_conv.py:114-116).
//
// The design:
// - The conv is (pre-pool pixels) x (9 taps, zero-padded to K = 16) x (32
//   channels) on `mma.sync.m16n8k16` bf16 -> f32: one k-step, four n8 tiles.
//   The taps' B fragments stay in registers for the whole kernel.
// - An MMA's 16 rows are 4 pool windows: row g (0..7) is the top pixel of
//   window g & 3, left for g < 4, right for g >= 4; row g + 8 the pixel under
//   it. Each thread's accumulator holds the top and bottom pixel of a window
//   column, the other column is in lane ^ 16: the 2x2 max is one max in
//   registers and one shuffle, and the pre-pool activation never leaves them.
//   A fragments are assembled from the staged tile: thread t holds taps 2t,
//   2t + 1 (and t = 0 tap 8), two f32 loads and one bf16x2 rounding each.
// - A warp's unit of work is 8 consecutive pooled columns of one pooled row
//   (two MMA row groups). Its 8 windows x 32 channels are staged through 768
//   bytes of shared memory and stored at 16 bytes a lane: 512 contiguous
//   bytes, whole 128-byte lines.
// - A tile is 8 pooled rows x 8 `units` pooled columns of one example (ops/
//   conv_kernels.py `block1_schedule`: units cover out_w in one column tile
//   up to 128 columns, so the serving width 78 takes 80). The grid is the
//   CTAs that fit at once; each walks its tiles and loads the next tile's 18
//   x (16 units + 2) input floats with `cp.async` (4 bytes, coalesced along
//   the row, zero-filled outside the image) while it computes this one.
//   TMA cannot take this tensor: its row pitch, W x 4 = 628 bytes at
//   serving, is not a multiple of 16.
// - The TPU's lane rolls, selection matmuls and the batched kernel's
//   examples stacked in lanes fed its matrix unit; the grid covers the batch,
//   so both TPU entry points launch this one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_grid.cuh"

namespace {

constexpr int kC = 32;             // output channels
constexpr int kRows = 8;           // pooled rows a tile
constexpr int kTileH = 2 * kRows + 2;
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWinPitch = 96;      // staged window: 64 bytes + 32 (conflict-free writes)
constexpr int kStagingBytes = kWarps * 8 * kWinPitch;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared, zero-filled when `inside` is false.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(inside ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kThreads) fused_conv_block1_kernel(
    const float* __restrict__ x,      // (B, H, W)
    int h, int w, int units, int col_tiles, int n_tiles,
    const float* __restrict__ taps,   // (9, 32): [dh * 3 + dw][channel]
    const float* __restrict__ bias,   // (32)
    __nv_bfloat16* __restrict__ out,  // (B, H/2, out_w, 32)
    int out_w) {
  extern __shared__ float4 smem_f4[];
  const int tile_w = 16 * units + 2;  // input columns a tile, halo included
  float* ring = reinterpret_cast<float*>(smem_f4);
  uint8_t* staging = reinterpret_cast<uint8_t*>(ring + 2 * kTileH * tile_w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool right = g >= 4;  // after the shuffle: odd n8 tiles, else even
  const int h2n = h / 2, w2n = w / 2, row_tiles = h2n / kRows;
  const int n_local =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;

  // B fragments: b0 = taps 2t, 2t + 1 of channel 8j + g; b1 = tap 8 (t = 0)
  uint32_t b0[4], b1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 8 * j + g;
    b0[j] = pack_bf16(taps[2 * t * kC + n], taps[(2 * t + 1) * kC + n]);
    b1[j] = t == 0 ? pack_bf16(taps[8 * kC + n], 0.0f) : 0u;
  }
  float bias_r[2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias_r[jj][e] = bias[8 * (2 * jj + right) + 2 * t + e];
  // the tile offsets of this thread's taps k = 2t, 2t + 1 and 8
  const int off0 = (2 * t / 3) * tile_w + 2 * t % 3;
  const int off1 = ((2 * t + 1) / 3) * tile_w + (2 * t + 1) % 3;
  const int off8 = 2 * tile_w + 2;

  auto tile_origin = [&](int k, int& b, int& h2_0, int& w2_0) {
    const int tile = blockIdx.x + k * gridDim.x;
    b = tile / (row_tiles * col_tiles);
    const int rc = tile % (row_tiles * col_tiles);
    h2_0 = (rc / col_tiles) * kRows;
    w2_0 = (rc % col_tiles) * 8 * units;
  };
  // the input rows 2 h2_0 - 1 .. + 17 and columns 2 w2_0 - 1 .. + tile_w - 1
  // of tile k into buffer `buf`, a warp a row, zero outside the image
  auto issue = [&](int k, int buf) {
    int b, h2_0, w2_0;
    tile_origin(k, b, h2_0, w2_0);
    float* dst = ring + buf * kTileH * tile_w;
    const int r0 = 2 * h2_0 - 1, c0 = 2 * w2_0 - 1;
    for (int r = warp; r < kTileH; r += kWarps) {
      const int gr = r0 + r;
      const bool row_in = gr >= 0 && gr < h;
      const float* src = x + ((size_t)b * h + (row_in ? gr : 0)) * w;
      for (int c = lane; c < tile_w; c += 32) {
        const int gc = c0 + c;
        const bool inside = row_in && gc >= 0 && gc < w;
        cp_async_4(dst + r * tile_w + c, inside ? src + gc : x, inside);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (n_local > 0) issue(0, 0);
  uint8_t* stage_out = staging + warp * 8 * kWinPitch;
  for (int k = 0; k < n_local; ++k) {
    if (k + 1 < n_local) {
      issue(k + 1, (k + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    int b, h2_0, w2_0;
    tile_origin(k, b, h2_0, w2_0);
    const float* tile = ring + (k & 1) * kTileH * tile_w;
    for (int item = warp; item < kRows * units; item += kWarps) {
      const int lr = item / units, u = item % units;
#pragma unroll
      for (int gg = 0; gg < 2; ++gg) {
        // row g's pixel: tile row 2 lr (top; + tile_w the bottom), column
        // 2 (8u + 4gg + (g & 3)) + (g >> 2), at the tap's offset
        const float* p = tile + 2 * lr * tile_w + 2 * (8 * u + 4 * gg + (g & 3)) + (g >> 2);
        uint32_t a[4];
        a[0] = pack_bf16(p[off0], p[off1]);
        a[1] = pack_bf16(p[tile_w + off0], p[tile_w + off1]);
        a[2] = t == 0 ? pack_bf16(p[off8], 0.0f) : 0u;
        a[3] = t == 0 ? pack_bf16(p[tile_w + off8], 0.0f) : 0u;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
          mma_16816(acc[j], a, b0[j], b1[j]);
        }
        // pool: acc[j][e] top, acc[j][2 + e] bottom, channel 8j + 2t + e
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float res[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float even = fmaxf(acc[2 * jj][e], acc[2 * jj][2 + e]);
            const float odd = fmaxf(acc[2 * jj + 1][e], acc[2 * jj + 1][2 + e]);
            const float got = __shfl_xor_sync(0xffffffffu, right ? even : odd, 16);
            res[e] = fmaxf(fmaxf(right ? odd : even, got) + bias_r[jj][e], 0.0f);
          }
          *reinterpret_cast<uint32_t*>(stage_out + (4 * gg + (g & 3)) * kWinPitch +
                                       2 * (8 * (2 * jj + right) + 2 * t)) =
              pack_bf16(res[0], res[1]);
        }
      }
      __syncwarp();
      // 8 windows x 32 channels, 16 bytes a lane
      const int win = lane >> 2, part = lane & 3;
      const int h2 = h2_0 + lr, w2 = w2_0 + 8 * u + win;
      if (w2 < out_w) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (w2 < w2n) v = *reinterpret_cast<const uint4*>(stage_out + win * kWinPitch + 16 * part);
        *reinterpret_cast<uint4*>(out + (((size_t)b * h2n + h2) * out_w + w2) * kC + 8 * part) = v;
      }
      __syncwarp();
    }
    __syncthreads();  // the buffer is read: the next issue may overwrite it
  }
}

inline size_t smem_bytes(int units) {
  return (size_t)2 * kTileH * (16 * units + 2) * sizeof(float) + kStagingBytes;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// (B, H, W) f32 -> (B, H/2, out_w, 32) bf16; H % 16 == 0, out_w >= W/2.
// `units`, `col_tiles` are block1_schedule's (a tile is 8 pooled rows x
// 8 units pooled columns; the column tiles cover out_w).
int fused_conv_block1_launch(int device, const void* x, int batch, int h, int w,
                             const void* taps, const void* bias, void* out, int out_w,
                             int units, int col_tiles, void* stream) {
  if (batch < 1 || h < 2 * kRows || h % (2 * kRows) || w < 2 || out_w < w / 2 || units < 1 ||
      (long long)col_tiles * 8 * units < out_w || (long long)(col_tiles - 1) * 8 * units >= out_w)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (long long)batch * (h / 2 / kRows) * col_tiles;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = grid_limits<fused_conv_block1_kernel>(device, kThreads, smem_bytes(units), per_sm, sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(n_tiles < (long long)per_sm * sms ? n_tiles : (long long)per_sm * sms);
  fused_conv_block1_kernel<<<grid, kThreads, smem_bytes(units), (cudaStream_t)stream>>>(
      (const float*)x, h, w, units, col_tiles, (int)n_tiles, (const float*)taps,
      (const float*)bias, (__nv_bfloat16*)out, out_w);
  return (int)cudaGetLastError();
}

// CTAs an SM, registers a thread and shared bytes a CTA at `units`.
int fused_conv_block1_occupancy(int device, int units, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = grid_limits<fused_conv_block1_kernel>(device, kThreads, smem_bytes(units), out[0], sms);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_conv_block1_kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = (int)smem_bytes(units);
  return 0;
}

}  // extern "C"
