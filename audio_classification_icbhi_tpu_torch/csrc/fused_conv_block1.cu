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
// products are exact in f32 and summed in f32, then ReLU and the 2x2 max in
// f32, one rounding to bf16 at the store.
//
// What bounds it on this card: at serving (128 x 128 x 157) it reads 10.3 MB
// of f32 input and writes 40.9 MB of bf16 output, 0.0153 ms at 3.35 TB/s;
// its 1.48 GFLOP of f32 work is 0.022 ms on the CUDA cores at 67 TFLOP/s. A
// conv, BN, ReLU and pool run apart would also write and read back the
// (B, H, W, 32) pre-pool activation, 164.6 MB in bf16.
//
// What the design does about that:
// - The pre-pool activation never leaves registers: each thread computes the
//   four pre-pool values of one 2x2 pool window for one channel, and stores
//   only their max.
// - A block covers 8 pooled rows x 32 pooled columns of one example: it
//   loads the 18 x 66 input tile with its one-pixel halo into shared memory
//   once (zero outside the image, rounded to bf16), so each input value is
//   read from device memory about once.
// - Lane = output channel: the 32 lanes of a warp read the same 4 x 4 input
//   patch (a shared-memory broadcast), keep their channel's 9 taps and bias
//   in registers, and store the 32 channels of one pooled pixel as 64
//   contiguous bytes.
// - The TPU's banded matmul, lane rolls and selection matmuls (and the
//   batched kernel's examples stacked in lanes) fed its matrix unit; 36 FMAs
//   a pool window need no tensor core here. The grid covers the batch, so
//   both TPU entry points launch this one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;        // output channels
constexpr int kRows = 8;      // pooled rows a block
constexpr int kCols = 32;     // pooled columns a block
constexpr int kThreads = 256; // 8 warps
constexpr int kTileH = 2 * kRows + 2, kTileW = 2 * kCols + 2;

__global__ void __launch_bounds__(kThreads) fused_conv_block1_kernel(
    const float* __restrict__ x,      // (B, H, W)
    int h, int w, int col_tiles,
    const float* __restrict__ taps,   // (9, 32): [dh * 3 + dw][channel]
    const float* __restrict__ bias,   // (32)
    __nv_bfloat16* __restrict__ out,  // (B, H/2, out_w, 32)
    int out_w) {
  __shared__ float tile[kTileH][kTileW];
  const int b = blockIdx.x / col_tiles;
  const int h2_0 = blockIdx.y * kRows, w2_0 = (blockIdx.x % col_tiles) * kCols;
  const int r0 = 2 * h2_0 - 1, c0 = 2 * w2_0 - 1;  // the tile's halo origin
  const float* xb = x + (size_t)b * h * w;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int gr = r0 + r, gc = c0 + c;
    float v = 0.0f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w)
      v = __bfloat162float(__float2bfloat16_rn(xb[(size_t)gr * w + gc]));
    tile[r][c] = v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = taps[i * kC + lane];
  const float bc = bias[lane];
  __syncthreads();

  const int h2n = h / 2, w2n = w / 2;
  __nv_bfloat16* ob = out + (size_t)b * h2n * out_w * kC;
  for (int q = warp; q < kRows * kCols; q += kThreads / 32) {
    const int i = q / kCols, j = q % kCols;
    const int h2 = h2_0 + i, w2 = w2_0 + j;
    if (h2 >= h2n || w2 >= out_w) continue;
    float best = 0.0f;  // ReLU's floor: the max of four ReLUs is >= 0
    if (w2 < w2n) {
      float p[4][4];  // pre-pool rows 2i-1 .. 2i+2, columns 2j-1 .. 2j+2
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[a][c] = tile[2 * i + a][2 * j + c];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          float acc = 0.0f;
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw) acc = fmaf(k[dh * 3 + dw], p[dy + dh][dx + dw], acc);
          best = fmaxf(best, fmaxf(acc + bc, 0.0f));
        }
    }
    ob[((size_t)h2 * out_w + w2) * kC + lane] = __float2bfloat16_rn(best);
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// (B, H, W) f32 -> (B, H/2, out_w, 32) bf16; out_w >= W/2.
int fused_conv_block1_launch(int device, const void* x, int batch, int h, int w,
                             const void* taps, const void* bias, void* out, int out_w,
                             void* stream) {
  if (batch < 1 || h < 2 || w < 2 || out_w < w / 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (out_w + kCols - 1) / kCols;
  const int row_tiles = (h / 2 + kRows - 1) / kRows;
  if ((long long)batch * col_tiles > 0x7fffffffLL || row_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(batch * col_tiles), (unsigned)row_tiles);
  fused_conv_block1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, h, w, col_tiles, (const float*)taps, (const float*)bias,
      (__nv_bfloat16*)out, out_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
