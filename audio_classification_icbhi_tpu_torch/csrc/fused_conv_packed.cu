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
// is 23.6 GFLOP, 0.0238 ms on the bf16 tensor cores at 989 TFLOP/s, against
// 0.0183 / 0.0091 ms for their bytes at 3.35 TB/s. On the CUDA cores in f32
// that work would take >= 0.35 ms a block, so the products run on the tensor
// cores.
//
// What the design does about that:
// - An implicit GEMM on `mma.sync.m16n8k16` (bf16 in, f32 accumulate): M is
//   the pre-pool pixels, N the output channels, K = 9 * ci ordered
//   (dh, dw, c_in), so each 32-bit fragment register is two neighbouring
//   channels of one input pixel in shared memory.
// - Each warp owns 8 pooled pixels of one pooled row, as two m16 tiles: tile
//   mt holds pre-pool row 2 * h2 + mt; its row g is the left pixel of pool
//   window g and row g + 8 the right one. The m16n8 accumulator puts rows g
//   and g + 8 in one thread, so the four values of each pool window sit in
//   one thread's registers: bias, ReLU and the 2x2 max need no shuffle, and
//   the pre-pool activation never leaves the registers.
// - A block is 8 warps: 8 pooled rows x 8 pooled columns x 64 output
//   channels. It stages the 18 x 18-pixel input tile with its halo (zero
//   outside the image and past w_valid) and its 64 channels' taps
//   (64 x 9 * ci bf16: 37 KB at block 2, 74 KB at block 3) in shared memory
//   once, then runs the 9 * ci / 16 k-steps from there. Block 3's 128 output
//   channels are two blocks' worth, so its taps fit beside the tile.
// - Shared-memory rows are padded so that a fragment load hits 32 distinct
//   banks: a pixel holds ci + 4 bf16, a tap row 9 * ci + 8.
// - The TPU's lane packing (4 * ci-lane windows, two parity families, the
//   selection matmul) was an MXU-tile device and is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one pooled row each
constexpr int kRows = 8;       // pooled rows a block
constexpr int kQuads = 8;      // pooled columns a block (the 8 pool windows of a warp)
constexpr int kN = 64;         // output channels a block
constexpr int kTileH = 2 * kRows + 2, kTileW = 2 * kQuads + 2;

template <int CI>
struct Layout {
  static constexpr int kK = 9 * CI;
  static constexpr int kTapStride = kK + 8;  // bf16 a tap row in shared memory
  static constexpr int kPix = CI + 4;        // bf16 a pixel in shared memory
  static constexpr size_t kTapBytes = (size_t)kN * kTapStride * 2;
  static constexpr size_t kBytes = kTapBytes + (size_t)kTileH * kTileW * kPix * 2;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CI, int CO>
__global__ void __launch_bounds__(kThreads) fused_conv_packed_kernel(
    const __nv_bfloat16* __restrict__ x,     // (B, H, w_pitch, CI)
    int h, int w_pitch, int w_valid, int col_tiles,
    const __nv_bfloat16* __restrict__ taps,  // (CO, 9 * CI): [c_out][(dh * 3 + dw) * CI + c_in]
    const float* __restrict__ bias,          // (CO)
    __nv_bfloat16* __restrict__ out,         // (B, H/2, out_w, CO)
    int out_w) {
  using L = Layout<CI>;
  constexpr int kChunks = CO / kN;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* s_taps = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem_u4) + L::kTapBytes);

  int bx = blockIdx.x;
  const int chunk = bx % kChunks;
  bx /= kChunks;
  const int b = bx / col_tiles;
  const int h2_0 = blockIdx.y * kRows, w2_0 = (bx % col_tiles) * kQuads;

  // This block's 64 output channels of taps, 16 bytes at a time.
  constexpr int kRowU4 = L::kK / 8;
  const __nv_bfloat16* tg = taps + (size_t)chunk * kN * L::kK;
  for (int i = threadIdx.x; i < kN * kRowU4; i += kThreads) {
    const int n = i / kRowU4, q = i % kRowU4;
    reinterpret_cast<uint4*>(s_taps + n * L::kTapStride)[q] =
        reinterpret_cast<const uint4*>(tg + (size_t)n * L::kK)[q];
  }
  // The input tile with its one-pixel halo, 8 bytes at a time; zero outside
  // rows [0, h) and columns [0, w_valid).
  constexpr int kPixU2 = CI / 4;
  const int r0 = 2 * h2_0 - 1, c0 = 2 * w2_0 - 1;
  const __nv_bfloat16* xb = x + (size_t)b * h * w_pitch * CI;
  for (int i = threadIdx.x; i < kTileH * kTileW * kPixU2; i += kThreads) {
    const int q = i % kPixU2, p = i / kPixU2;
    const int gr = r0 + p / kTileW, gc = c0 + p % kTileW;
    uint2 v = make_uint2(0u, 0u);
    if (gr >= 0 && gr < h && gc >= 0 && gc < w_valid)
      v = reinterpret_cast<const uint2*>(xb + ((size_t)gr * w_pitch + gc) * CI)[q];
    reinterpret_cast<uint2*>(s_x + p * L::kPix)[q] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h2n = h / 2, w2n = w_valid / 2;
  const int h2 = h2_0 + warp, w2 = w2_0 + g;
  if (h2 >= h2n) return;  // no barrier follows

  // acc[mt][j]: pre-pool row 2 * h2 + mt; {0, 1}: the left pixel 2 * w2,
  // {2, 3}: the right pixel 2 * w2 + 1; channels chunk * 64 + 8j + 2t + {0, 1}.
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    // shared-memory pixel of row g (left) and row g + 8 (right) of tile mt
    const __nv_bfloat16* a_left[2];
    const __nv_bfloat16* a_right[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = 2 * warp + mt + dh;
      a_left[mt] = s_x + (row * kTileW + 2 * g + dw) * L::kPix + 2 * t;
      a_right[mt] = a_left[mt] + L::kPix;
    }
    const __nv_bfloat16* b_row = s_taps + g * L::kTapStride + tap * CI + 2 * t;
#pragma unroll
    for (int kc = 0; kc < CI; kc += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = ld32(a_left[mt] + kc);
        a[mt][1] = ld32(a_right[mt] + kc);
        a[mt][2] = ld32(a_left[mt] + kc + 8);
        a[mt][3] = ld32(a_right[mt] + kc + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = b_row + j * 8 * L::kTapStride + kc;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
        mma_16816(acc[0][j], a[0], b0, b1);
        mma_16816(acc[1][j], a[1], b0, b1);
      }
    }
  }

  if (w2 >= out_w) return;
  const bool valid = w2 < w2n;
  __nv_bfloat16* o = out + (((size_t)b * h2n + h2) * out_w + w2) * CO + chunk * kN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t;
    float m[2] = {0.0f, 0.0f};  // ReLU's floor
    if (valid) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = bias[chunk * kN + n + e];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          m[e] = fmaxf(m[e], fmaxf(acc[mt][j][e] + bv, 0.0f));
          m[e] = fmaxf(m[e], fmaxf(acc[mt][j][e + 2] + bv, 0.0f));
        }
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(m[0], m[1]);
  }
}

template <int CI, int CO>
int launch(const void* x, int batch, int h, int w_pitch, int w_valid, const void* taps,
           const void* bias, void* out, int out_w, cudaStream_t stream) {
  using L = Layout<CI>;
  auto kernel = fused_conv_packed_kernel<CI, CO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (out_w + kQuads - 1) / kQuads;
  const int row_tiles = (h / 2 + kRows - 1) / kRows;
  const long long blocks = (long long)batch * col_tiles * (CO / kN);
  if (blocks > 0x7fffffffLL || row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)row_tiles);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      (const __nv_bfloat16*)x, h, w_pitch, w_valid, col_tiles, (const __nv_bfloat16*)taps,
      (const float*)bias, (__nv_bfloat16*)out, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// (B, H, w_pitch, ci) bf16, first w_valid columns -> (B, H/2, out_w, co)
// bf16; (ci, co) = (32, 64) or (64, 128); out_w >= w_valid / 2.
int fused_conv_packed_launch(int device, int ci, int co, const void* x, int batch, int h,
                             int w_pitch, int w_valid, const void* taps, const void* bias,
                             void* out, int out_w, void* stream) {
  if (batch < 1 || h < 2 || w_valid < 2 || w_valid > w_pitch || out_w < w_valid / 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = (cudaStream_t)stream;
  if (ci == 32 && co == 64)
    return launch<32, 64>(x, batch, h, w_pitch, w_valid, taps, bias, out, out_w, s);
  if (ci == 64 && co == 128)
    return launch<64, 128>(x, batch, h, w_pitch, w_valid, taps, bias, out, out_w, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
