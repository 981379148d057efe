// The per-example epilogue shared by the log-mel front-end kernels: port of
// `_fused_epilogue` (audio_classification_icbhi_tpu/ops/pallas_mel.py:683),
// which every fused TPU log-mel kernel ends in. All three log-mel sources
// include this header and launch it after their spectrum kernel: two
// launches a call.
//
// Input: a (B, n_frames, n_mels) f32 dB scratch that a spectrum kernel wrote.
// Per example: top_db against its own peak (taken before the mask), then
// (training form) the SpecAugment mask, then normalize with the mean and the
// ddof=1 std over all T x n_mels cells, masked zeros included ->
// (B, n_mels, n_frames) f32.
//
// The training form (`with_masks` of the TPU kernels) takes per-example
// bounds (B, 4) f32 (f_start, f_width, t_start, t_width): a cell (t, m) is
// zeroed when f_start <= m < f_start + f_width or t_start <= t < t_start +
// t_width, compared in f32 as the TPU epilogue does (pallas_mel.py:706-713).
//
// What bounds it: bytes. The dB scratch is read once and the output written
// once (6.1 us at 3.35 TB/s for 128 clips of 5 s at 2048/512). The previous
// design (one 1024-thread block an example, four passes over device memory,
// a transposed write that read with a stride of n_mels floats and an integer
// divide a cell) took 3.6-10x that (PERF.md section 6), and a batch of 64
// filled 64 of 132 SMs.
//
// The design: a thread-block cluster of C CTAs an example
// (cudaLaunchKernelEx with a cluster dimension), C a power of two up to 8
// (16 where a band would not fit otherwise), picked from B so that the grid
// puts a CTA on each SM, with 128, 256 or 512 threads a CTA by its cells
// (`epilogue_plan`, mirrored by `mel_kernels.epilogue_plan`):
// - CTA rank r takes the band of mels [r b, r b + b), b = ceil(n_mels / C),
//   of every frame (the last bands may be short or empty): it reads a
//   frame's band as one run (16-byte loads where the bands start on 16-byte
//   boundaries, several in flight a thread), once, into shared memory rows
//   of b | 1 floats, an odd pitch, so the transposed read (a lane a frame)
//   falls on 32 banks; and its output rows are whole rows of (B, n_mels, T),
//   one contiguous run, where a split by frames would write each mel row in
//   C short runs.
// - The peak, then each band's sum, its mean, and its squared deviations
//   about that mean are reduced within the CTA (a thread's cells in turn, a
//   shuffle tree in each warp, the warps in order; sums in f64). Across the
//   cluster, one thread a CTA stores its partial into every CTA's slots
//   through distributed shared memory and arrives on that CTA's mbarrier;
//   each CTA's thread 0 waits for C arrivals and combines the slots in rank
//   order 0 .. C-1: the peaks by max, the bands' (sum, squared deviations)
//   by Chan, Golub and LeVeque's update (mean += delta n_r / n, M2 += M2_r +
//   delta^2 n n_r / n), the squared deviations about the example's mean.
//   Two calls give equal bits. Only one thread a CTA takes part in an
//   exchange, where a full cluster barrier would hold every thread of every
//   CTA; one split barrier (arrive before the load pass, wait after it)
//   orders the mbarriers' initialisation before any signal, and a CTA
//   leaves only after its last wait, so no CTA's shared memory goes while
//   another still writes into it.
// - The write goes from shared memory to (B, n_mels, T) along T, coalesced.
//   Device memory sees one read and one write.
// - Resident mode holds the band of every frame in shared memory. Where it
//   does not fit (kEpilogueTileBytes, at C = 16: T > 5,461 frames at 128
//   mels, clips over 43 s at hop 128), the same kernel re-reads its band
//   from device memory for each pass. Every configuration of the repo takes
//   the resident mode.
//
// Measured (chip_smoke.py phase 19, a CUDA graph of 20 calls; H100 80GB
// HBM3, 700 W): 0.0134 ms at serving 2048/512 (128 x 5 s; bound 0.0061),
// 0.0164 at row 1 masked (64 x 8 s), 0.0311 at row 2 masked, 0.0593 at row 3
// (512/128, 128 x 5 s), 0.0595 at row 3 masked, 0.0068 at the analyzer's
// 64 x 0.5 s: 2.2-3.4x the bytes bound; the previous design 0.019, 0.042,
// 0.084, 0.117, 0.196 and 0.007. What holds it there: each CTA's load, its
// reductions and the exchange, and its write run in turn, and a grid that
// fits the card in one wave runs those phases in step, so the memory idles
// while the cluster reduces.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kEpilogueMaxThreads = 512;
constexpr int kEpilogueMaxWarps = kEpilogueMaxThreads / 32;
constexpr int kEpiloguePortableCluster = 8;
constexpr int kEpilogueMaxCluster = 16;
// the most shared memory a CTA's band may take (resident mode)
constexpr size_t kEpilogueTileBytes = 196608;

// The launch shape of one epilogue call: CTAs an example (the cluster), mels
// a CTA, the shared row pitch in floats, the mode, threads a CTA, dynamic
// shared bytes.
struct EpiloguePlan {
  int cluster, band, pitch, resident, threads;
  size_t smem;
};

// The plan by the rule `mel_kernels.epilogue_plan` mirrors: the smallest C
// that puts a CTA on each SM over the batch (C <= n_mels),
// doubled up to 8 while a band takes more than half the tile budget (two
// CTAs an SM), then up to 16 while it takes more than all of it; resident
// where it fits; threads a CTA by its cells.
inline EpiloguePlan epilogue_plan(int batch, int n_frames, int n_mels, int sms) {
  auto band = [&](int c) { return (n_mels + c - 1) / c; };
  auto bytes = [&](int c) { return (size_t)n_frames * (band(c) | 1) * sizeof(float); };
  int c = 1;
  while (c < kEpiloguePortableCluster && (long long)batch * c < sms && 2 * c <= n_mels)
    c *= 2;
  while (c < kEpiloguePortableCluster && bytes(c) > kEpilogueTileBytes / 2 && 2 * c <= n_mels)
    c *= 2;
  while (c < kEpilogueMaxCluster && bytes(c) > kEpilogueTileBytes && 2 * c <= n_mels) c *= 2;
  const int resident = bytes(c) <= kEpilogueTileBytes;
  // about 16 to 48 cells a thread
  const long long cells = (long long)n_frames * band(c);
  const int threads = cells < 2048 ? 128 : cells < 12288 ? 256 : kEpilogueMaxThreads;
  return EpiloguePlan{c, band(c), band(c) | 1, resident, threads, resident ? bytes(c) : 0};
}

// Per-example SpecAugment bounds; `on` is false for the inference form.
struct MaskBounds {
  bool on;
  float f_start, f_end, t_start, t_end;
  __device__ bool masks(int t, int m) const {
    const float fm = (float)m, ft = (float)t;
    return on && ((fm >= f_start && fm < f_end) || (ft >= t_start && ft < t_end));
  }
};

// The CTA's sum of v over its threads in a fixed order: a shuffle tree in
// each warp, then the warps in order by thread 0. Valid in thread 0.
template <int kThreads>
__device__ __forceinline__ double cta_sum(double v, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w];
  return s;
}

template <int kThreads>
__device__ __forceinline__ float cta_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = -INFINITY;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s = fmaxf(s, scratch[w]);
  return s;
}

// The cluster barrier in two halves (every thread of the cluster arrives,
// then waits), with the load pass between them; it orders the mbarriers'
// initialisation before any CTA signals another's.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An exchange of per-CTA partials through distributed shared memory, one
// thread a CTA: each CTA's `mbar` counts the C arrivals of the cluster's CTAs,
// each after its remote store into this CTA's slots.
__device__ __forceinline__ unsigned epi_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void epi_mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(epi_smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive on CTA `rank`'s copy of `bar`, releasing this thread's earlier
// stores (its remote stores into that CTA) at cluster scope
__device__ __forceinline__ void epi_mbar_arrive_remote(unsigned long long* bar, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(epi_smem_u32(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void epi_mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(epi_smem_u32(bar)), "r"(parity) : "memory");
}

// Exchange `count` doubles of this CTA's partial (valid in thread 0) with
// the cluster: lane r of warp 0 stores them into CTA r's slots[rank] and
// arrives on its mbarrier; thread 0 waits for all C arrivals on its own.
// Afterwards thread 0 reads slots[0 .. C) in rank order.
__device__ __forceinline__ void cluster_exchange(const cg::cluster_group& cluster,
                                                 const double* part, int count,
                                                 double (*slots)[2], unsigned long long* bar,
                                                 int n_ctas, int rank) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double v[2];
    for (int i = 0; i < count; ++i) v[i] = __shfl_sync(0xffffffffu, part[i], 0);
    if (lane < n_ctas) {
      double* dst = cluster.map_shared_rank(slots[rank], lane);
      for (int i = 0; i < count; ++i) dst[i] = v[i];
      epi_mbar_arrive_remote(bar, lane);
    }
    if (lane == 0) epi_mbar_wait(bar, 0);
  }
}

// Cell (r, c) of a rows x cols grid for r * cols + c = i, i = threadIdx.x,
// threadIdx.x + threads, ...: stepped without a divide.
struct GridWalk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ GridWalk(int cols_, int threads) : cols(cols_) {
    r = cols ? (int)threadIdx.x / cols : 0;
    c = (int)threadIdx.x - r * cols;
    dr = cols ? threads / cols : 0;
    dc = threads - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// kVec consecutive floats of device memory, by one 16-byte load where kVec = 4
template <int kVec>
struct Floats {
  float v[kVec];
};
template <int kVec>
__device__ __forceinline__ Floats<kVec> load_floats(const float* p) {
  Floats<kVec> f;
  if constexpr (kVec == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    f.v[0] = q.x;
    f.v[1] = q.y;
    f.v[2] = q.z;
    f.v[3] = q.w;
  } else {
    f.v[0] = __ldg(p);
  }
  return f;
}

// One cluster an example, CTA rank r taking mels [r band, r band + band) of
// every frame, with kThreads threads. kVec = 4 where the bands start on
// 16-byte boundaries.
template <int kVec, int kThreads>
__global__ void __launch_bounds__(kThreads) log_mel_epilogue_kernel(
    const float* __restrict__ db,      // (B, n_frames, n_mels)
    int n_frames, int n_mels, int band, int pitch, int resident, int has_top_db, float top_db,
    int normalize, float eps,
    const float* __restrict__ bounds,  // (B, 4) or null
    float* __restrict__ out) {         // (B, n_mels, n_frames)
  extern __shared__ float tile[];      // (n_frames, pitch): this CTA's band of every frame
  // the cluster's partials, by source rank: the peaks, then each band's sum
  // and squared deviations about its mean; the mbarrier of each exchange
  __shared__ double slots_peak[kEpilogueMaxCluster][2];
  __shared__ double slots_stats[kEpilogueMaxCluster][2];
  __shared__ unsigned long long bars[2];
  __shared__ double scratch[kEpilogueMaxWarps];
  __shared__ float fscratch[kEpilogueMaxWarps];
  __shared__ double bcast[2];          // for the whole block: a mean, a variance
  __shared__ float fbcast;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n_ctas;
  const bool exchange = n_ctas > 1 && (has_top_db || normalize);
  if (exchange) {
    if (threadIdx.x == 0) {
      epi_mbar_init(&bars[0], n_ctas);
      epi_mbar_init(&bars[1], n_ctas);
    }
    cluster_arrive_relaxed();  // waited on after the load pass
  }
  auto cols_of = [&](int r) { return min(min(r * band, n_mels) + band, n_mels) - min(r * band, n_mels); };
  const int m_lo = min(rank * band, n_mels);
  const int cols = cols_of(rank);  // this CTA's mels m_lo .. m_lo + cols
  const int cells = n_frames * cols;
  const float* x = db + (size_t)b * n_frames * n_mels + m_lo;  // frame t's band at x[t * n_mels]
  MaskBounds mask{bounds != nullptr, 0.0f, 0.0f, 0.0f, 0.0f};
  if (mask.on) {
    const float* bd = bounds + (size_t)b * 4;
    mask.f_start = bd[0];
    mask.f_end = bd[0] + bd[1];
    mask.t_start = bd[2];
    mask.t_end = bd[2] + bd[3];
  }
  float floor_db = -INFINITY;  // top_db's floor, once the peak is known
  // The value of frame t and band mel c after top_db and the mask.
  auto value = [&](float v, int t, int c) {
    return mask.masks(t, m_lo + c) ? 0.0f : fmaxf(v, floor_db);
  };

  // Pass 1: the band into shared memory (resident), a frame's run of kVec
  // mels a load, several loads in flight a thread; its peak; without top_db
  // also each cell's value and their sum.
  float peak = -INFINITY;
  double sum = 0.0;
  const bool known = !has_top_db;  // the values are known as the band arrives
  if (resident || has_top_db || normalize) {
    constexpr int kBatch = kVec == 4 ? 4 : 8;
    const int vcols = cols / kVec, vcells = n_frames * vcols;
    GridWalk w(vcols, kThreads);
    for (int i0 = threadIdx.x; i0 < vcells; i0 += kThreads * kBatch) {
      Floats<kVec> f[kBatch];
      int tt[kBatch], cc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        tt[k] = w.r;
        cc[k] = w.c * kVec;
        if (i0 + k * kThreads < vcells)
          f[k] = load_floats<kVec>(x + (size_t)w.r * n_mels + w.c * kVec);
        w.next();
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (i0 + k * kThreads >= vcells) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float v = f[k].v[e];
          peak = fmaxf(peak, v);
          if (known) {
            v = value(v, tt[k], cc[k] + e);
            sum += v;
          }
          if (resident) tile[tt[k] * pitch + cc[k] + e] = v;
        }
      }
    }
  }
  if (exchange) cluster_wait();  // every CTA's mbarriers are initialised
  if (has_top_db) {
    peak = cta_max<kThreads>(peak, fscratch);
    if (exchange) {
      const double part[2] = {(double)peak, 0.0};
      cluster_exchange(cluster, part, 1, slots_peak, &bars[0], n_ctas, rank);
      if (threadIdx.x == 0)
        for (int r = 0; r < n_ctas; ++r) peak = fmaxf(peak, (float)slots_peak[r][0]);
    }
    if (threadIdx.x == 0) fbcast = peak;
    __syncthreads();
    floor_db = fbcast - top_db;
    // Pass 2: each cell's value (resident: into the band), and their sum.
    if (resident || normalize) {
      GridWalk w(cols, kThreads);
      for (int i = threadIdx.x; i < cells; i += kThreads, w.next()) {
        const int at = w.r * pitch + w.c;
        const float v = value(resident ? tile[at] : __ldg(x + (size_t)w.r * n_mels + w.c), w.r, w.c);
        if (resident) tile[at] = v;
        sum += v;
      }
    }
  }
  __syncthreads();
  // cell (t, c)'s value
  auto cell = [&](int t, int c) {
    return resident ? tile[t * pitch + c] : value(__ldg(x + (size_t)t * n_mels + c), t, c);
  };

  float mean = 0.0f, denom = 1.0f;
  if (normalize) {
    // The band's mean, then pass 3: its squared deviations about it; then
    // the cluster's (sum, squared deviations) of each band combined in rank
    // order, in f64: mean += delta n_r / n, M2 += M2_r + delta^2 n n_r / n
    // (Chan, Golub and LeVeque), the sum of squared deviations about the
    // example's mean.
    sum = cta_sum<kThreads>(sum, scratch);
    if (threadIdx.x == 0) bcast[0] = cells ? sum / cells : 0.0;
    __syncthreads();
    const double band_mean = bcast[0];
    double m2 = 0.0;
    GridWalk w(cols, kThreads);
    for (int i = threadIdx.x; i < cells; i += kThreads, w.next()) {
      const double d = (double)cell(w.r, w.c) - band_mean;
      m2 += d * d;
    }
    m2 = cta_sum<kThreads>(m2, scratch);
    const double part[2] = {sum, m2};
    if (exchange) {
      cluster_exchange(cluster, part, 2, slots_stats, &bars[1], n_ctas, rank);
    } else if (threadIdx.x == 0) {
      slots_stats[0][0] = sum;
      slots_stats[0][1] = m2;
    }
    if (threadIdx.x == 0) {
      double n = 0.0, mu = 0.0, ss = 0.0;
      for (int r = 0; r < n_ctas; ++r) {
        const double nr = (double)n_frames * cols_of(r);
        if (nr == 0.0) continue;
        const double delta = slots_stats[r][0] / nr - mu, nn = n + nr;
        mu += delta * nr / nn;
        ss += slots_stats[r][1] + delta * delta * n * nr / nn;
        n = nn;
      }
      bcast[0] = mu;
      bcast[1] = ss / (n > 1.0 ? n - 1.0 : 1.0);
    }
    __syncthreads();
    mean = (float)bcast[0];
    denom = sqrtf((float)bcast[1]) + eps;
  }

  // Pass 4: rows m_lo .. m_lo + cols of (B, n_mels, T), one contiguous run
  // of the output, cell j = c * T + t: a warp writes consecutive frames;
  // the shared read (a lane a frame, odd pitch) falls on 32 banks.
  float* y = out + ((size_t)b * n_mels + m_lo) * n_frames;
  GridWalk w(n_frames, kThreads);  // r: the band's mel, c: the frame
  for (int j = threadIdx.x; j < cells; j += kThreads, w.next()) {
    const float v = cell(w.c, w.r);
    y[j] = normalize ? (v - mean) / denom : v;
  }
  // A CTA leaves only after every CTA of its cluster stored into its slots
  // and arrived: no one touches its shared memory once it has passed its
  // last wait.
}

using EpilogueKernel = void (*)(const float*, int, int, int, int, int, int, float, int, float,
                               const float*, float*);

// The instantiation of a launch: 16-byte loads or not, threads a CTA.
inline EpilogueKernel epilogue_kernel(bool vec, int threads) {
  if (threads == 128) return vec ? log_mel_epilogue_kernel<4, 128> : log_mel_epilogue_kernel<1, 128>;
  if (threads == 256) return vec ? log_mel_epilogue_kernel<4, 256> : log_mel_epilogue_kernel<1, 256>;
  return vec ? log_mel_epilogue_kernel<4, 512> : log_mel_epilogue_kernel<1, 512>;
}

// The kernel's attributes on `device`, set once for every instantiation: the
// most dynamic shared memory the plan asks, and clusters of 16.
inline cudaError_t epilogue_attributes(int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  for (int threads = 128; threads <= kEpilogueMaxThreads; threads *= 2)
    for (bool vec : {false, true}) {
      const EpilogueKernel kernel = epilogue_kernel(vec, threads);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kEpilogueTileBytes);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// The plan on `device`: `epilogue_plan`, where a cluster of 16 that the card
// cannot place falls to 8 in the re-read mode.
inline cudaError_t epilogue_device_plan(int device, int batch, int n_frames, int n_mels,
                                        EpiloguePlan* plan) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = epilogue_attributes(device);
  if (err != cudaSuccess) return err;
  EpiloguePlan p = epilogue_plan(batch, n_frames, n_mels, sms);
  if (p.cluster > kEpiloguePortableCluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, epilogue_kernel(false, p.threads), &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) {
      p.cluster = kEpiloguePortableCluster;
      p.band = (n_mels + p.cluster - 1) / p.cluster;
      p.pitch = p.band | 1;
      p.resident = 0;
      p.threads = kEpilogueMaxThreads;
      p.smem = 0;
    }
  }
  *plan = p;
  return cudaSuccess;
}

// Epilogue pass: dB scratch (B, n_frames, n_mels) -> (B, n_mels, n_frames).
// `bounds` is null for the inference form, (B, 4) f32 for the training form.
inline int launch_log_mel_epilogue(int device, const void* db, int batch, int n_frames,
                                   int n_mels, int has_top_db, float top_db, int normalize,
                                   float eps, const void* bounds, void* out, void* stream) {
  if (batch < 1 || n_frames < 1 || n_mels < 1 ||
      (long long)batch * kEpilogueMaxCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EpiloguePlan p;
  err = epilogue_device_plan(device, batch, n_frames, n_mels, &p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(batch * p.cluster));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // 16-byte loads where every band starts on a 16-byte boundary
  const bool vec = n_mels % 4 == 0 && p.band % 4 == 0 && ((size_t)db & 15) == 0;
  err = cudaLaunchKernelEx(&cfg, epilogue_kernel(vec, p.threads),
                           (const float*)db, n_frames, n_mels, p.band, p.pitch, p.resident,
                           has_top_db, top_db, normalize, eps, (const float*)bounds, (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of a call, into out[5]: CTAs an example, mels a CTA, resident
// (1) or re-read (0), dynamic shared bytes a CTA, threads a CTA.
inline int log_mel_epilogue_plan_of(int device, int batch, int n_frames, int n_mels, int* out) {
  if (batch < 1 || n_frames < 1 || n_mels < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  EpiloguePlan p;
  err = epilogue_device_plan(device, batch, n_frames, n_mels, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cluster;
  out[1] = p.band;
  out[2] = p.resident;
  out[3] = (int)p.smem;
  out[4] = p.threads;
  return 0;
}

}  // namespace
