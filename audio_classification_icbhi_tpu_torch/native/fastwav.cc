// fastwav: native WAV decode and batched parallel loading for the PyTorch
// package.
//
// A copy of the JAX package's `native/fastwav.cc`, built separately
// (`native/__init__.py` compiles it with g++ into build/native/), so that
// neither package loads the other's library. Decoding and batch assembly
// run in C++ threads without the GIL and write float32 mono PCM straight
// into the caller's batch buffer.
//
// Formats: RIFF/WAVE PCM 8/16/24/32-bit and IEEE float32/64, including
// WAVE_FORMAT_EXTENSIBLE. Matches the numpy codec in data/wavio.py bit for
// bit (same scaling conventions).
//
// ABI (ctypes, see native/__init__.py):
//   fastwav_info(path, &sr, &channels, &n_frames) -> 0 | err
//   fastwav_decode_mono(path, out, capacity, &n, &sr) -> 0 | err
//   fastwav_decode_batch(paths, n_files, target_len, out, srs, ns, threads)


#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Wav {
  std::vector<float> mono;  // mono-mixed samples in [-1, 1]
  int sample_rate = 0;
  int channels = 0;
};

// error codes
enum {
  OK = 0,
  ERR_OPEN = 1,
  ERR_NOT_WAV = 2,
  ERR_NO_CHUNKS = 3,
  ERR_FORMAT = 4,
  ERR_CAPACITY = 5,
  ERR_ALLOC = 6,      // std::bad_alloc etc. caught at the ABI boundary
  ERR_TRUNCATED = 7,  // chunk declares more bytes than the file holds
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }
// Sample readers go through memcpy: the data chunk is only 2-byte aligned
// in the file buffer, so reinterpret_cast loads of 32/64-bit types would be
// unaligned UB. Compilers lower these memcpys to single (unaligned) loads.
int16_t rd_s16(const uint8_t* p) { return (int16_t)rd_u16(p); }
int32_t rd_s32(const uint8_t* p) { return (int32_t)rd_u32(p); }
float rd_f32(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}
double rd_f64(const uint8_t* p) {
  double v;
  std::memcpy(&v, p, 8);
  return v;
}

struct Header {
  const uint8_t* data = nullptr;  // points into the raw buffer
  size_t data_len = 0;
  uint16_t audio_format = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint32_t sr = 0;
  size_t n_frames = 0;
};

int read_file(const char* path, std::vector<uint8_t>& raw) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {  // non-seekable (FIFO) or error: (size_t)-1 would throw
    std::fclose(f);
    return ERR_OPEN;
  }
  std::fseek(f, 0, SEEK_SET);
  raw.resize((size_t)size);
  if (std::fread(raw.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return ERR_OPEN;
  }
  std::fclose(f);
  return OK;
}

int parse_header(const std::vector<uint8_t>& raw, Header& h) {
  size_t size = raw.size();
  if (size < 12 || std::memcmp(raw.data(), "RIFF", 4) != 0 ||
      std::memcmp(raw.data() + 8, "WAVE", 4) != 0)
    return ERR_NOT_WAV;

  const uint8_t* fmt = nullptr;
  size_t fmt_len = 0;
  size_t pos = 12;
  while (pos + 8 <= size) {
    const uint8_t* cid = raw.data() + pos;
    uint32_t csize = rd_u32(raw.data() + pos + 4);
    const uint8_t* body = raw.data() + pos + 8;
    // reject rather than clamp: a partially-written file would otherwise
    // decode to silently shortened audio (matches data/wavio.py)
    if (pos + 8 + csize > size) return ERR_TRUNCATED;
    if (!std::memcmp(cid, "fmt ", 4)) {
      fmt = body;
      fmt_len = csize;
    } else if (!std::memcmp(cid, "data", 4)) {
      h.data = body;
      h.data_len = csize;
    }
    pos += 8 + csize + (csize & 1);  // word alignment
  }
  if (!fmt || !h.data) return ERR_NO_CHUNKS;
  // Validate the fmt chunk size BEFORE reading fields: a truncated or
  // malformed chunk would otherwise heap-over-read at fmt+14 / fmt+24.
  if (fmt_len < 16) return ERR_FORMAT;

  h.audio_format = rd_u16(fmt);
  h.channels = rd_u16(fmt + 2);
  h.sr = rd_u32(fmt + 4);
  h.bits = rd_u16(fmt + 14);
  if (h.audio_format == 0xFFFE) {  // EXTENSIBLE: sub-format code at +24
    if (fmt_len < 26) return ERR_FORMAT;
    h.audio_format = rd_u16(fmt + 24);
  }
  if (h.channels == 0) return ERR_FORMAT;
  size_t bytes_per = h.bits / 8;
  if (bytes_per == 0) return ERR_FORMAT;
  h.n_frames = h.data_len / bytes_per / h.channels;
  return OK;
}

int decode(const char* path, Wav& wav) {
  std::vector<uint8_t> raw;
  int rc = read_file(path, raw);
  if (rc != OK) return rc;
  Header h;
  rc = parse_header(raw, h);
  if (rc != OK) return rc;

  uint16_t audio_format = h.audio_format;
  int channels = h.channels;
  uint16_t bits = h.bits;
  const uint8_t* data = h.data;
  size_t n_frames = h.n_frames;
  wav.sample_rate = (int)h.sr;
  wav.channels = channels;
  wav.mono.assign(n_frames, 0.0f);
  const float inv_ch = 1.0f / (float)channels;

  if (audio_format == 1) {  // PCM
    if (bits == 16) {
      constexpr float k = 1.0f / 32768.0f;
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c)
          acc += (float)rd_s16(data + (i * channels + c) * 2);
        wav.mono[i] = acc * k * inv_ch;
      }
    } else if (bits == 8) {
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c)
          acc += ((float)data[i * channels + c] - 128.0f) / 128.0f;
        wav.mono[i] = acc * inv_ch;
      }
    } else if (bits == 24) {
      constexpr float k = 1.0f / 8388608.0f;
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c) {
          const uint8_t* b = data + (i * channels + c) * 3;
          int32_t v = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          acc += (float)v * k;
        }
        wav.mono[i] = acc * inv_ch;
      }
    } else if (bits == 32) {
      constexpr float k = 1.0f / 2147483648.0f;
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c)
          acc += (float)rd_s32(data + (i * channels + c) * 4) * k;
        wav.mono[i] = acc * inv_ch;
      }
    } else {
      return ERR_FORMAT;
    }
  } else if (audio_format == 3) {  // IEEE float
    if (bits == 32) {
      for (size_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int c = 0; c < channels; ++c)
          acc += rd_f32(data + (i * channels + c) * 4);
        wav.mono[i] = acc * inv_ch;
      }
    } else if (bits == 64) {
      for (size_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c)
          acc += rd_f64(data + (i * channels + c) * 8);
        wav.mono[i] = (float)(acc * inv_ch);
      }
    } else {
      return ERR_FORMAT;
    }
  } else {
    return ERR_FORMAT;
  }
  return OK;
}

// Exceptions must never cross the extern "C" / worker-thread boundary: a
// bad_alloc on a corrupt multi-GB size field would std::terminate the whole
// Python process instead of reporting a per-file failure.
int decode_noexcept(const char* path, Wav& wav) noexcept {
  try {
    return decode(path, wav);
  } catch (...) {
    return ERR_ALLOC;
  }
}

}  // namespace

extern "C" {

// Header-only metadata (one file read, NO sample conversion — decode_mono's
// Python caller probes this to size its buffer, so a full decode here would
// double every load's conversion cost).
int fastwav_info(const char* path, int* sample_rate, int* channels, long* n_frames) {
  try {
    std::vector<uint8_t> raw;
    int rc = read_file(path, raw);
    if (rc != OK) return rc;
    Header h;
    rc = parse_header(raw, h);
    if (rc != OK) return rc;
    *sample_rate = (int)h.sr;
    *channels = h.channels;
    *n_frames = (long)h.n_frames;
    return OK;
  } catch (...) {
    return ERR_ALLOC;
  }
}

// Decode to mono float32. Writes min(n, capacity) samples; *n_samples gets
// the TRUE length so callers can size a retry.
int fastwav_decode_mono(const char* path, float* out, long capacity,
                        long* n_samples, int* sample_rate) {
  Wav wav;
  int rc = decode_noexcept(path, wav);
  if (rc != OK) return rc;
  *n_samples = (long)wav.mono.size();
  *sample_rate = wav.sample_rate;
  long n = (long)wav.mono.size();
  if (n > capacity) n = capacity;
  std::memcpy(out, wav.mono.data(), (size_t)n * sizeof(float));
  return OK;
}

// Parallel batched decode with fixed-shape assembly: each file is decoded,
// end-padded with zeros or CENTER-cropped to target_len (matching the
// wavio.pad_or_crop), and written to
// out[i * target_len]. srs[i] gets the file's native sample rate so the
// caller can route files needing resampling through the host resampler.
// Returns the number of failed files (their rows are zero, srs[i] = -err).
int fastwav_decode_batch(const char** paths, int n_files, long target_len,
                         float* out, int* srs, long* true_lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto work = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files) return;
      float* row = out + (size_t)i * (size_t)target_len;
      Wav wav;
      int rc = decode_noexcept(paths[i], wav);
      if (rc != OK) {
        std::memset(row, 0, (size_t)target_len * sizeof(float));
        srs[i] = -rc;
        true_lens[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      srs[i] = wav.sample_rate;
      long n = (long)wav.mono.size();
      true_lens[i] = n;
      if (n >= target_len) {
        long start = (n - target_len) / 2;  // center crop
        std::memcpy(row, wav.mono.data() + start, (size_t)target_len * sizeof(float));
      } else {
        std::memcpy(row, wav.mono.data(), (size_t)n * sizeof(float));
        std::memset(row + n, 0, (size_t)(target_len - n) * sizeof(float));
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
