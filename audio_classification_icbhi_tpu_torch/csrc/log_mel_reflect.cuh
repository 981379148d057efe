// numpy's "reflect" padding as an index map, shared by the log-mel spectrum
// kernels that read the unpadded (B, L) waveform: a frame within n_fft / 2 of
// either end maps each sample index through it, every other frame reads the
// waveform directly, so no padded copy is made.

#pragma once

namespace {

// numpy's reflect of waveform index o, which may lie before 0 or past
// length - 1 (a pad longer than the signal repeats with period 2(length - 1)),
// into [0, length): `stft_ops.reflect_pad` of the port, index by index.
__device__ __forceinline__ int reflect_index(int o, int length) {
  if (o >= 0 && o < length) return o;
  if (length == 1) return 0;
  const int period = 2 * (length - 1);
  if (o < 0 && o > -length) return -o;                // one bounce off the start
  if (o >= length && o <= period) return period - o;  // one bounce off the end
  int r = o % period;
  if (r < 0) r += period;
  return r >= length ? period - r : r;
}

}  // namespace
