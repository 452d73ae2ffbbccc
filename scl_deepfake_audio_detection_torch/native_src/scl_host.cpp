// Native host-side data pipeline kernels.
//
// The reference hides its augmentation DSP cost behind 8 forked DataLoader
// workers (main.py:379); this deployment image exposes a single host core,
// so the hot host loops are implemented natively instead: WAV decode, the
// centered-FIR convolution chains that dominate RawBoost's LnL stage
// (datautils/RawBoost.py:59-69 — power series x^i each convolved with its
// own notch chain), the ISD/SSI noise stages, and the multiview co-crop
// (core_scripts/data_io/wav_augmentation.py:209-282).
//
// Contracts mirror the Python implementations in dsp/{fir,rawboost,pad}.py
// exactly for the deterministic ops (FIR, LnL-given-coefficients, pad/crop);
// stochastic stages take either explicit draws or a seed for an internal
// mt19937_64 (distribution parity, not stream parity — SURVEY §7).
//
// Build: `make -C native` -> libscl_host.so; loaded via ctypes
// (scl_deepfake_audio_detection_tpu/native.py) with transparent numpy
// fallback when the toolchain is absent.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

int scl_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// WAV decode (PCM16 / PCM32f, mono-mixed)
// ---------------------------------------------------------------------------

// Returns frame count, fills *sr; -1 on parse error. out may be null to probe.
long scl_wav_read_f32(const char* path, float* out, long max_frames, int* sr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return -1;
  }
  int channels = 0, rate = 0, bits = 0, fmt = 0;
  long data_len = -1;
  // chunk walk
  for (;;) {
    unsigned char ch[8];
    if (std::fread(ch, 1, 8, f) != 8) break;
    uint32_t sz = ch[4] | (ch[5] << 8) | (ch[6] << 16) | ((uint32_t)ch[7] << 24);
    if (!std::memcmp(ch, "fmt ", 4)) {
      unsigned char b[16];
      if (sz < 16 || std::fread(b, 1, 16, f) != 16) { std::fclose(f); return -1; }
      fmt = b[0] | (b[1] << 8);
      channels = b[2] | (b[3] << 8);
      rate = b[4] | (b[5] << 8) | (b[6] << 16) | ((uint32_t)b[7] << 24);
      bits = b[14] | (b[15] << 8);
      if (sz > 16) std::fseek(f, sz - 16, SEEK_CUR);
    } else if (!std::memcmp(ch, "data", 4)) {
      data_len = sz;
      break;
    } else {
      std::fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  // bits < 8 (0 from a corrupt header, or 4-bit ADPCM) would make
  // bytes_per 0 and the frames division a SIGFPE that kills the whole
  // process; return -1 so the python loader falls through to libav
  if (data_len < 0 || channels <= 0 || rate <= 0 || bits < 8) {
    std::fclose(f);
    return -1;
  }
  if (sr) *sr = rate;
  long bytes_per = (bits / 8) * channels;
  long frames = data_len / bytes_per;
  if (!out) { std::fclose(f); return frames; }
  if (frames > max_frames) frames = max_frames;

  const double inv = 1.0 / 32768.0;
  if (fmt == 1 && bits == 16) {
    std::vector<int16_t> buf(frames * channels);
    if ((long)std::fread(buf.data(), 2, frames * channels, f) !=
        frames * channels) { std::fclose(f); return -1; }
    for (long i = 0; i < frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c) acc += buf[i * channels + c] * inv;
      out[i] = (float)(acc / channels);
    }
  } else if (fmt == 3 && bits == 32) {
    std::vector<float> buf(frames * channels);
    if ((long)std::fread(buf.data(), 4, frames * channels, f) !=
        frames * channels) { std::fclose(f); return -1; }
    for (long i = 0; i < frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c) acc += buf[i * channels + c];
      out[i] = (float)(acc / channels);
    }
  } else {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  return frames;
}

// ---------------------------------------------------------------------------
// centered FIR (matches dsp/fir.filter_fir_centered: full convolution, then
// slice [nb//2 : nb//2 + n])
// ---------------------------------------------------------------------------

void scl_fir_centered(const double* x, long n, const double* b, long nb,
                      double* y) {
  const long d = (nb + 1) / 2;  // matches dsp/fir.filter_fir_centered's n//2
  for (long i = 0; i < n; ++i) {
    // y[i] = sum_k b[k] * x[i + d - k], valid x index range only
    double acc = 0.0;
    long k_lo = i + d - (n - 1);
    if (k_lo < 0) k_lo = 0;
    long k_hi = i + d;
    if (k_hi > nb - 1) k_hi = nb - 1;
    const double* xp = x + (i + d);
    for (long k = k_lo; k <= k_hi; ++k) acc += b[k] * xp[-k];
    y[i] = acc;
  }
}

static void demean_norm(double* y, long n, float* out) {
  double mean = 0.0;
  for (long i = 0; i < n; ++i) mean += y[i];
  mean /= (double)n;
  double peak = 0.0;
  for (long i = 0; i < n; ++i) {
    y[i] -= mean;
    double a = std::fabs(y[i]);
    if (a > peak) peak = a;
  }
  const double s = (peak > 1.0) ? 1.0 / peak : 1.0;
  for (long i = 0; i < n; ++i) out[i] = (float)(y[i] * s);
}

// LnL convolutive noise given pre-designed per-power filter chains
// (coefficients from dsp/fir.design_notch_chain, concatenated; offsets[i] is
// the start of chain i, offsets[n_f] the total length). Computes
// y = sum_i fir(x^(i+1), b_i), de-means, conditionally peak-normalizes.
void scl_lnl_apply(const float* x, long n, const double* coeffs,
                   const long* offsets, int n_f, float* out) {
  std::vector<double> pw(n), acc(n, 0.0), tmp(n);
  for (long i = 0; i < n; ++i) pw[i] = x[i];
  for (int p = 0; p < n_f; ++p) {
    const double* b = coeffs + offsets[p];
    long nb = offsets[p + 1] - offsets[p];
    scl_fir_centered(pw.data(), n, b, nb, tmp.data());
    for (long i = 0; i < n; ++i) acc[i] += tmp[i];
    if (p + 1 < n_f)
      for (long i = 0; i < n; ++i) pw[i] *= x[i];
  }
  demean_norm(acc.data(), n, out);
}

// ISD impulsive signal-dependent noise (RawBoost.py:73-84 semantics):
// beta~U(0,P)% of samples get x += g_sd * x * f, f = U(-1,1)*U(-1,1).
void scl_isd_apply(const float* x, long n, double p_max, double g_sd,
                   uint64_t seed, float* out) {
  std::mt19937_64 gen(seed);
  std::uniform_real_distribution<double> u01(0.0, 1.0);
  const double beta = u01(gen) * p_max;
  long count = (long)(n * beta / 100.0);
  // partial Fisher-Yates for the random sample subset
  std::vector<long> idx(n);
  for (long i = 0; i < n; ++i) idx[i] = i;
  std::vector<double> y(n);
  for (long i = 0; i < n; ++i) y[i] = x[i];
  for (long i = 0; i < count; ++i) {
    long j = i + (long)(u01(gen) * (n - i));
    if (j > n - 1) j = n - 1;
    std::swap(idx[i], idx[j]);
    double fa = 2.0 * u01(gen) - 1.0, fb = 2.0 * u01(gen) - 1.0;
    long k = idx[i];
    y[k] = x[k] + g_sd * x[k] * (fa * fb);
  }
  double peak = 0.0;
  for (long i = 0; i < n; ++i) {
    double a = std::fabs(y[i]);
    if (a > peak) peak = a;
  }
  const double s = (peak > 1.0) ? 1.0 / peak : 1.0;
  for (long i = 0; i < n; ++i) out[i] = (float)(y[i] * s);
}

// SSI colored additive noise at a given SNR: noise (given, already
// notch-filtered + peak-normalized) scaled to ||x|| / 10^(snr/20).
void scl_ssi_mix(const float* x, const float* noise, long n, double snr_db,
                 float* out) {
  double nx = 0.0, nn = 0.0;
  for (long i = 0; i < n; ++i) {
    nx += (double)x[i] * x[i];
    nn += (double)noise[i] * noise[i];
  }
  const double scale =
      std::sqrt(nx) / (std::sqrt(nn) * std::pow(10.0, 0.05 * snr_db) + 1e-30);
  for (long i = 0; i < n; ++i) out[i] = (float)(x[i] + noise[i] * scale);
}

// Multiview co-crop (wav_augmentation.py:209-282 semantics): every view is
// length-matched to views[0]'s length (tile or zero-pad), then the shared
// [start, start+length) window is taken. views: row-major [n_views][...],
// lens[i] the true length of view i. start must satisfy the caller's policy.
void scl_multiview_pad(const float** views, const long* lens, int n_views,
                       long base_len, long length, int repeat_pad, long start,
                       float* out /* [n_views * length] */) {
  // Two-stage semantics, exactly like dsp/pad.multiview_pad: (1) each view
  // is length-matched to base_len (truncate, or tile/zero-pad), (2) when
  // base_len < start+length the base-matched view is itself tiled/zero-
  // padded.  Tiling directly mod the raw view length would disagree with
  // the python twin whenever the window crosses base_len.
  for (int v = 0; v < n_views; ++v) {
    const float* src = views[v];
    const long sl = lens[v];
    float* dst = out + (long)v * length;
    for (long i = 0; i < length; ++i) {
      long pos = start + i;
      float val = 0.0f;
      long j = pos;
      if (j >= base_len) {  // stage 2: beyond the base-matched view
        if (repeat_pad && base_len > 0) j = pos % base_len;
        else j = -1;  // zero-pad
      }
      if (j >= 0) {  // stage 1: the view matched to base_len
        if (j < sl) val = src[j];
        else if (repeat_pad && sl > 0) val = src[j % sl];
      }
      dst[i] = val;
    }
  }
}

// Background-noise mix at a target SNR over dBFS-style RMS levels.
void scl_mix_at_snr(const float* x, long n, const float* noise, long n_noise,
                    double snr_db, float* out) {
  double px = 0.0, pn = 0.0;
  for (long i = 0; i < n; ++i) px += (double)x[i] * x[i];
  for (long i = 0; i < n_noise; ++i) pn += (double)noise[i] * noise[i];
  px /= (double)n;
  pn /= (double)(n_noise > 0 ? n_noise : 1);
  const double gain =
      std::sqrt(px / (pn * std::pow(10.0, snr_db / 10.0) + 1e-30));
  for (long i = 0; i < n; ++i) {
    const float nv = n_noise > 0 ? noise[i % n_noise] : 0.0f;
    out[i] = (float)(x[i] + gain * nv);
  }
}

}  // extern "C"
