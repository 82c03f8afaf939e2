// Native host-side audio input pipeline: WAV decode + mono downmix +
// polyphase resampling + peak normalization.
//
// The port's copy of the JAX package's native/audio_native.cc (the same
// source, so the same samples): the reference's native decode tier
// (firmware/Src/wav_reader.c:17-129 RIFF chunk walker + PCM->float32 + mono
// downmix, and the worker hot loop soundfile-decode -> resample_poly in
// birdnet_stm32/data/generator.py:49-175) as a flat C ABI consumed via
// ctypes (birdnet_stm32_tpu_torch/audio/native.py).
//
// Built on first use by birdnet_stm32_tpu_torch/audio/native.py
// (g++ -O3 -march=native -fPIC -shared -std=c++17 -Wall).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct WavHeader {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  uint64_t data_bytes = 0;
};

// RIFF chunk walker (same traversal contract as the reference reader:
// tolerate unknown chunks, require fmt before data).
bool parse_header(FILE* f, WavHeader* h) {
  unsigned char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0) return false;
  bool have_fmt = false;
  while (true) {
    unsigned char hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, hdr + 4, 4);
    if (memcmp(hdr, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      const uint32_t want = size < 40 ? size : 40;
      if (size < 16 || fread(fmt, 1, want, f) != want) return false;
      memcpy(&h->format, fmt + 0, 2);
      memcpy(&h->channels, fmt + 2, 2);
      memcpy(&h->sample_rate, fmt + 4, 4);
      memcpy(&h->bits, fmt + 14, 2);
      if (h->format == 0xFFFE && want >= 26) {
        // WAVE_FORMAT_EXTENSIBLE: the real format tag is the first two
        // bytes of the SubFormat GUID at offset 24.
        memcpy(&h->format, fmt + 24, 2);
      }
      if (size > want) fseek(f, size - want, SEEK_CUR);
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      h->data_offset = ftell(f);
      // Clamp to the bytes actually on disk: streamed/interrupted
      // recorders write 0xFFFFFFFF (or more than was flushed), and an
      // unclamped count would read past EOF (numpy-twin parity).
      long pos = ftell(f);
      fseek(f, 0, SEEK_END);
      long fsize = ftell(f);
      fseek(f, pos, SEEK_SET);
      uint64_t on_disk = fsize > pos ? (uint64_t)(fsize - pos) : 0;
      h->data_bytes = size < on_disk ? size : on_disk;
      return have_fmt && h->channels > 0 && h->bits >= 8;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

inline float i0(float x) {
  // Modified Bessel I0 by series (converges fast for |x| < ~20).
  float sum = 1.0f, term = 1.0f;
  const float half_x = x * 0.5f;
  for (int k = 1; k < 64; ++k) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-10f * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Returns 0 on success. Outputs: sample_rate, channels, frames.
int wav_native_info(const char* path, int* sample_rate, int* channels,
                    long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  bool ok = parse_header(f, &h);
  fclose(f);
  if (!ok) return -2;
  const uint64_t frame_bytes = (uint64_t)h.channels * (h.bits / 8);
  *sample_rate = (int)h.sample_rate;
  *channels = (int)h.channels;
  *frames = frame_bytes ? (long)(h.data_bytes / frame_bytes) : 0;
  return 0;
}

// Decode [start_frame, start_frame + n_frames) to mono float32 in [-1, 1].
// Mono downmix averages channels (reference reader takes channel 0; the
// Python layer selects the policy — see wav_native_read's `downmix`).
// Returns the number of frames written, or < 0 on error.
long wav_native_read(const char* path, long start_frame, long n_frames,
                     int downmix /* 0 = channel 0, 1 = average */,
                     float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  if (!parse_header(f, &h)) {
    fclose(f);
    return -2;
  }
  // Reject combos the loop below has no branch for (a-law/mu-law, 48/64-bit
  // PCM, 16-bit float): falling through would emit silence/garbage with no
  // error, diverging from the numpy twin which raises and skips the file.
  const bool supported =
      (h.format == 3 && (h.bits == 32 || h.bits == 64)) ||
      (h.format == 1 && (h.bits == 8 || h.bits == 16 || h.bits == 24 || h.bits == 32));
  if (!supported) {
    fclose(f);
    return -4;
  }
  const int bytes_per_sample = h.bits / 8;
  const uint64_t frame_bytes = (uint64_t)h.channels * bytes_per_sample;
  const long total = (long)(h.data_bytes / frame_bytes);
  start_frame = std::max(0L, std::min(start_frame, total));
  n_frames = std::min(n_frames, total - start_frame);
  if (n_frames <= 0) {
    fclose(f);
    return 0;
  }
  if (fseek(f, h.data_offset + (long)(start_frame * frame_bytes), SEEK_SET) != 0) {
    fclose(f);
    return -3;
  }

  std::vector<unsigned char> raw(n_frames * frame_bytes);
  const long got = (long)(fread(raw.data(), frame_bytes, n_frames, f));
  fclose(f);

  const int C = h.channels;
  const float inv_c = 1.0f / C;
  for (long i = 0; i < got; ++i) {
    const unsigned char* p = raw.data() + i * frame_bytes;
    float acc = 0.0f;
    const int n_ch = downmix ? C : 1;
    for (int c = 0; c < n_ch; ++c) {
      const unsigned char* s = p + c * bytes_per_sample;
      float v = 0.0f;
      if (h.format == 3 && h.bits == 32) {
        float fv;
        memcpy(&fv, s, 4);
        v = fv;
      } else if (h.format == 3 && h.bits == 64) {
        double dv;
        memcpy(&dv, s, 8);
        v = (float)dv;
      } else if (h.bits == 16) {
        int16_t iv;
        memcpy(&iv, s, 2);
        v = iv / 32768.0f;
      } else if (h.bits == 32) {
        int32_t iv;
        memcpy(&iv, s, 4);
        v = (float)(iv / 2147483648.0);
      } else if (h.bits == 24) {
        int32_t iv = (s[0] << 8) | (s[1] << 16) | ((int32_t)(int8_t)s[2] << 24);
        v = (float)(iv / 2147483648.0);
      } else if (h.bits == 8) {
        v = ((int)p[c] - 128) / 128.0f;
      }
      acc += v;
    }
    out[i] = downmix ? acc * inv_c : acc;
  }
  return got;
}

// Kaiser-windowed-sinc polyphase resampler, matching
// scipy.signal.resample_poly(x, up, down) semantics: FIR low-pass at
// min(up, down) Nyquist, 2*10*max(up,down) + 1 taps, Kaiser beta 5.0,
// zero-phase (filter centered), output length ceil(n_in * up / down).
// Callers pass up/down already reduced by gcd. Returns output length.
long resample_poly_native(const float* x, long n_in, int up, int down,
                          float* out) {
  if (up == down) {
    memcpy(out, x, n_in * sizeof(float));
    return n_in;
  }
  const int max_rate = std::max(up, down);
  const float f_c = 1.0f / (float)max_rate;  // cutoff in Nyquist units
  const int half_len = 10 * max_rate;
  const int n_taps = 2 * half_len + 1;

  // firwin(n_taps, f_c, window=('kaiser', 5.0)) scaled by `up`.
  std::vector<float> taps(n_taps);
  const float beta = 5.0f;
  const float i0_beta = i0(beta);
  double sum = 0.0;
  for (int i = 0; i < n_taps; ++i) {
    const double m = i - half_len;
    const double sinc = (m == 0.0) ? f_c : std::sin(M_PI * f_c * m) / (M_PI * m);
    const double r = 2.0 * i / (n_taps - 1) - 1.0;
    const double w = i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0_beta;
    taps[i] = (float)(sinc * w);
    sum += taps[i];
  }
  // firwin normalizes DC gain to 1 at band center; resample_poly scales by up.
  const float norm = (float)(up / sum);
  for (auto& t : taps) t *= norm;

  // Polyphase evaluation of upfirdn(taps, x, up, down), centered so the
  // output is zero-phase (scipy trims (n_taps - 1) / 2 leading samples
  // post-upsample => offset in upsampled coordinates).
  const long n_out = (n_in * (long)up + down - 1) / down;
  const long offset = half_len;  // == (n_taps - 1) / 2
  for (long j = 0; j < n_out; ++j) {
    // Output j taps upsampled position p = j*down + offset; contribution
    // from input sample k requires (p - k*up) in [0, n_taps).
    const long p = j * (long)down + offset;
    long k_lo = (p - (n_taps - 1) + up - 1) / up;  // ceil((p - n_taps + 1) / up)
    if (k_lo < 0) k_lo = 0;
    long k_hi = p / up;
    if (k_hi >= n_in) k_hi = n_in - 1;
    float acc = 0.0f;
    for (long k = k_lo; k <= k_hi; ++k) {
      acc += x[k] * taps[p - k * up];
    }
    out[j] = acc;
  }
  return n_out;
}

}  // extern "C"
