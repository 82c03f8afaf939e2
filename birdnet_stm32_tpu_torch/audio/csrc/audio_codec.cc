// Multi-format audio decode/encode via FFmpeg's libav* libraries.
//
// The reference decodes mp3/flac/ogg/m4a through soundfile/audioread
// (birdnet_stm32/audio/io.py:63-130, data/dataset.py SUPPORTED_AUDIO_EXTS);
// the port keeps the JAX package's native/audio_codec.cc (this copy is the
// same source) over libavformat/libavcodec/libswresample. Decoding
// returns mono float32 at the stream's native rate (channel MEAN downmix,
// matching reference io.py `y.mean(axis=1)`); resampling stays in the
// existing polyphase path for parity. Encoding exists for fixture
// generation and tooling (flac/ogg/mp3/m4a/wav by extension).
//
// Built as a SEPARATE shared library (libaudio_codec.so) so the base
// libaudio_native.so never depends on libav; Python gates on availability
// (birdnet_stm32_tpu_torch/audio/native.py builds it on first use with the
// flags of audio_native.cc plus pkg-config's libav flags).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstring>
#include <string>
#include <vector>

namespace {

// Workers decode thousands of files; keep libav's per-file chatter
// (e.g. mp3 "Could not update timestamps" notes) off stderr.
struct LogQuiet {
  LogQuiet() { av_log_set_level(AV_LOG_ERROR); }
} log_quiet;

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~DecodeCtx() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* codec = nullptr;
    stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_index < 0 || !codec) return -3;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return -4;
    if (avcodec_parameters_to_context(dec, fmt->streams[stream_index]->codecpar) < 0)
      return -5;
    if (avcodec_open2(dec, codec, nullptr) < 0) return -6;
    return 0;
  }
};

// Mean-downmix one decoded frame (any sample format) into mono float32.
// Returns samples appended.
long append_mono(const AVFrame* f, std::vector<float>& out) {
  const int n = f->nb_samples;
  const int ch = f->ch_layout.nb_channels;
  if (n <= 0 || ch <= 0) return 0;
  const AVSampleFormat fmt = static_cast<AVSampleFormat>(f->format);
  const bool planar = av_sample_fmt_is_planar(fmt);
  const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
  out.reserve(out.size() + n);
  const float inv_ch = 1.0f / static_cast<float>(ch);

  auto sample = [&](int c, int i) -> float {
    const uint8_t* plane = planar ? f->extended_data[c] : f->extended_data[0];
    const int idx = planar ? i : i * ch + c;
    switch (base) {
      case AV_SAMPLE_FMT_FLT:
        return reinterpret_cast<const float*>(plane)[idx];
      case AV_SAMPLE_FMT_DBL:
        return static_cast<float>(reinterpret_cast<const double*>(plane)[idx]);
      case AV_SAMPLE_FMT_S16:
        return reinterpret_cast<const int16_t*>(plane)[idx] / 32768.0f;
      case AV_SAMPLE_FMT_S32:
        return reinterpret_cast<const int32_t*>(plane)[idx] / 2147483648.0f;
      case AV_SAMPLE_FMT_U8:
        return (reinterpret_cast<const uint8_t*>(plane)[idx] - 128) / 128.0f;
      default:
        return 0.0f;
    }
  };

  for (int i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) acc += sample(c, i);
    out.push_back(acc * inv_ch);
  }
  return n;
}

}  // namespace

extern "C" {

// Probe: fills sample_rate/channels/frames (frames estimated from duration
// when the container doesn't store an exact count). Returns 0 on success.
int codec_audio_info(const char* path, int* sample_rate, int* channels,
                     long* frames) {
  DecodeCtx ctx;
  if (ctx.open(path) != 0) return -1;
  const AVStream* st = ctx.fmt->streams[ctx.stream_index];
  *sample_rate = ctx.dec->sample_rate;
  *channels = ctx.dec->ch_layout.nb_channels;
  long nf = 0;  // st->nb_frames counts packets, not samples — don't use it
  if (st->duration > 0 && st->time_base.den > 0) {
    nf = static_cast<long>(st->duration * st->time_base.num *
                           static_cast<int64_t>(ctx.dec->sample_rate) /
                           st->time_base.den);
  } else if (ctx.fmt->duration > 0) {
    nf = static_cast<long>(ctx.fmt->duration *
                           static_cast<int64_t>(ctx.dec->sample_rate) /
                           AV_TIME_BASE);
  }
  *frames = nf;
  return (*sample_rate > 0 && *channels > 0) ? 0 : -2;
}

// Decode up to max_frames mono float32 samples after skipping
// offset_frames, at the stream's native rate. Pass max_frames <= 0 for
// "until EOF". Writes the native sample rate to *sample_rate_out.
// Returns frames written, or < 0 on error.
long codec_decode_f32(const char* path, long offset_frames, long max_frames,
                      float* out_buf, long out_capacity, int* sample_rate_out) {
  DecodeCtx ctx;
  if (ctx.open(path) != 0) return -1;
  *sample_rate_out = ctx.dec->sample_rate;
  const AVStream* st = ctx.fmt->streams[ctx.stream_index];

  long skip = offset_frames > 0 ? offset_frames : 0;
  long seek_target = 0;  // samples the coarse seek aimed at (BACKWARD)
  // Coarse seek for large offsets (audio packets are all keyframes in
  // most codecs); the remainder is discarded sample-exactly below.
  if (skip > static_cast<long>(ctx.dec->sample_rate)) {
    seek_target = skip - ctx.dec->sample_rate / 4;
    const int64_t ts = av_rescale(seek_target,
                                  st->time_base.den,
                                  static_cast<int64_t>(st->time_base.num) *
                                      ctx.dec->sample_rate);
    if (av_seek_frame(ctx.fmt, ctx.stream_index, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(ctx.dec);
      // After a container seek the discard count is unknown exactly; the
      // first decoded frame's PTS tells us where we landed.
      skip = -1;  // sentinel: compute from first frame PTS
    }
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<float> mono;
  long written = 0;
  bool eof = false;
  long to_skip = skip >= 0 ? skip : 0;
  bool skip_from_pts = skip < 0;

  while (!eof && (max_frames <= 0 || written < max_frames)) {
    int r = av_read_frame(ctx.fmt, pkt);
    if (r < 0) {
      avcodec_send_packet(ctx.dec, nullptr);  // flush
      eof = true;
    } else if (pkt->stream_index != ctx.stream_index) {
      av_packet_unref(pkt);
      continue;
    } else {
      avcodec_send_packet(ctx.dec, pkt);
      av_packet_unref(pkt);
    }
    while (avcodec_receive_frame(ctx.dec, frame) == 0) {
      if (skip_from_pts) {
        // No PTS on the first post-seek frame: assume the BACKWARD seek
        // landed at its target. Assuming 0 would re-skip the full offset
        // and return audio from ~2x the requested position.
        long landed = seek_target;
        if (frame->pts != AV_NOPTS_VALUE && st->time_base.num > 0) {
          landed = static_cast<long>(av_rescale(
              frame->pts, static_cast<int64_t>(st->time_base.num) *
                              ctx.dec->sample_rate,
              st->time_base.den));
        }
        to_skip = offset_frames - landed;
        if (to_skip < 0) to_skip = 0;
        skip_from_pts = false;
      }
      mono.clear();
      append_mono(frame, mono);
      long start = 0;
      if (to_skip > 0) {
        const long take = std::min<long>(to_skip, static_cast<long>(mono.size()));
        start = take;
        to_skip -= take;
      }
      long avail = static_cast<long>(mono.size()) - start;
      if (avail > 0) {
        long want = max_frames > 0 ? max_frames - written : avail;
        long n = std::min<long>(avail, want);
        n = std::min<long>(n, out_capacity - written);
        if (n > 0) {
          std::memcpy(out_buf + written, mono.data() + start,
                      static_cast<size_t>(n) * sizeof(float));
          written += n;
        }
        if (written >= out_capacity) {
          eof = true;
          break;
        }
      }
      av_frame_unref(frame);
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return written;
}

// Encode mono float32 -> file, codec chosen by extension
// (.flac / .ogg / .mp3 / .wav). Returns 0 on success.
int codec_encode_f32(const char* path, const float* data, long frames,
                     int sample_rate) {
  const std::string p(path);
  const AVCodec* codec = nullptr;
  auto ends_with = [&](const char* suf) {
    const size_t n = std::strlen(suf);
    return p.size() >= n && p.compare(p.size() - n, n, suf) == 0;
  };
  bool experimental = false;
  if (ends_with(".flac")) {
    codec = avcodec_find_encoder(AV_CODEC_ID_FLAC);
  } else if (ends_with(".ogg")) {
    codec = avcodec_find_encoder_by_name("libvorbis");
    if (!codec) {
      codec = avcodec_find_encoder(AV_CODEC_ID_VORBIS);
      experimental = true;
    }
  } else if (ends_with(".mp3")) {
    codec = avcodec_find_encoder_by_name("libmp3lame");
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MP3);
  } else if (ends_with(".m4a")) {
    codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  } else {
    codec = avcodec_find_encoder(AV_CODEC_ID_PCM_S16LE);
  }
  if (!codec) return -1;

  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -2;
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  int ret = -3;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;

  do {
    if (!st || !enc) break;
    enc->sample_rate = sample_rate;
    av_channel_layout_default(&enc->ch_layout, 1);
    enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLT;
    enc->time_base = AVRational{1, sample_rate};
    if (experimental) enc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
      break;
    if (avformat_write_header(fmt, nullptr) < 0) break;

    AVChannelLayout mono_layout;
    av_channel_layout_default(&mono_layout, 1);
    if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt, sample_rate,
                            &mono_layout, AV_SAMPLE_FMT_FLT, sample_rate, 0,
                            nullptr) < 0 ||
        swr_init(swr) < 0)
      break;

    const int chunk = enc->frame_size > 0 ? enc->frame_size : 4096;
    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    long pos = 0;
    int64_t pts = 0;
    bool failed = false;
    while (pos < frames && !failed) {
      const int n = static_cast<int>(std::min<long>(chunk, frames - pos));
      frame->nb_samples = n;
      frame->format = enc->sample_fmt;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      frame->sample_rate = sample_rate;
      if (av_frame_get_buffer(frame, 0) < 0) { failed = true; break; }
      const uint8_t* in[1] = {reinterpret_cast<const uint8_t*>(data + pos)};
      if (swr_convert(swr, frame->extended_data, n, in, n) < 0) { failed = true; break; }
      frame->pts = pts;
      pts += n;
      pos += n;
      if (avcodec_send_frame(enc, frame) < 0) { failed = true; break; }
      while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
      }
      av_frame_unref(frame);
    }
    if (!failed) {
      avcodec_send_frame(enc, nullptr);
      while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        av_interleaved_write_frame(fmt, pkt);
      }
      av_write_trailer(fmt);
      ret = 0;
    }
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (fmt->pb && !(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return ret;
}

}  // extern "C"
