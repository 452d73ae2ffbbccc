// Native audio codec module: libavformat/libavcodec bindings.
//
// Why: the reference decodes eval audio with librosa/soundfile
// (datautils/asvspoof_2019_augall_3.py:96,152 — the LA19 eval set ships
// .flac) and runs lossy-codec augmentation through pydub/ffmpeg
// (core_scripts/data_io/wav_augmentation.py:367-456 wav_codec mp3/opus;
// datautils/audio_augmentor/telephone.py:23-72 ALAW/ULAW/g722).  This image
// has neither soundfile nor an ffmpeg binary, but ships the ffmpeg 5.x
// *libraries* (libavformat/libavcodec/libavutil + libmp3lame) with headers —
// so the capability is provided by linking them directly: a universal
// decoder (flac/mp3/ogg/opus/wav/...) and a file encoder used for
// encode→decode round-trips (mp3/opus/flac/g722/alaw/ulaw).
//
// Decode returns mono float32 at the file's native rate (channel mean —
// librosa.load(mono=True) convention); the Python side resamples to 16 kHz.
// Gapless metadata (mp3 Xing delay, opus pre-skip) is applied by the
// decoders via packet side data, so round-trips are sample-aligned.
//
// Build: make -C native libscl_codec.so (links -lavformat -lavcodec
// -lavutil); loaded via ctypes (scl_deepfake_audio_detection_tpu/native.py).
// When the libs are absent the build fails and Python falls back to
// soundfile / the ffmpeg binary / G.711-only behavior, as before.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
}

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_err;

void set_err(const std::string& msg, int averr = 0) {
  g_err = msg;
  if (averr != 0) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(averr, buf, sizeof(buf));
    g_err += ": ";
    g_err += buf;
  }
}

struct DecodedAudio {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

// Append one decoded frame, mixed down to mono, to out.
bool mixdown_frame(const AVFrame* fr, std::vector<float>* out) {
  const int nc = fr->ch_layout.nb_channels;
  const int ns = fr->nb_samples;
  if (nc <= 0 || ns <= 0) return true;
  const auto fmt = static_cast<AVSampleFormat>(fr->format);
  const bool planar = av_sample_fmt_is_planar(fmt) != 0;
  const float inv_c = 1.0f / static_cast<float>(nc);
  out->reserve(out->size() + ns);

  // sample fetch as float in [-1, 1], by format
  auto fetch = [&](int ch, int i) -> float {
    const uint8_t* base = planar ? fr->extended_data[ch] : fr->extended_data[0];
    const long idx = planar ? i : (static_cast<long>(i) * nc + ch);
    switch (fmt) {
      case AV_SAMPLE_FMT_U8:
      case AV_SAMPLE_FMT_U8P:
        return (static_cast<float>(base[idx]) - 128.0f) / 128.0f;
      case AV_SAMPLE_FMT_S16:
      case AV_SAMPLE_FMT_S16P:
        return reinterpret_cast<const int16_t*>(base)[idx] / 32768.0f;
      case AV_SAMPLE_FMT_S32:
      case AV_SAMPLE_FMT_S32P:
        return static_cast<float>(reinterpret_cast<const int32_t*>(base)[idx]) /
               2147483648.0f;
      case AV_SAMPLE_FMT_S64:
      case AV_SAMPLE_FMT_S64P:
        // NB: (int64)1 << 63 would overflow; use the literal 2^63
        return static_cast<float>(
            reinterpret_cast<const int64_t*>(base)[idx] /
            9223372036854775808.0);
      case AV_SAMPLE_FMT_FLT:
      case AV_SAMPLE_FMT_FLTP:
        return reinterpret_cast<const float*>(base)[idx];
      case AV_SAMPLE_FMT_DBL:
      case AV_SAMPLE_FMT_DBLP:
        return static_cast<float>(reinterpret_cast<const double*>(base)[idx]);
      default:
        return 0.0f;
    }
  };

  if (fmt == AV_SAMPLE_FMT_NONE || av_get_bytes_per_sample(fmt) == 0) {
    set_err("unsupported sample format");
    return false;
  }
  for (int i = 0; i < ns; ++i) {
    float acc = 0.0f;
    for (int ch = 0; ch < nc; ++ch) acc += fetch(ch, i);
    out->push_back(acc * inv_c);
  }
  return true;
}

bool decode_file(const char* path, DecodedAudio* res) {
  AVFormatContext* fc = nullptr;
  int err = avformat_open_input(&fc, path, nullptr, nullptr);
  if (err < 0) {
    set_err(std::string("open failed: ") + path, err);
    return false;
  }
  bool ok = false;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  do {
    err = avformat_find_stream_info(fc, nullptr);
    if (err < 0) {
      set_err("find_stream_info failed", err);
      break;
    }
    const AVCodec* dec = nullptr;
    const int si = av_find_best_stream(fc, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (si < 0 || dec == nullptr) {
      set_err("no decodable audio stream", si);
      break;
    }
    cc = avcodec_alloc_context3(dec);
    if (cc == nullptr ||
        avcodec_parameters_to_context(cc, fc->streams[si]->codecpar) < 0) {
      set_err("decoder context setup failed");
      break;
    }
    cc->pkt_timebase = fc->streams[si]->time_base;
    err = avcodec_open2(cc, dec, nullptr);
    if (err < 0) {
      set_err("decoder open failed", err);
      break;
    }
    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    bool frame_ok = true;
    auto drain = [&]() {
      while (frame_ok && avcodec_receive_frame(cc, fr) == 0) {
        frame_ok = mixdown_frame(fr, &res->samples);
        if (res->sample_rate == 0) res->sample_rate = fr->sample_rate;
      }
    };
    while (frame_ok && av_read_frame(fc, pkt) >= 0) {
      if (pkt->stream_index == si && avcodec_send_packet(cc, pkt) == 0) drain();
      av_packet_unref(pkt);
    }
    if (frame_ok) {
      avcodec_send_packet(cc, nullptr);  // flush
      drain();
    }
    if (!frame_ok) break;
    if (res->sample_rate == 0) res->sample_rate = cc->sample_rate;
    if (res->samples.empty() || res->sample_rate <= 0) {
      set_err(std::string("no audio decoded from ") + path);
      break;
    }
    ok = true;
  } while (false);
  av_frame_free(&fr);
  av_packet_free(&pkt);
  avcodec_free_context(&cc);
  avformat_close_input(&fc);
  return ok;
}

AVCodecID codec_id_for(const char* name) {
  const std::string c(name ? name : "");
  if (c == "mp3") return AV_CODEC_ID_MP3;
  if (c == "opus") return AV_CODEC_ID_OPUS;
  if (c == "flac") return AV_CODEC_ID_FLAC;
  if (c == "alaw") return AV_CODEC_ID_PCM_ALAW;
  if (c == "ulaw" || c == "mulaw") return AV_CODEC_ID_PCM_MULAW;
  if (c == "g722") return AV_CODEC_ID_ADPCM_G722;
  if (c == "vorbis") return AV_CODEC_ID_VORBIS;
  return AV_CODEC_ID_NONE;
}

const AVCodec* find_encoder(AVCodecID id) {
  // prefer the external high-quality encoders when present
  if (id == AV_CODEC_ID_MP3)
    if (const AVCodec* c = avcodec_find_encoder_by_name("libmp3lame")) return c;
  if (id == AV_CODEC_ID_OPUS)
    if (const AVCodec* c = avcodec_find_encoder_by_name("libopus")) return c;
  if (id == AV_CODEC_ID_VORBIS)
    if (const AVCodec* c = avcodec_find_encoder_by_name("libvorbis")) return c;
  return avcodec_find_encoder(id);
}

// Pick the encoder's preferred sample format (we feed float mono; conversion
// to the chosen format is done per-sample below).
AVSampleFormat pick_sample_fmt(const AVCodec* enc) {
  static const AVSampleFormat prefs[] = {
      AV_SAMPLE_FMT_FLT,  AV_SAMPLE_FMT_FLTP, AV_SAMPLE_FMT_S16,
      AV_SAMPLE_FMT_S16P, AV_SAMPLE_FMT_S32,  AV_SAMPLE_FMT_S32P,
      AV_SAMPLE_FMT_DBL,  AV_SAMPLE_FMT_DBLP};
  if (enc->sample_fmts == nullptr) return AV_SAMPLE_FMT_FLT;
  for (AVSampleFormat want : prefs)
    for (const AVSampleFormat* f = enc->sample_fmts; *f != AV_SAMPLE_FMT_NONE;
         ++f)
      if (*f == want) return want;
  return enc->sample_fmts[0];
}

bool rate_supported(const AVCodec* enc, int sr) {
  if (enc->supported_samplerates == nullptr) return true;
  for (const int* r = enc->supported_samplerates; *r != 0; ++r)
    if (*r == sr) return true;
  return false;
}

void fill_frame(AVFrame* fr, const float* x, long off, int n, int total,
                AVSampleFormat fmt) {
  // mono: planar and interleaved lay out identically in data[0]
  auto clip16 = [](float v) -> int16_t {
    const float s = v * 32768.0f;
    return static_cast<int16_t>(s >= 32767.0f ? 32767
                                              : (s < -32768.0f ? -32768
                                                               : lrintf(s)));
  };
  for (int i = 0; i < total; ++i) {
    const float v = (i < n) ? x[off + i] : 0.0f;  // zero-pad the tail
    switch (fmt) {
      case AV_SAMPLE_FMT_S16:
      case AV_SAMPLE_FMT_S16P:
        reinterpret_cast<int16_t*>(fr->data[0])[i] = clip16(v);
        break;
      case AV_SAMPLE_FMT_S32:
      case AV_SAMPLE_FMT_S32P:
        reinterpret_cast<int32_t*>(fr->data[0])[i] =
            static_cast<int32_t>(clip16(v)) << 16;
        break;
      case AV_SAMPLE_FMT_DBL:
      case AV_SAMPLE_FMT_DBLP:
        reinterpret_cast<double*>(fr->data[0])[i] = v;
        break;
      default:  // FLT / FLTP
        reinterpret_cast<float*>(fr->data[0])[i] = v;
        break;
    }
  }
}

}  // namespace

extern "C" {

int scl_codec_abi_version() { return 1; }

const char* scl_codec_last_error() { return g_err.c_str(); }

int scl_codec_encoder_available(const char* codec) {
  return find_encoder(codec_id_for(codec)) != nullptr ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Universal decode: any container/codec -> mono float32 at native rate.
// Handle API (decode once, copy out, free).
// ---------------------------------------------------------------------------

void* scl_audio_open(const char* path, long* n_frames, int* sr) {
  av_log_set_level(AV_LOG_ERROR);
  auto* res = new DecodedAudio();
  if (!decode_file(path, res)) {
    delete res;
    return nullptr;
  }
  *n_frames = static_cast<long>(res->samples.size());
  *sr = res->sample_rate;
  return res;
}

void scl_audio_copy(void* handle, float* out) {
  auto* res = static_cast<DecodedAudio*>(handle);
  std::memcpy(out, res->samples.data(), res->samples.size() * sizeof(float));
}

void scl_audio_close(void* handle) { delete static_cast<DecodedAudio*>(handle); }

// ---------------------------------------------------------------------------
// Encode mono float32 -> file. Container picked from the path extension
// (.mp3 / .opus / .ogg / .flac / .wav); codec one of mp3/opus/flac/alaw/
// ulaw/g722/vorbis. bitrate in bits/s (0 = encoder default). Returns 0 on
// success, negative on error (scl_codec_last_error() has the message).
// ---------------------------------------------------------------------------

int scl_audio_encode(const char* path, const float* x, long n, int sr,
                     const char* codec, long bitrate) {
  av_log_set_level(AV_LOG_ERROR);
  const AVCodecID cid = codec_id_for(codec);
  const AVCodec* enc = find_encoder(cid);
  if (enc == nullptr) {
    set_err(std::string("no encoder for ") + (codec ? codec : "<null>"));
    return -1;
  }
  if (!rate_supported(enc, sr)) {
    set_err(std::string("sample rate unsupported by ") + enc->name);
    return -2;
  }

  AVFormatContext* oc = nullptr;
  int err = avformat_alloc_output_context2(&oc, nullptr, nullptr, path);
  if (err < 0 || oc == nullptr) {
    set_err(std::string("cannot infer container for ") + path, err);
    return -3;
  }
  int ret = -4;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  bool io_open = false;
  do {
    AVStream* st = avformat_new_stream(oc, nullptr);
    cc = avcodec_alloc_context3(enc);
    if (st == nullptr || cc == nullptr) {
      set_err("stream/context alloc failed");
      break;
    }
    cc->sample_rate = sr;
    cc->sample_fmt = pick_sample_fmt(enc);
    av_channel_layout_default(&cc->ch_layout, 1);
    cc->time_base = AVRational{1, sr};
    if (bitrate > 0) cc->bit_rate = bitrate;
    if ((oc->oformat->flags & AVFMT_GLOBALHEADER) != 0)
      cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    // native (experimental) encoders, e.g. vorbis without libvorbis
    cc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
    err = avcodec_open2(cc, enc, nullptr);
    if (err < 0) {
      set_err("encoder open failed", err);
      break;
    }
    if (avcodec_parameters_from_context(st->codecpar, cc) < 0) {
      set_err("parameters_from_context failed");
      break;
    }
    st->time_base = cc->time_base;
    if ((oc->oformat->flags & AVFMT_NOFILE) == 0) {
      err = avio_open(&oc->pb, path, AVIO_FLAG_WRITE);
      if (err < 0) {
        set_err(std::string("cannot open output ") + path, err);
        break;
      }
      io_open = true;
    }
    err = avformat_write_header(oc, nullptr);
    if (err < 0) {
      set_err("write_header failed", err);
      break;
    }

    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    const int chunk = cc->frame_size > 0 ? cc->frame_size : 4096;
    bool failed = false;
    auto drain_packets = [&]() -> bool {
      int e;
      while ((e = avcodec_receive_packet(cc, pkt)) == 0) {
        av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(oc, pkt) < 0) {
          set_err("write_frame failed");
          return false;
        }
      }
      if (e != AVERROR(EAGAIN) && e != AVERROR_EOF) {
        set_err("receive_packet failed", e);
        return false;
      }
      return true;
    };
    for (long off = 0; off < n && !failed; off += chunk) {
      const int remain = static_cast<int>(n - off < chunk ? n - off : chunk);
      // keep full frame_size frames (zero-padded tail) — some encoders
      // reject short non-final frames, and a padded final frame only adds
      // trailing silence that the round-trip trims anyway
      fr->nb_samples = chunk;
      fr->format = cc->sample_fmt;
      av_channel_layout_copy(&fr->ch_layout, &cc->ch_layout);
      fr->sample_rate = sr;
      if (av_frame_get_buffer(fr, 0) < 0) {
        set_err("frame buffer alloc failed");
        failed = true;
        break;
      }
      fill_frame(fr, x, off, remain, chunk, cc->sample_fmt);
      fr->pts = off;
      err = avcodec_send_frame(cc, fr);
      av_frame_unref(fr);
      if (err < 0) {
        set_err("send_frame failed", err);
        failed = true;
        break;
      }
      if (!drain_packets()) failed = true;
    }
    if (!failed) {
      avcodec_send_frame(cc, nullptr);  // flush
      if (!drain_packets()) failed = true;
    }
    if (!failed && av_write_trailer(oc) < 0) {
      set_err("write_trailer failed");
      failed = true;
    }
    if (!failed) ret = 0;
  } while (false);
  av_frame_free(&fr);
  av_packet_free(&pkt);
  avcodec_free_context(&cc);
  if (io_open) avio_closep(&oc->pb);
  avformat_free_context(oc);
  return ret;
}

}  // extern "C"
