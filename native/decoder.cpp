// Native video decode pump for pyorc_tpu.
//
// Multi-threaded FFmpeg (libavformat/libavcodec/libswscale) decoder exposed
// through a C ABI for ctypes. This is the native replacement for
// the reference's cv2.VideoCapture decode loop (reference
// pyorc/api/video.py:136-211, pyorc/cv.py:876-990): the I/O pump that feeds
// decoded frame batches to the device pipeline. Decoding runs with
// codec-internal threading (thread_count=0 -> auto), and batches are written
// straight into caller-provided buffers (numpy arrays) without extra copies.
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -o libpyorc_decoder.so
//        -lavformat -lavcodec -lavutil -lswscale  (see native/Makefile)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct VideoCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    uint8_t* bgr_scratch = nullptr;  // H*W*3 staging for the gray path
    int stream_idx = -1;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    int64_t n_frames = 0;
    int64_t next_frame = 0;  // next frame number the decoder will produce
    int sws_fmt = -1;        // current swscale target format
    std::string path;
    std::vector<int64_t> pts_index;  // sorted presentation timestamps, one per frame
    bool index_built = false;
    std::string error;
};

// Exact frame index: metadata frame rates lie for VFR sources (e.g. a "5fps"
// mkv whose real spacing differs), so pts*fps frame numbering drifts after a
// seek. One packet scan (no decoding) records every video pts; frame number
// is then the rank of a frame's pts in this sorted table.
void build_index(VideoCtx* ctx) {
    ctx->index_built = true;  // only try once
    AVFormatContext* f = nullptr;
    if (avformat_open_input(&f, ctx->path.c_str(), nullptr, nullptr) < 0) return;
    if (avformat_find_stream_info(f, nullptr) < 0) {
        avformat_close_input(&f);
        return;
    }
    AVPacket* p = av_packet_alloc();
    std::vector<int64_t> v;
    while (av_read_frame(f, p) >= 0) {
        if (p->stream_index == ctx->stream_idx) {
            int64_t ts = p->pts != AV_NOPTS_VALUE ? p->pts : p->dts;
            if (ts != AV_NOPTS_VALUE) v.push_back(ts);
        }
        av_packet_unref(p);
    }
    av_packet_free(&p);
    avformat_close_input(&f);
    std::sort(v.begin(), v.end());
    ctx->pts_index = std::move(v);
    if (!ctx->pts_index.empty()) ctx->n_frames = (int64_t)ctx->pts_index.size();
}

int64_t pts_to_index(const VideoCtx* ctx, int64_t pts) {
    auto it = std::lower_bound(ctx->pts_index.begin(), ctx->pts_index.end(), pts);
    if (it == ctx->pts_index.end()) return (int64_t)ctx->pts_index.size() - 1;
    return (int64_t)(it - ctx->pts_index.begin());
}

// cv2's BGR->GRAY fixed-point weights (imgproc color_lut: R 0.299 G 0.587
// B 0.114 scaled by 2^14 with round-half-up), applied to the same
// swscale-BGR24 pixels cv2's FFMPEG backend produces, so gray frames are
// bit-identical to cv2.cvtColor(cap.read(), COLOR_BGR2GRAY).
inline void bgr_to_gray_cv(const uint8_t* bgr, uint8_t* gray, int64_t n_px) {
    constexpr int kB = 1868, kG = 9617, kR = 4899, kHalf = 1 << 13;
    for (int64_t i = 0; i < n_px; ++i) {
        const uint8_t* p = bgr + i * 3;
        gray[i] = (uint8_t)((p[0] * kB + p[1] * kG + p[2] * kR + kHalf) >> 14);
    }
}

inline void bgr_to_rgb(const uint8_t* bgr, uint8_t* rgb, int64_t n_px) {
    for (int64_t i = 0; i < n_px; ++i) {
        rgb[i * 3 + 0] = bgr[i * 3 + 2];
        rgb[i * 3 + 1] = bgr[i * 3 + 1];
        rgb[i * 3 + 2] = bgr[i * 3 + 0];
    }
}

int64_t pts_to_frame(const VideoCtx* ctx, int64_t pts) {
    AVStream* st = ctx->fmt->streams[ctx->stream_idx];
    double sec = pts * av_q2d(st->time_base);
    return (int64_t)(sec * ctx->fps + 0.5);
}

}  // namespace

extern "C" {

void* vd_open(const char* path) {
    auto* ctx = new VideoCtx();
    ctx->path = path;
    if (avformat_open_input(&ctx->fmt, path, nullptr, nullptr) < 0) {
        delete ctx;
        return nullptr;
    }
    if (avformat_find_stream_info(ctx->fmt, nullptr) < 0) {
        avformat_close_input(&ctx->fmt);
        delete ctx;
        return nullptr;
    }
    const AVCodec* dec = nullptr;
    ctx->stream_idx = av_find_best_stream(ctx->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (ctx->stream_idx < 0 || dec == nullptr) {
        avformat_close_input(&ctx->fmt);
        delete ctx;
        return nullptr;
    }
    AVStream* st = ctx->fmt->streams[ctx->stream_idx];
    ctx->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(ctx->codec, st->codecpar);
    ctx->codec->thread_count = 0;  // auto: frame+slice threading
    ctx->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(ctx->codec, dec, nullptr) < 0) {
        avcodec_free_context(&ctx->codec);
        avformat_close_input(&ctx->fmt);
        delete ctx;
        return nullptr;
    }
    ctx->width = ctx->codec->width;
    ctx->height = ctx->codec->height;
    AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    ctx->fps = fr.den ? av_q2d(fr) : 0.0;
    ctx->n_frames = st->nb_frames;
    if (ctx->n_frames <= 0 && ctx->fps > 0 && ctx->fmt->duration > 0) {
        ctx->n_frames = (int64_t)(ctx->fmt->duration / (double)AV_TIME_BASE * ctx->fps + 0.5);
    }
    ctx->frame = av_frame_alloc();
    ctx->pkt = av_packet_alloc();
    ctx->next_frame = 0;
    return ctx;
}

// presentation timestamps (ms) for every frame, from the pts index (one
// packet scan, no decoding). Returns frames written (<= max_n), <0 on error.
int64_t vd_timestamps(void* handle, double* out_ms, int64_t max_n) {
    auto* ctx = static_cast<VideoCtx*>(handle);
    if (!ctx) return -1;
    if (!ctx->index_built) build_index(ctx);
    if (ctx->pts_index.empty()) return -1;
    AVStream* st = ctx->fmt->streams[ctx->stream_idx];
    double tb_ms = av_q2d(st->time_base) * 1000.0;
    // cv2's POS_MSEC is relative to the stream start; match that convention
    int64_t t0 = st->start_time != AV_NOPTS_VALUE ? st->start_time : 0;
    int64_t n = (int64_t)ctx->pts_index.size();
    if (n > max_n) n = max_n;
    for (int64_t i = 0; i < n; ++i) out_ms[i] = (ctx->pts_index[i] - t0) * tb_ms;
    return n;
}

int vd_meta(void* handle, double* fps, int64_t* n_frames, int* w, int* h) {
    auto* ctx = static_cast<VideoCtx*>(handle);
    if (!ctx) return -1;
    *fps = ctx->fps;
    *n_frames = ctx->n_frames;
    *w = ctx->width;
    *h = ctx->height;
    return 0;
}

// decode `count` frames starting at frame number `start`; gray!=0 -> GRAY8
// (H*W bytes/frame), else RGB24 (H*W*3). Returns frames written, <0 on error.
int64_t vd_read(void* handle, int64_t start, int64_t count, int gray, uint8_t* out) {
    auto* ctx = static_cast<VideoCtx*>(handle);
    if (!ctx) return -1;
    AVStream* st = ctx->fmt->streams[ctx->stream_idx];

    if (start != ctx->next_frame) {
        // seek to the keyframe at/before start, then roll forward; the pts
        // index (built lazily on first seek) gives exact targets/numbering
        if (!ctx->index_built) build_index(ctx);
        int64_t ts;
        if (!ctx->pts_index.empty()) {
            int64_t i = start < (int64_t)ctx->pts_index.size() ? start : (int64_t)ctx->pts_index.size() - 1;
            ts = ctx->pts_index[i];
        } else {
            ts = (int64_t)((start / ctx->fps) / av_q2d(st->time_base));
        }
        if (av_seek_frame(ctx->fmt, ctx->stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
            avcodec_flush_buffers(ctx->codec);
            ctx->next_frame = -1;  // unknown until first decoded frame
        }
    }

    const int target_fmt = gray ? AV_PIX_FMT_GRAY8 : AV_PIX_FMT_RGB24;
    const int64_t frame_bytes = (int64_t)ctx->width * ctx->height * (gray ? 1 : 3);
    int64_t written = 0;

    while (written < count) {
        int ret = av_read_frame(ctx->fmt, ctx->pkt);
        bool flushing = false;
        if (ret < 0) {
            // EOF: flush decoder
            avcodec_send_packet(ctx->codec, nullptr);
            flushing = true;
        } else if (ctx->pkt->stream_index != ctx->stream_idx) {
            av_packet_unref(ctx->pkt);
            continue;
        } else {
            avcodec_send_packet(ctx->codec, ctx->pkt);
            av_packet_unref(ctx->pkt);
        }
        while (true) {
            int r = avcodec_receive_frame(ctx->codec, ctx->frame);
            if (r < 0) break;
            int64_t fno;
            if (ctx->next_frame < 0) {
                int64_t pts = ctx->frame->best_effort_timestamp;
                if (pts == AV_NOPTS_VALUE) {
                    fno = start;
                } else if (!ctx->pts_index.empty()) {
                    fno = pts_to_index(ctx, pts);
                } else {
                    fno = pts_to_frame(ctx, pts);
                }
            } else {
                fno = ctx->next_frame;
            }
            ctx->next_frame = fno + 1;
            if (fno < start) {
                av_frame_unref(ctx->frame);
                continue;
            }
            if (fno >= start + count) {
                av_frame_unref(ctx->frame);
                return written;
            }
            // Always convert via BGR24 + SWS_BICUBIC — the exact pipeline
            // cv2's FFMPEG VideoCapture backend uses (and swscale's fastest
            // unscaled YUV->packed path; RGB24 is ~5x slower in this build).
            // Gray frames are then derived with cv2's own BGR->GRAY
            // fixed-point weights; RGB output is a channel swap.
            if (ctx->sws == nullptr || ctx->sws_fmt != target_fmt) {
                if (ctx->sws) sws_freeContext(ctx->sws);
                ctx->sws = sws_getContext(
                    ctx->width, ctx->height, (AVPixelFormat)ctx->frame->format,
                    ctx->width, ctx->height, AV_PIX_FMT_BGR24,
                    SWS_BICUBIC, nullptr, nullptr, nullptr);
                ctx->sws_fmt = target_fmt;
            }
            uint8_t* frame_out = out + (fno - start) * frame_bytes;
            if (!ctx->bgr_scratch)
                ctx->bgr_scratch = new uint8_t[(size_t)ctx->width * ctx->height * 3];
            uint8_t* dst_data[4] = {ctx->bgr_scratch, nullptr, nullptr, nullptr};
            int dst_linesize[4] = {ctx->width * 3, 0, 0, 0};
            sws_scale(ctx->sws, ctx->frame->data, ctx->frame->linesize, 0, ctx->height,
                      dst_data, dst_linesize);
            if (gray)
                bgr_to_gray_cv(ctx->bgr_scratch, frame_out, (int64_t)ctx->width * ctx->height);
            else
                bgr_to_rgb(ctx->bgr_scratch, frame_out, (int64_t)ctx->width * ctx->height);
            av_frame_unref(ctx->frame);
            written++;
            if (written >= count) return written;
        }
        if (flushing) break;
    }
    return written;
}

void vd_close(void* handle) {
    auto* ctx = static_cast<VideoCtx*>(handle);
    if (!ctx) return;
    if (ctx->sws) sws_freeContext(ctx->sws);
    delete[] ctx->bgr_scratch;
    if (ctx->frame) av_frame_free(&ctx->frame);
    if (ctx->pkt) av_packet_free(&ctx->pkt);
    if (ctx->codec) avcodec_free_context(&ctx->codec);
    if (ctx->fmt) avformat_close_input(&ctx->fmt);
    delete ctx;
}

// ---------------------------------------------------------------------------
// Native H.264 encoder (libx264 via libavcodec). Replaces the reference's
// cv2.VideoWriter (reference pyorc/api/frames.py:537-607 `to_video`) and
// backs the synthetic-video velocity-parity harness (H.264 round-trip keeps
// the real decode path in the test loop).

struct EncCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    AVStream* stream = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    SwsContext* sws = nullptr;
    int width = 0;
    int height = 0;
    int channels = 1;  // 1 = gray input, 3 = rgb input
    int64_t next_pts = 0;
    std::string error;
};

int enc_drain(EncCtx* ctx) {
    while (true) {
        int ret = avcodec_receive_packet(ctx->codec, ctx->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
        if (ret < 0) return ret;
        av_packet_rescale_ts(ctx->pkt, ctx->codec->time_base, ctx->stream->time_base);
        ctx->pkt->stream_index = ctx->stream->index;
        ret = av_interleaved_write_frame(ctx->fmt, ctx->pkt);
        av_packet_unref(ctx->pkt);
        if (ret < 0) return ret;
    }
}

void* ve_open(const char* path, int width, int height, double fps, int channels, int crf) {
    auto* ctx = new EncCtx();
    ctx->width = width;
    ctx->height = height;
    ctx->channels = channels == 3 ? 3 : 1;
    const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_H264);
    if (!codec) {
        delete ctx;
        return nullptr;
    }
    if (avformat_alloc_output_context2(&ctx->fmt, nullptr, nullptr, path) < 0 || !ctx->fmt) {
        delete ctx;
        return nullptr;
    }
    ctx->codec = avcodec_alloc_context3(codec);
    ctx->codec->width = width;
    ctx->codec->height = height;
    // rational fps: exact for integers, close enough otherwise
    AVRational tb = av_d2q(1.0 / (fps > 0 ? fps : 25.0), 1 << 16);
    ctx->codec->time_base = tb;
    ctx->codec->framerate = AVRational{tb.den, tb.num};
    ctx->codec->pix_fmt = AV_PIX_FMT_YUV420P;
    ctx->codec->gop_size = 30;
    ctx->codec->thread_count = 0;
    if (ctx->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        ctx->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    AVDictionary* opts = nullptr;
    char crf_s[8];
    snprintf(crf_s, sizeof crf_s, "%d", crf >= 0 ? crf : 18);
    av_dict_set(&opts, "crf", crf_s, 0);
    av_dict_set(&opts, "preset", "fast", 0);
    if (avcodec_open2(ctx->codec, codec, &opts) < 0) {
        av_dict_free(&opts);
        avcodec_free_context(&ctx->codec);
        avformat_free_context(ctx->fmt);
        delete ctx;
        return nullptr;
    }
    av_dict_free(&opts);
    ctx->stream = avformat_new_stream(ctx->fmt, nullptr);
    ctx->stream->time_base = ctx->codec->time_base;
    avcodec_parameters_from_context(ctx->stream->codecpar, ctx->codec);
    if (!(ctx->fmt->oformat->flags & AVFMT_NOFILE)) {
        if (avio_open(&ctx->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
            avcodec_free_context(&ctx->codec);
            avformat_free_context(ctx->fmt);
            delete ctx;
            return nullptr;
        }
    }
    if (avformat_write_header(ctx->fmt, nullptr) < 0) {
        avcodec_free_context(&ctx->codec);
        avformat_free_context(ctx->fmt);
        delete ctx;
        return nullptr;
    }
    ctx->frame = av_frame_alloc();
    ctx->frame->format = AV_PIX_FMT_YUV420P;
    ctx->frame->width = width;
    ctx->frame->height = height;
    av_frame_get_buffer(ctx->frame, 0);
    ctx->pkt = av_packet_alloc();
    ctx->sws = sws_getContext(width, height,
                              ctx->channels == 3 ? AV_PIX_FMT_RGB24 : AV_PIX_FMT_GRAY8,
                              width, height, AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                              nullptr, nullptr, nullptr);
    return ctx;
}

// Write one frame (uint8, H*W for gray or H*W*3 for rgb). Returns 0 on ok.
int ve_write(void* handle, const uint8_t* data) {
    auto* ctx = static_cast<EncCtx*>(handle);
    if (!ctx) return -1;
    if (av_frame_make_writable(ctx->frame) < 0) return -2;
    const uint8_t* src_data[4] = {data, nullptr, nullptr, nullptr};
    int src_linesize[4] = {ctx->width * ctx->channels, 0, 0, 0};
    sws_scale(ctx->sws, src_data, src_linesize, 0, ctx->height, ctx->frame->data,
              ctx->frame->linesize);
    ctx->frame->pts = ctx->next_pts++;
    if (avcodec_send_frame(ctx->codec, ctx->frame) < 0) return -3;
    return enc_drain(ctx);
}

// Flush, write trailer, free. Returns 0 on ok.
int ve_close(void* handle) {
    auto* ctx = static_cast<EncCtx*>(handle);
    if (!ctx) return -1;
    int rc = 0;
    if (ctx->codec) {
        avcodec_send_frame(ctx->codec, nullptr);
        rc = enc_drain(ctx);
        av_write_trailer(ctx->fmt);
    }
    if (ctx->sws) sws_freeContext(ctx->sws);
    if (ctx->frame) av_frame_free(&ctx->frame);
    if (ctx->pkt) av_packet_free(&ctx->pkt);
    if (ctx->codec) avcodec_free_context(&ctx->codec);
    if (ctx->fmt) {
        if (!(ctx->fmt->oformat->flags & AVFMT_NOFILE) && ctx->fmt->pb) avio_closep(&ctx->fmt->pb);
        avformat_free_context(ctx->fmt);
    }
    delete ctx;
    return rc;
}

}  // extern "C"
