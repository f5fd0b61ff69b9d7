// Native media kernels of the artalk_tpu_torch host runtime: the port's own
// copy of artalk_tpu/runtime/native/media.cpp, kept identical in arithmetic so
// that both libraries, built with the same g++ flags on one host, give the
// same bytes and samples.
//
// The reference leans on external native code for all media work (FFmpeg/libav
// via PyAV, app/utils_videos.py). This library provides the equivalent
// host-side primitives natively so the port has a video path even without
// PyAV/ffmpeg:
//
//   - rgb_to_yuv420: BT.601 full-swing RGB -> planar YUV 4:2:0 (the pixel
//     format of the reference's H.264 output), vectorizable inner loops.
//   - write_y4m: stream frames into a YUV4MPEG2 file (playable by
//     mpv/ffplay/VLC without any codec).
//   - resample_poly_f32: rational polyphase resampling with a windowed-sinc
//     kernel (audio ingest, torchaudio-Resample equivalent).
//
// Exposed with a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// RGB (T, H, W, 3) uint8 -> planar YUV420 (BT.601 full range).
// y_out: (T, H, W), u_out/v_out: (T, H/2, W/2). H and W must be even.
void rgb_to_yuv420(const uint8_t* rgb, int64_t t, int64_t h, int64_t w,
                   uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int64_t frame_px = h * w;
  const int64_t chroma_w = w / 2, chroma_h = h / 2;
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* src = rgb + f * frame_px * 3;
    uint8_t* yp = y_out + f * frame_px;
    uint8_t* up = u_out + f * chroma_h * chroma_w;
    uint8_t* vp = v_out + f * chroma_h * chroma_w;
    for (int64_t i = 0; i < frame_px; ++i) {
      const float r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
      float y = 0.299f * r + 0.587f * g + 0.114f * b;
      yp[i] = (uint8_t)(y < 0 ? 0 : (y > 255 ? 255 : y + 0.5f));
    }
    // chroma: average 2x2 blocks, then convert
    for (int64_t cy = 0; cy < chroma_h; ++cy) {
      for (int64_t cx = 0; cx < chroma_w; ++cx) {
        float r = 0, g = 0, b = 0;
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const uint8_t* p = src + 3 * ((2 * cy + dy) * w + 2 * cx + dx);
            r += p[0]; g += p[1]; b += p[2];
          }
        }
        r *= 0.25f; g *= 0.25f; b *= 0.25f;
        float u = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.0f;
        float v = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.0f;
        up[cy * chroma_w + cx] = (uint8_t)(u < 0 ? 0 : (u > 255 ? 255 : u + 0.5f));
        vp[cy * chroma_w + cx] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
      }
    }
  }
}

// Write a YUV4MPEG2 stream. fps is expressed as a rational fps_num/fps_den.
// Returns 0 on success.
int write_y4m(const char* path, const uint8_t* rgb, int64_t t, int64_t h,
              int64_t w, int fps_num, int fps_den) {
  if (h % 2 || w % 2) return -2;
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  fprintf(fp, "YUV4MPEG2 W%lld H%lld F%d:%d Ip A1:1 C420jpeg\n",
          (long long)w, (long long)h, fps_num, fps_den);
  const int64_t frame_px = h * w;
  const int64_t chroma = frame_px / 4;
  std::vector<uint8_t> y(frame_px), u(chroma), v(chroma);
  for (int64_t f = 0; f < t; ++f) {
    rgb_to_yuv420(rgb + f * frame_px * 3, 1, h, w, y.data(), u.data(), v.data());
    fputs("FRAME\n", fp);
    fwrite(y.data(), 1, frame_px, fp);
    fwrite(u.data(), 1, chroma, fp);
    fwrite(v.data(), 1, chroma, fp);
  }
  fclose(fp);
  return 0;
}

// Rational polyphase resampler: in (n,) float32 at rate `down` -> out at
// rate `up`/`down` of the input rate. Kaiser-windowed sinc, zero-phase.
// out must have ceil(n * up / down) elements. Returns output length.
int64_t resample_poly_f32(const float* in, int64_t n, int up, int down,
                          float* out) {
  if (up == down) {
    memcpy(out, in, n * sizeof(float));
    return n;
  }
  const int max_rate = up > down ? up : down;
  const float cutoff = 0.5f / max_rate;     // normalized to the upsampled rate
  const int half_len = 10 * max_rate;       // 10 taps per phase (scipy default)
  const int64_t filt_len = 2 * half_len + 1;

  // Kaiser beta=5.0 window (scipy resample_poly default)
  const float beta = 5.0f;
  auto bessel_i0 = [](float x) {
    float sum = 1.0f, term = 1.0f;
    for (int k = 1; k < 25; ++k) {
      term *= (x / (2.0f * k)) * (x / (2.0f * k));
      sum += term;
    }
    return sum;
  };
  const float i0b = bessel_i0(beta);
  std::vector<float> filt(filt_len);
  for (int64_t i = 0; i < filt_len; ++i) {
    const float m = (float)(i - half_len);
    const float x = 2.0f * cutoff * m;
    const float sinc = (m == 0.0f) ? 1.0f : sinf((float)M_PI * x) / ((float)M_PI * x);
    const float r = m / half_len;
    const float win = bessel_i0(beta * sqrtf(1.0f - r * r)) / i0b;
    filt[i] = 2.0f * cutoff * (float)up * sinc * win;
  }

  const int64_t out_len = (n * up + down - 1) / down;
  for (int64_t j = 0; j < out_len; ++j) {
    // output sample j corresponds to upsampled index j*down; filter is
    // centered at half_len
    const int64_t center = j * down;
    double acc = 0.0;
    // contributing input samples i satisfy: up*i in [center-half_len, center+half_len]
    int64_t i_lo = (center - half_len + up - 1) / up;
    int64_t i_hi = (center + half_len) / up;
    if (i_lo < 0) i_lo = 0;
    if (i_hi >= n) i_hi = n - 1;
    for (int64_t i = i_lo; i <= i_hi; ++i) {
      const int64_t tap = center - i * up + half_len;
      acc += (double)in[i] * (double)filt[tap];
    }
    out[j] = (float)acc;
  }
  return out_len;
}

}  // extern "C"
