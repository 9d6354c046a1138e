// framehost — native host-side runtime for retrocapture_tpu.
//
// Host-side equivalents of the reference's performance components:
//  * the capture thread's bounded frame queue with drop-oldest overflow
//    and captureLatestFrame drain-to-newest semantics
//    (src/capture/VideoCaptureRemote.h:182-188, IVideoCapture.h:76);
//  * utils/PixelFormatConverter (BT.601 limited-range YUV->RGB24,
//    NV12/YUYV/UYVY/BGRA, PixelFormatConverter.h:6-9) — the scalar loops
//    are written so -O3 auto-vectorizes them (the reference leans on
//    libswscale SIMD; here the device does conversion in the chain and this
//    host path feeds non-device consumers, tests, and benchmarks);
//  * capture/VideoCaptureTestPattern.cpp:56-102's SMPTE-bar generator.
//
// C ABI so Python binds via ctypes (no pybind11 in the image).

#pragma once

#include <cstddef>
#include <cstdint>

#if defined(_WIN32)
#define RC_API extern "C" __declspec(dllexport)
#else
#define RC_API extern "C" __attribute__((visibility("default")))
#endif

typedef struct rc_ring rc_ring;

// ---- frame ring ----------------------------------------------------------
RC_API rc_ring *rc_ring_create(uint32_t capacity, size_t frame_bytes);
RC_API void rc_ring_destroy(rc_ring *r);
// Copies frame_bytes from data; drops the oldest frame when full.
RC_API void rc_ring_push(rc_ring *r, const uint8_t *data);
// Pops the oldest frame into out. Returns 1 on success, 0 if empty.
RC_API int rc_ring_pop(rc_ring *r, uint8_t *out);
// Drains to the newest frame (captureLatestFrame semantics). Returns the
// number of frames discarded in the drain, or -1 if empty.
RC_API int64_t rc_ring_pop_latest(rc_ring *r, uint8_t *out);
RC_API uint32_t rc_ring_size(const rc_ring *r);
RC_API uint64_t rc_ring_pushed(const rc_ring *r);
RC_API uint64_t rc_ring_dropped(const rc_ring *r);

// ---- pixel-format conversion (BT.601 limited range) ----------------------
RC_API void rc_yuyv_to_rgb24(const uint8_t *src, uint8_t *dst, uint32_t w, uint32_t h);
RC_API void rc_uyvy_to_rgb24(const uint8_t *src, uint8_t *dst, uint32_t w, uint32_t h);
RC_API void rc_nv12_to_rgb24(const uint8_t *y, const uint8_t *uv, uint8_t *dst,
                             uint32_t w, uint32_t h);
RC_API void rc_bgra_to_rgb24(const uint8_t *src, uint8_t *dst, uint32_t w, uint32_t h);
RC_API void rc_rgba_to_rgb24(const uint8_t *src, uint8_t *dst, uint32_t w, uint32_t h);

// ---- test pattern --------------------------------------------------------
// Fills buf (w*h*3 RGB24) with 8 SMPTE bars + a moving marker column.
RC_API void rc_testpattern_fill(uint8_t *buf, uint32_t w, uint32_t h,
                                uint64_t frame_index);
