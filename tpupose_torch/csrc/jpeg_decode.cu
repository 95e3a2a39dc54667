// Multi-view JPEG decode on the card through nvJPEG, for the frame loader.
//
// Takes the place of the JAX package's host decode in its C++ frame loader
// (`tpupose/runtime/loader.cc`, libjpeg on decode-ahead worker threads),
// which needs libjpeg, where a CUDA toolkit brings nvJPEG. nvJPEG is a
// library decoder, not a kernel of this repository; this file is a plain
// C interface over it, loaded with ctypes like the kernels
// (`tpupose_torch/kernels`), linked with -lnvjpeg.
//
// One call decodes all V views of a frame: `nvjpegDecodeBatched` with
// NVJPEG_OUTPUT_RGBI, straight into a caller-allocated (V, H, W, 3) uint8
// device buffer (a torch tensor) on the caller's stream. Nothing here
// synchronizes: the caller records an event on that stream after the call.
// The caller passes NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION: nvJPEG's
// default replicates subsampled chroma, which libjpeg (the host decoder,
// Pillow) interpolates, and puts 4:2:0 photos tens of levels apart at the
// chroma's edges.
//
// Threading: a handle (`tpj_create`) is shared by the loader's worker
// threads; each worker owns a decoder state (`tpj_state_create`), which
// nvJPEG does not allow two threads to use at once.
//
// Every function returns 0 on success, a positive nvjpegStatus_t from
// nvJPEG, or a negative code: -1 a bad argument, -2 a CUDA error after the
// decode was queued, -3 out of host memory.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <new>

namespace {

struct State {
  nvjpegJpegState_t state = nullptr;
  int batch = 0;
};

}  // namespace

extern "C" {

// nvJPEG handle for `backend` (an nvjpegBackend_t: 0 default, 1 hybrid,
// 2 GPU hybrid, 3 hardware) with nvjpegCreateEx's `flags`. A backend the
// card lacks fails here.
int tpj_create(int backend, unsigned int flags, void** handle) {
  if (handle == nullptr) return -1;
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t st = nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend),
                                     nullptr, nullptr, flags, &h);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  *handle = h;
  return 0;
}

void tpj_destroy(void* handle) {
  if (handle) nvjpegDestroy(static_cast<nvjpegHandle_t>(handle));
}

// A decoder state set up for batches of `batch` images, RGBI output.
int tpj_state_create(void* handle, int batch, void** out) {
  if (handle == nullptr || out == nullptr || batch < 1) return -1;
  State* s = new (std::nothrow) State();
  if (s == nullptr) return -3;
  auto h = static_cast<nvjpegHandle_t>(handle);
  nvjpegStatus_t st = nvjpegJpegStateCreate(h, &s->state);
  if (st == NVJPEG_STATUS_SUCCESS) {
    // max_cpu_threads is unused by current nvJPEG; 1 is the documented value.
    st = nvjpegDecodeBatchedInitialize(h, s->state, batch, 1, NVJPEG_OUTPUT_RGBI);
  }
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (s->state) nvjpegJpegStateDestroy(s->state);
    delete s;
    return static_cast<int>(st);
  }
  s->batch = batch;
  *out = s;
  return 0;
}

void tpj_state_destroy(void* state) {
  State* s = static_cast<State*>(state);
  if (s == nullptr) return;
  if (s->state) nvjpegJpegStateDestroy(s->state);
  delete s;
}

// Width and height of one JPEG, from its header.
int tpj_image_info(void* handle, const unsigned char* data, size_t length,
                   int* width, int* height) {
  if (handle == nullptr || data == nullptr || length == 0) return -1;
  int components = 0;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t sub;
  nvjpegStatus_t st = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data,
                                         length, &components, &sub, widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  *width = widths[0];
  *height = heights[0];
  return 0;
}

// Decode the state's batch of JPEGs (each `width` x `height`, checked by
// the caller) into `out`, (batch, height, width, 3) uint8 on the device,
// on `stream`.
int tpj_decode(void* handle, void* state, const unsigned char* const* data,
               const size_t* lengths, int n, unsigned char* out, int width,
               int height, void* stream) {
  State* s = static_cast<State*>(state);
  if (handle == nullptr || s == nullptr || data == nullptr || lengths == nullptr ||
      out == nullptr || n != s->batch || width < 1 || height < 1) {
    return -1;
  }
  nvjpegImage_t images[64];
  if (n > 64) return -1;
  const size_t pitch = static_cast<size_t>(width) * 3;
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
      images[i].channel[c] = nullptr;
      images[i].pitch[c] = 0;
    }
    images[i].channel[0] = out + static_cast<size_t>(i) * height * pitch;
    images[i].pitch[0] = pitch;
  }
  nvjpegStatus_t st = nvjpegDecodeBatched(static_cast<nvjpegHandle_t>(handle),
                                          s->state, data, lengths, images,
                                          static_cast<cudaStream_t>(stream));
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  return cudaGetLastError() == cudaSuccess ? 0 : -2;
}

}  // extern "C"
