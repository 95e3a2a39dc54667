"""Decode-ahead multi-view JPEG frame loader.

Counterpart of the JAX package's `FrameLoader` (`tpupose/runtime/native.py`
over `loader.cc`): worker threads decode frames ahead of the consumer, at
most `prefetch` frames ahead, and frames come out in index order. Two
routes, chosen by `device`:

* **Plain version (host).** Pillow decodes each view on the worker threads
  (Pillow releases the interpreter lock while it decodes) into a
  (V, H, W, 3) uint8 numpy array, the frames `cli.common`'s sequential
  loader gives. Used when `device` is None or the CPU.
* **Card.** The workers read each frame's files and decode all V views in
  one nvJPEG call (`tpupose_torch/csrc/jpeg_decode.cu`) into a (V, H, W, 3)
  uint8 CUDA tensor, on a stream of the loader's own; the consumer's stream
  waits on an event recorded after the decode, and the tensor is marked as
  used there (`record_stream`), so the caching allocator does not hand its
  memory out again before the consumer's work is done. Used when `device`
  is a CUDA device. A backend the card refuses, a failed build or a failed
  decode raises; nothing gives way to Pillow.

A missing or corrupt file, or a view whose size differs from view 0's,
raises RuntimeError naming that frame's paths when the consumer reaches it.

Nothing of the JAX package's native LAP (`lap.cc`, `native.solve_lap`)
is ported here: `tpupose_torch.ops.lap` solves on the host (its plain
version) and on the card (kernel K3).
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

#: Images decoded by nvJPEG (reset freely; read by chip_smoke.py).
nvjpeg_images = 0
_count_lock = threading.Lock()

#: nvJPEG backends by name (`nvjpegBackend_t`).
BACKENDS = {"default": 0, "hybrid": 1, "gpu_hybrid": 2, "hardware": 3}
#: The card route's backend unless the caller names one: the fastest on
#: the H100 measured (PERF.md: 287-336 images/s at 2 threads, against
#: 233-333 for gpu_hybrid and 265-301 for hybrid; its host refused the
#: hardware backend).
DEFAULT_BACKEND = "default"
#: nvjpegCreateEx flags: NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION (1 << 5).
#: nvJPEG's default replicates the subsampled chroma, where libjpeg (Pillow)
#: interpolates it: on 4:2:0 photo-like JPEGs that put nvJPEG 2.1-4.0
#: levels (mean) and 23-47 (99.9th percentile) from Pillow per channel,
#: and interpolation 0.6-0.8 and 2-3 (H100, PERF.md).
NVJPEG_FLAGS = 1 << 5
#: Views a frame may have on the card route (the C interface's batch cap).
MAX_VIEWS = 64


def decode_view_pil(path) -> np.ndarray:
    """One image as (H, W, 3) uint8 RGB, as `data.dataset.load_images`."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def decode_frame_pil(paths) -> np.ndarray:
    """All views of a frame as (V, H, W, 3) uint8; raises ValueError when a
    view's size differs from view 0's."""
    views = [decode_view_pil(p) for p in paths]
    for p, v in zip(paths[1:], views[1:]):
        if v.shape != views[0].shape:
            raise ValueError(f"{p} is {v.shape[1]}x{v.shape[0]}, view 0 is "
                             f"{views[0].shape[1]}x{views[0].shape[0]}")
    return np.stack(views)


def _library():
    from tpupose_torch import kernels

    lib = kernels.library("jpeg_decode")
    if lib.tpj_decode.argtypes is None:
        vp, i, p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER
        lib.tpj_create.argtypes = [i, ctypes.c_uint, p(vp)]
        lib.tpj_destroy.argtypes = [vp]
        lib.tpj_destroy.restype = None
        lib.tpj_state_create.argtypes = [vp, i, p(vp)]
        lib.tpj_state_destroy.argtypes = [vp]
        lib.tpj_state_destroy.restype = None
        lib.tpj_image_info.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t, p(i), p(i)]
        lib.tpj_decode.argtypes = [vp, vp, p(ctypes.c_char_p), p(ctypes.c_size_t), i,
                                   vp, i, i, vp]
        for fn in (lib.tpj_create, lib.tpj_state_create,
                   lib.tpj_image_info, lib.tpj_decode):
            fn.restype = ctypes.c_int
    return lib


class NvJpegDecoder:
    """An nvJPEG handle for one backend and frames of `views` images, with
    one decoder state for each worker thread (made on its first decode,
    set up for `views` images) and a stream of its own."""

    def __init__(self, device, backend=DEFAULT_BACKEND, views=1):
        if backend not in BACKENDS:
            raise ValueError(f"unknown nvJPEG backend {backend!r}; one of {sorted(BACKENDS)}")
        if not 1 <= views <= MAX_VIEWS:
            raise ValueError(f"{views} views; the card route takes 1 to {MAX_VIEWS}")
        self.device = torch.device(device)
        self.views = int(views)
        self._lib = _library()
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            self._check(self._lib.tpj_create(BACKENDS[backend], NVJPEG_FLAGS,
                                             ctypes.byref(handle)),
                        f"creating an nvJPEG handle for the {backend} backend")
            self.stream = torch.cuda.Stream(self.device)
        self._handle = handle
        self._local = threading.local()
        self._states = []
        self._states_lock = threading.Lock()

    @staticmethod
    def _check(rc, what):
        if rc != 0:
            kind = {-1: "bad argument", -2: "CUDA error", -3: "out of host memory"}.get(
                rc, f"nvjpegStatus_t {rc}")
            raise RuntimeError(f"nvJPEG: {what} failed ({kind})")

    def _state(self):
        state = getattr(self._local, "state", None)
        if state is None:
            state = ctypes.c_void_p()
            self._check(self._lib.tpj_state_create(self._handle, self.views,
                                                   ctypes.byref(state)),
                        f"creating a decoder state for {self.views} images")
            with self._states_lock:
                self._states.append(state)
            self._local.state = state
        return state

    def decode(self, blobs, names):
        """Decode the JPEG bytes `blobs` (one per view, all one size) into a
        (V, H, W, 3) uint8 tensor on the card, on `stream`. Returns the
        tensor and an event recorded after the decode."""
        global nvjpeg_images
        n = len(blobs)
        if n != self.views:
            raise ValueError(f"{n} views, the decoder was set up for {self.views}")
        sizes = []
        for blob, name in zip(blobs, names):
            w, h = ctypes.c_int(), ctypes.c_int()
            self._check(self._lib.tpj_image_info(self._handle, blob, len(blob),
                                                 ctypes.byref(w), ctypes.byref(h)),
                        f"reading the header of {name}")
            sizes.append((w.value, h.value))
        for name, size in zip(names[1:], sizes[1:]):
            if size != sizes[0]:
                raise ValueError(f"{name} is {size[0]}x{size[1]}, view 0 is "
                                 f"{sizes[0][0]}x{sizes[0][1]}")
        width, height = sizes[0]
        data = (ctypes.c_char_p * n)(*blobs)
        lengths = (ctypes.c_size_t * n)(*(len(b) for b in blobs))
        state = self._state()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=self.device)
            self._check(self._lib.tpj_decode(self._handle, state, data, lengths, n,
                                             out.data_ptr(), width, height,
                                             self.stream.cuda_stream),
                        f"decoding {', '.join(names)}")
            done = torch.cuda.Event()
            done.record(self.stream)
        with _count_lock:
            nvjpeg_images += n
        return out, done

    def close(self):
        if self._handle is None:
            return
        self.stream.synchronize()
        for state in self._states:
            self._lib.tpj_state_destroy(state)
        self._states = []
        self._lib.tpj_destroy(self._handle)
        self._handle = None


def accepted_backends(device="cuda", backends=tuple(BACKENDS)):
    """The nvJPEG backends of `backends` that the card of `device` accepts,
    in order, and {backend: error} for those it refuses."""
    accepted, refused = [], {}
    for backend in backends:
        try:
            NvJpegDecoder(device, backend).close()
            accepted.append(backend)
        except RuntimeError as e:
            refused[backend] = str(e)
    return accepted, refused


class _Failed:
    def __init__(self, error):
        self.error = error


class FrameLoader:
    """Decode-ahead multi-view frame loader (the JAX `FrameLoader`'s
    interface: iterate, `stats()`, `close()`).

    frame_paths: list over frames of lists of per-view paths. `threads`
    worker threads decode at most `prefetch` frames ahead of the consumer.
    `device` None or the CPU: the Pillow plain version, numpy frames; a
    CUDA device: nvJPEG with `backend`, CUDA tensors, each ready on the
    stream that is current when the consumer takes it. None is the host
    here, as in the JAX loader; the entry points above it
    (`cli.common.dataset_frame_source`, `ingest_bench.report`) take None
    to mean CUDA, as `Pipeline` does, and pass the loader a device.
    """

    def __init__(self, frame_paths, prefetch=4, threads=2, device=None,
                 backend=DEFAULT_BACKEND):
        if prefetch < 1 or threads < 1:
            raise ValueError(f"prefetch and threads must be >= 1, got {prefetch}, {threads}")
        self._paths = [list(fr) for fr in frame_paths]
        self._prefetch = int(prefetch)
        self.device = None if device is None else torch.device(device)
        self._decoder = None
        if self.device is not None and self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("FrameLoader: CUDA is not available; pass device='cpu' "
                                   "to decode on the host")
            views = len(self._paths[0]) if self._paths else 1
            self._decoder = NvJpegDecoder(self.device, backend, views)
        elif self.device is not None and self.device.type != "cpu":
            raise ValueError(f"FrameLoader decodes on the host or a CUDA device, "
                             f"not {self.device}")
        self._cv = threading.Condition()
        self._claimed = 0       # next frame a worker takes
        self._consumed = 0      # frames handed to the consumer
        self._done = {}         # index -> frame or _Failed, until consumed
        self._stop = False
        self._decode_s = 0.0
        self._credit_wait_s = 0.0
        self._frames_decoded = 0
        self._workers = [threading.Thread(target=self._work, daemon=True,
                                          name=f"FrameLoader-{i}")
                         for i in range(min(threads, max(len(self._paths), 1)))]
        for w in self._workers:
            w.start()

    def _decode(self, paths):
        if self._decoder is None:
            return decode_frame_pil(paths)
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        return self._decoder.decode(blobs, paths)

    def _work(self):
        while True:
            with self._cv:
                if self._stop or self._claimed >= len(self._paths):
                    return
                idx = self._claimed
                self._claimed += 1
                # credit window: at most `prefetch` frames ahead of the consumer
                w0 = time.perf_counter()
                while not self._stop and idx >= self._consumed + self._prefetch:
                    self._cv.wait()
                self._credit_wait_s += time.perf_counter() - w0
                if self._stop:
                    return
            d0 = time.perf_counter()
            try:
                frame = self._decode(self._paths[idx])
            except Exception as e:  # delivered to the consumer at this frame
                frame = _Failed(e)
            with self._cv:
                self._decode_s += time.perf_counter() - d0
                self._frames_decoded += 1
                self._done[idx] = frame
                self._cv.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            if self._stop:
                raise RuntimeError("FrameLoader: next() after close()")
            idx = self._consumed
            if idx >= len(self._paths):
                raise StopIteration
            while idx not in self._done:
                self._cv.wait()
            frame = self._done.pop(idx)
            self._consumed += 1
            self._cv.notify_all()
        if isinstance(frame, _Failed):
            raise RuntimeError(
                f"frame {idx} decode failed (missing/corrupt file or mismatched "
                f"view dimensions: {frame.error}) among views: {self._paths[idx]}"
            ) from frame.error
        if self._decoder is None:
            return frame
        images, done = frame
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        images.record_stream(stream)
        return images

    def stats(self):
        """Worker time: seconds spent decoding and blocked on the credit
        window, and frames decoded (all workers summed)."""
        with self._cv:
            return {"decode_s": self._decode_s, "credit_wait_s": self._credit_wait_s,
                    "frames_decoded": self._frames_decoded}

    def close(self):
        """Stop the workers (a frame being decoded is finished first) and
        release the decoder."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for w in self._workers:
            w.join()
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
