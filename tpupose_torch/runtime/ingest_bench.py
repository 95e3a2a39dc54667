"""Ingest measurements: can the host and the card keep up with decoding?

Counterpart of `tpupose/runtime/ingest_bench.py`. The reference reads
JPEGs from disk inside its timed loop (`src/dataset.py:36-45`); a 5-view
720p frame is 13.8 MB of RGB, so the clip path's frame rate on the card
sets how many decodes a second the loader has to deliver. This module
measures that on fabricated photo-like 720p JPEGs (low-frequency colour
blocks plus texture noise at quality 90, so the files carry realistic
entropy; flat synthetic frames decode unrealistically fast):

* `bench_decode`: images a second through `runtime.loader.FrameLoader`,
  the Pillow pool at each thread count and nvJPEG on the card at each
  backend, beside a sequential Pillow baseline on this thread;
* `bench_disk_to_device`: disk -> loader -> a trivial reduction on the
  device, one batch of frames at a time, synced one batch late so that
  the decode of a batch overlaps the device's work on the one before. The
  Pillow pool's frames reach a CUDA device through pinned memory; nvJPEG's
  are decoded there.

Files just written are read from the page cache, so "disk" here is the
file system's cache, not the drive.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpupose_torch.runtime.loader import BACKENDS, FrameLoader, accepted_backends, decode_view_pil


def fabricate_jpeg_dataset(root, num_frames=32, num_views=5, width=1280,
                           height=720, quality=90, seed=0):
    """Write photo-like JPEGs; returns frame_paths (list over frames of
    per-view path lists), in the dataset layout
    `<root>/Camera<k>/frame_<t>.jpg`."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    frame_paths = []
    # One textured base per view; a per-frame brightness drift keeps the
    # files distinct.
    bases = []
    for v in range(num_views):
        low = rng.normal(128, 40, (height // 16, width // 16, 3))
        low = np.kron(low, np.ones((16, 16, 1)))
        tex = rng.normal(0, 12, (height, width, 3))
        bases.append(low + tex)
        os.makedirs(os.path.join(root, f"Camera{v}"), exist_ok=True)
    for t in range(num_frames):
        row = []
        for v in range(num_views):
            img = np.clip(bases[v] + 2.0 * (t % 16), 0, 255).astype(np.uint8)
            path = os.path.join(root, f"Camera{v}", f"frame_{t:05d}.jpg")
            Image.fromarray(img).save(path, quality=quality)
            row.append(path)
        frame_paths.append(row)
    return frame_paths


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _drain(frame_paths, device=None, **kw):
    """(images, seconds) through a `FrameLoader(frame_paths, device=device,
    **kw)`, timed from its start (its workers begin decoding at once) to
    the device's last decode."""
    count = 0
    start = time.perf_counter()
    with FrameLoader(frame_paths, device=device, **kw) as loader:
        for frame in loader:
            count += frame.shape[0]
        _sync(device)
    return count, time.perf_counter() - start


def bench_decode(frame_paths, threads_list=(1, 2, 4), prefetch=8,
                 use_pil_baseline=True, device=None, backends=tuple(BACKENDS),
                 card_threads=2):
    """Decode every frame through the loader: the Pillow pool at each
    thread count, and, with a CUDA `device`, nvJPEG at each backend with
    `card_threads` reading threads (a backend the card refuses is reported
    by its error).

    Returns {"pillow": {threads: images/s}, "nvjpeg": {backend: images/s
    or "refused: ..."}, "pil": images/s | None, "num_images": N}."""
    n_imgs = len(frame_paths) * len(frame_paths[0])
    out = {"pillow": {}, "nvjpeg": {}, "pil": None, "num_images": n_imgs}
    for th in threads_list:
        count, dt = _drain(frame_paths, prefetch=prefetch, threads=th)
        if count != n_imgs:
            raise RuntimeError(f"the Pillow pool gave {count} of {n_imgs} images")
        out["pillow"][th] = count / dt
    if device is not None and torch.device(device).type == "cuda":
        # the card may lack a backend: report it, measure the rest
        _, refused = accepted_backends(device, backends)
        for backend in backends:
            if backend in refused:
                out["nvjpeg"][backend] = f"refused: {refused[backend]}"
                continue
            count, dt = _drain(frame_paths, device, prefetch=prefetch,
                               threads=card_threads, backend=backend)
            if count != n_imgs:
                raise RuntimeError(f"nvJPEG ({backend}) gave {count} of {n_imgs} images")
            out["nvjpeg"][backend] = count / dt
    if use_pil_baseline:
        start = time.perf_counter()
        count = 0
        for row in frame_paths:
            for p in row:
                decode_view_pil(p)
                count += 1
        out["pil"] = count / (time.perf_counter() - start)
    return out


def bench_disk_to_device(frame_paths, threads=4, prefetch=8, clip=8, device="cuda",
                         route="pillow", backend=None):
    """Disk -> loader -> `device` -> a reduction there, overlapped.

    `route` "pillow": the Pillow pool's frames stacked into pinned memory
    (on a CUDA device) and sent without blocking; "nvjpeg": frames decoded
    on the card. Each `clip`-frame batch's reduction is read one batch
    late, so decoding batch k overlaps the device's work on batch k-1.
    Returns {"fps": frames a second, "gbps": decoded RGB GB a second,
    "bytes": their total, "frames": their count}."""
    device = torch.device(device)
    card = device.type == "cuda"
    kw = {}
    if route == "nvjpeg":
        kw = {"device": device, **({"backend": backend} if backend else {})}
    elif route != "pillow":
        raise ValueError(f"route is 'pillow' or 'nvjpeg', not {route!r}")
    pending = None
    total_frames = total_bytes = 0
    batch = []

    def flush():
        nonlocal pending, total_frames, total_bytes
        if route == "nvjpeg":
            arr = torch.stack(batch)
        else:
            host = torch.from_numpy(np.stack(batch))
            arr = host.pin_memory().to(device, non_blocking=True) if card else host
        total_bytes += arr.numel()
        red = arr[:, :, ::97, ::97, :].to(torch.int32).sum()
        if pending is not None:
            int(pending)  # one batch late
        pending = red
        total_frames += len(batch)
        batch.clear()

    start = time.perf_counter()
    with FrameLoader(frame_paths, prefetch=prefetch, threads=threads, **kw) as loader:
        for frame in loader:
            batch.append(frame)
            if len(batch) == clip:
                flush()
        if batch:
            flush()
        if pending is not None:
            int(pending)
    dt = time.perf_counter() - start
    return {"fps": total_frames / dt, "gbps": total_bytes / dt / 1e9,
            "bytes": total_bytes, "frames": total_frames}


def report(num_frames=32, num_views=5, width=1280, height=720,
           threads_list=(1, 2, 4, 8), root=None, device=None, file=None):
    """Fabricate, run both measurements, print a report; return the dict.
    `device` is resolved as `Pipeline`'s (None is CUDA, which must be
    present). On a CUDA device nvJPEG is measured beside the Pillow pool
    and both routes go disk to device; on the CPU the Pillow pool goes
    disk to the CPU."""
    import shutil
    import sys
    import tempfile

    from tpupose_torch.pipeline.facade import resolve_device

    device = resolve_device(device)

    file = file or sys.stderr
    tmp = root or tempfile.mkdtemp(prefix="tpupose_torch_ingest_")
    try:
        paths = fabricate_jpeg_dataset(tmp, num_frames=num_frames, num_views=num_views,
                                       width=width, height=height)
        dec = bench_decode(paths, threads_list=threads_list, device=device)
        kb = os.path.getsize(paths[0][0]) / 1024
        print(f"ingest: {num_frames} frames x {num_views} views {width}x{height} "
              f"JPEG (~{kb:.0f} KB/img), {os.cpu_count()} host CPUs", file=file)
        for th, rate in dec["pillow"].items():
            print(f"ingest: Pillow pool {th} threads: {rate:7.1f} imgs/s "
                  f"= {rate / num_views:6.1f} multi-view fps", file=file)
        for backend, rate in dec["nvjpeg"].items():
            text = rate if isinstance(rate, str) else (
                f"{rate:7.1f} imgs/s = {rate / num_views:6.1f} multi-view fps")
            print(f"ingest: nvJPEG {backend}: {text}", file=file)
        if dec["pil"] is not None:
            print(f"ingest: Pillow sequential baseline: {dec['pil']:7.1f} imgs/s", file=file)
        results = {"decode": dec, "disk_to_device": {}}
        best_th = max(dec["pillow"], key=dec["pillow"].get)
        routes = [("pillow", None)]
        card_rates = {b: r for b, r in dec["nvjpeg"].items() if not isinstance(r, str)}
        if card_rates:
            routes.append(("nvjpeg", max(card_rates, key=card_rates.get)))
        for route, backend in routes:
            d2d = bench_disk_to_device(paths, threads=best_th, device=device,
                                       route=route, backend=backend)
            results["disk_to_device"][route] = d2d
            print(f"ingest: disk -> {route}{f' ({backend})' if backend else ''} -> "
                  f"{device} -> reduce: {d2d['fps']:6.1f} multi-view fps at "
                  f"{d2d['gbps']:.2f} GB/s of RGB", file=file)
        return results
    finally:
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)
