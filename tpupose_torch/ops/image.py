"""Image ops on the device: batched crop-and-resize, full-frame resize.

Counterpart of `tpupose/ops/image.py`. Images are NHWC. Bilinear
resampling is two matrix products per image, out = W_y @ img @ W_x^T,
with (out, src) weight matrices holding at most two taps per row
(half-pixel centres, edge clamp). A floating image keeps its dtype through
the products (bf16 stays bf16); an integer image is promoted to f32.
"""
from __future__ import annotations

import torch


def _bilinear_weight_matrix(src_coords, src_size):
    """(..., out) source coordinates -> (..., out, src_size) weights."""
    c = torch.clamp(src_coords, 0.0, src_size - 1.0)
    i = torch.arange(src_size, dtype=torch.float32, device=c.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - i), min=0.0)


def _work_dtype(img):
    return img.dtype if img.is_floating_point() else torch.float32


def crop_and_resize(images, boxes, out_hw):
    """Crop boxes from images and resize bilinearly (cv2-style mapping).

    Args:
      images: (N, H, W, C) images, or one (H, W, C) image.
      boxes: (N, K, 4) (x0, y0, x1, y1) boxes per image (or (K, 4) for one
        image); they may exceed the image, sampling edge-clamps.
      out_hw: (out_h, out_w).

    Returns:
      (N, K, out_h, out_w, C) crops (or (K, out_h, out_w, C)).
    """
    single = images.dim() == 3
    if single:
        images, boxes = images[None], boxes[None]
    out_h, out_w = out_hw
    _, h, w, _ = images.shape
    dev = images.device
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    boxes = boxes.to(torch.float32)
    x0, y0 = boxes[..., 0:1], boxes[..., 1:2]
    x1, y1 = boxes[..., 2:3], boxes[..., 3:4]
    ys = y0 + gy * (y1 - y0) - 0.5  # (N, K, out_h)
    xs = x0 + gx * (x1 - x0) - 0.5  # (N, K, out_w)
    dt = _work_dtype(images)
    img = images.to(dt)
    wy = _bilinear_weight_matrix(ys, h).to(dt)  # (N, K, out_h, H)
    wx = _bilinear_weight_matrix(xs, w).to(dt)  # (N, K, out_w, W)
    tmp = torch.einsum("nkoh,nhwc->nkowc", wy, img)
    out = torch.einsum("nkpw,nkowc->nkopc", wx, tmp)
    return out[0] if single else out


def resize_bilinear(image, out_hw):
    """Full-image bilinear resize of (N, H, W, C) or (H, W, C) (half-pixel
    centres, as cv2.resize and jax.image.resize 'bilinear')."""
    batched = image.dim() == 4
    if not batched:
        image = image[None]
    _, h, w, _ = image.shape
    out_h, out_w = out_hw
    dev = image.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
    dt = _work_dtype(image)
    wy = _bilinear_weight_matrix(ys, h).to(dt)
    wx = _bilinear_weight_matrix(xs, w).to(dt)
    tmp = torch.einsum("oh,nhwc->nowc", wy, image.to(dt))
    out = torch.einsum("pw,nowc->nopc", wx, tmp)
    return out if batched else out[0]


def letterbox_resize(image, out_size, fill=0.5):
    """Aspect-preserving resize onto an (out_size, out_size) canvas padded
    with `fill` (darknet letterbox). (N, H, W, C) or (H, W, C)."""
    batched = image.dim() == 4
    if not batched:
        image = image[None]
    n, h, w, c = image.shape
    scale = min(out_size / h, out_size / w)
    nh, nw = round(h * scale), round(w * scale)
    resized = resize_bilinear(image, (nh, nw))
    top = (out_size - nh) // 2
    left = (out_size - nw) // 2
    out = torch.full((n, out_size, out_size, c), fill, dtype=resized.dtype,
                     device=resized.device)
    out[:, top:top + nh, left:left + nw] = resized
    return out if batched else out[0]
