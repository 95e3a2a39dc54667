"""Heatmap -> keypoint decoding (top-down pose head).

Counterpart of `tpupose/ops/heatmap.py` and `tpupose/ops/pallas_heatmap.py`.
Heatmaps are NCHW (N, J, H, W), as the port's HRNet emits them, so the
kernel reads them with no transpose.

* `decode_heatmaps` is the plain torch version: per-joint argmax with ties
  to the first row-major index, optional refinement, mapping through the
  crop box.
* `decode_heatmaps_cuda` launches the hand-written kernel
  (`tpupose_torch/csrc/heatmap_decode.cu`) and counts its launches in
  `launches`.
* `decode_heatmaps_auto` is what the pipeline calls: a CPU tensor goes to
  the plain version, a CUDA tensor to the kernel, which raises rather than
  fall back.
"""
from __future__ import annotations

import ctypes

import torch

#: Launches of the CUDA decode kernel (reset freely; read by chip_smoke.py).
launches = 0

_MODES = {False: 0, None: 0, "raw": 0, True: 1, "quarter": 1, "parabolic": 2}


def refine_mode(refine) -> int:
    """0 raw, 1 quarter-offset (True / "quarter"), 2 "parabolic"."""
    try:
        return _MODES[refine]
    except (KeyError, TypeError):
        raise ValueError(f"unknown decode refinement {refine!r}") from None


def _sign(d):
    """jnp.sign: NaN stays NaN (torch.sign(NaN) is 0)."""
    return torch.where(torch.isnan(d), d, torch.sign(d))


def decode_heatmaps(heat, boxes, refine=True):
    """Decode keypoints from heatmaps (plain torch).

    Args:
      heat: (N, J, Hh, Wh) heatmaps (computed in f32).
      boxes: (N, 4) crop boxes (x0, y0, x1, y1) in image coordinates.
      refine: False / "raw", True / "quarter" (official HRNet quarter
        offset toward the stronger neighbour), or "parabolic" (3-point
        parabola vertex per axis, clipped to +-0.5 cell).

    Returns:
      (N, J, 3) keypoints (x_img, y_img, score).
    """
    mode = refine_mode(refine)
    heat = heat.to(torch.float32)
    boxes = boxes.to(torch.float32)
    n, j, hh, wh = heat.shape
    # First row holding the max, then the first column in that row: the
    # first row-major index (torch.argmax returns the first of equal values).
    rowmax = torch.amax(heat, dim=3)  # (N, J, Hh)
    score = torch.amax(rowmax, dim=2)  # (N, J)
    yi = torch.argmax(rowmax, dim=2)
    row = torch.gather(heat, 2, yi[:, :, None, None].expand(n, j, 1, wh))[:, :, 0]
    xi = torch.argmax(row, dim=2)
    px = xi.to(torch.float32)
    py = yi.to(torch.float32)

    if mode:
        col = torch.gather(heat, 3, xi[:, :, None, None].expand(n, j, hh, 1))[..., 0]

        def pick(vals, pos, size):
            return torch.gather(vals, 2, pos.clamp(0, size - 1)[..., None])[..., 0]

        right = pick(row, xi + 1, wh)
        left = pick(row, xi - 1, wh)
        up = pick(col, yi + 1, hh)
        down = pick(col, yi - 1, hh)
        interior = (xi >= 1) & (xi < wh - 1) & (yi >= 1) & (yi < hh - 1)
        zero = torch.zeros_like(px)
        if mode == 2:
            dx = (right - left) / (2.0 * torch.clamp(2.0 * score - right - left, min=1e-6))
            dy = (up - down) / (2.0 * torch.clamp(2.0 * score - up - down, min=1e-6))
            px = px + torch.where(interior, torch.clamp(dx, -0.5, 0.5), zero)
            py = py + torch.where(interior, torch.clamp(dy, -0.5, 0.5), zero)
        else:
            px = px + torch.where(interior, 0.25 * _sign(right - left), zero)
            py = py + torch.where(interior, 0.25 * _sign(up - down), zero)

    x0, y0 = boxes[:, 0:1], boxes[:, 1:2]
    bw = boxes[:, 2:3] - boxes[:, 0:1]
    bh = boxes[:, 3:4] - boxes[:, 1:2]
    # Divide by tensors: on CUDA torch turns division by a Python scalar
    # into a product with its reciprocal, one rounding off the IEEE
    # quotient that JAX and the kernel compute.
    x_img = x0 + px / torch.full_like(px, wh) * bw
    y_img = y0 + py / torch.full_like(py, hh) * bh
    return torch.stack([x_img, y_img, score], dim=-1)


def _kernel():
    from tpupose_torch import kernels

    lib = kernels.library("heatmap_decode")
    fn = lib.tpupose_heatmap_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def decode_heatmaps_cuda(heat, boxes, refine=True):
    """`decode_heatmaps` as one launch of the hand-written CUDA kernel.

    Takes contiguous (N, J, H, W) f32 heatmaps and (N, 4) f32 boxes on one
    CUDA device; raises on anything else and on a failed launch. Launches
    on the current stream and does not synchronize.
    """
    global launches
    mode = refine_mode(refine)
    if heat.device.type != "cuda" or boxes.device != heat.device:
        raise ValueError(f"decode_heatmaps_cuda needs CUDA tensors on one "
                         f"device, got {heat.device} and {boxes.device}")
    if heat.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"decode_heatmaps_cuda needs float32, got "
                        f"{heat.dtype} and {boxes.dtype}")
    if heat.dim() != 4 or boxes.shape != (heat.shape[0], 4):
        raise ValueError(f"decode_heatmaps_cuda needs (N, J, H, W) heatmaps "
                         f"and (N, 4) boxes, got {tuple(heat.shape)} and "
                         f"{tuple(boxes.shape)}")
    if not (heat.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("decode_heatmaps_cuda needs contiguous tensors")
    n, j, h, w = heat.shape
    out = torch.empty((n, j, 3), dtype=torch.float32, device=heat.device)
    if n * j == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(heat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(heat.data_ptr(), boxes.data_ptr(), out.data_ptr(),
                n, j, h, w, mode, stream)
    if rc != 0:
        raise RuntimeError(f"heatmap_decode kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def decode_heatmaps_auto(heat, boxes, refine=True):
    """Decode dispatch for the pipelines: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (raising on failure)."""
    if heat.device.type == "cpu":
        return decode_heatmaps(heat, boxes, refine=refine)
    return decode_heatmaps_cuda(heat, boxes, refine=refine)


def expand_box_to_aspect(boxes, aspect_h_over_w):
    """Grow (N, 4) boxes about their centres to the model aspect (h / w)."""
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    w = x1 - x0
    h = y1 - y0
    cx = (x0 + x1) / 2
    cy = (y0 + y1) / 2
    target_h = torch.maximum(h, w * aspect_h_over_w)
    target_w = target_h / aspect_h_over_w
    return torch.stack(
        [cx - target_w / 2, cy - target_h / 2, cx + target_w / 2, cy + target_h / 2],
        dim=1,
    )
