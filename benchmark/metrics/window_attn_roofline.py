"""The fused window attention's share of its roofline in an HRFormer cell:
the sum of every HRFormer "attention" item's bound (max of its 4 B h T^2 d
operations at the bf16 peak and its q, k, v and output bytes at the
memory's peak; `benchmark/count/hrformer.py`, d the unpadded head dim and
the bytes at the padded maps' token counts) over the profiled frames,
divided by the device time of the fused attention kernels named below
(`tpupose_torch/ops/attention.py`: PyTorch's flash, cuDNN or
memory-efficient attention with the relative position bias as its mask),
read as `vit_attn_roofline` is. None where the cell runs no HRFormer."""
from benchmark.count import ops

INCLUDE = ("flash", "fmha", "attention", "sdpa")


def read(t):
    peaks = ops.peaks_for(t.device_kind)
    items = [i for i in t.work if i["kind"] == "attention" and i["net"] == "hrformer"]
    seconds = t.family_seconds(INCLUDE)
    if peaks is None or not items or not seconds:
        return None
    return 100.0 * t.trace.frames * sum(ops.bound_s(i, peaks) for i in items) / seconds
