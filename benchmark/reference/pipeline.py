"""The reference's stage A: the two networks in float32, or as integer
networks whose scales it calibrates itself, over the frames the benchmark
made, with the weights regenerated from the run's weight seed.

Nothing here comes from the program: the weights are drawn again
(`nets.make_state_dict`, the same draws the program was handed), folded
again, and an integer network's scales are worked out again from the
calibration frames. It runs with TF32 off.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark.reference import nets, quant, stage_a


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_weights(config, weight_seed, device):
    """The unfolded state_dicts of the detector and the pose net, in that
    order from one generator: what the program is handed."""
    det, pose = config["detector"], config["pose"]
    gen = torch.Generator(device=device).manual_seed(weight_seed)
    ysd = nets.make_state_dict(nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0)),
                               gen, device)
    hsd = nets.make_state_dict(nets.hrnet_specs(**nets.hrnet_kwargs(pose)), gen, device)
    return ysd, hsd


class Reference:
    """Stage A of `config` in float32 (`bits=None`) or with `bits`-bit
    integer convs calibrated on `calib` ((N, H, W, 3) uint8 frames): every
    conv but the detector's heads and the heatmap layer, as the int8
    configuration serves them."""

    def __init__(self, config, weight_seed, device, bits=None, calib=None, block=8):
        self.cfg = config
        self.block = block
        det, pose = config["detector"], config["pose"]
        self.yspecs = nets.yolo_specs(det["num_classes"], det.get("width_mult", 1.0))
        self.hspecs = nets.hrnet_specs(**nets.hrnet_kwargs(pose))
        self.hkw = nets.hrnet_forward_kwargs(pose)
        ysd, hsd = make_weights(config, weight_seed, device)
        self.yfold, self.hfold = nets.fold(self.yspecs, ysd), nets.fold(self.hspecs, hsd)
        del ysd, hsd
        self.yconv = nets.float_conv(self.yspecs, self.yfold)
        self.hconv = nets.float_conv(self.hspecs, self.hfold)
        if bits is not None:
            self._quantize(bits, calib)

    def _quantize(self, bits, calib):
        yq = {s.name for s in self.yspecs if s.bn is not None}
        hq = {s.name for s in self.hspecs if s.name != "final_layer"}
        with torch.no_grad(), no_tf32():
            x = self.yolo_input(calib)
            ya = quant.calibrate(nets.yolo_forward, self.yconv, x, yq)
            boxes, _, _ = self.detect(nets.yolo_forward(self.yconv, x), calib.shape[1:3])
            crops, _ = self.crops(calib, boxes)
            ha = quant.calibrate(lambda c, t: nets.hrnet_forward(c, t, **self.hkw),
                                 self.hconv, crops, hq)
        self.yconv = quant.quantized_conv(self.yspecs, self.yfold, ya, bits)
        self.hconv = quant.quantized_conv(self.hspecs, self.hfold, ha, bits)

    def yolo_input(self, images):
        s = self.cfg["detector"]["input_size"]
        x = stage_a.resize(images.float() / 255.0, (s, s))
        return x.permute(0, 3, 1, 2).contiguous()

    def yolo_heads(self, images):
        """(N, H, W, 3) uint8 -> the three raw heads."""
        with torch.no_grad(), no_tf32():
            outs = [nets.yolo_forward(self.yconv, self.yolo_input(images[i:i + self.block]))
                    for i in range(0, len(images), self.block)]
        return [torch.cat(h) for h in zip(*outs)]

    def detect(self, heads, image_hw):
        """Heads -> (N, K, 4) boxes in image pixels, (N, K) scores and valid flags."""
        d = self.cfg["detector"]
        boxes, scores = stage_a.decode_heads(heads, d["input_size"], d["num_classes"])
        return stage_a.select(boxes, scores, d["max_candidates"], d["score_thresh"],
                              d["nms_thresh"], image_hw, d["input_size"])

    def crops(self, images, boxes):
        """(N, K, h, w) normalized NCHW crops of the boxes grown to the pose
        net's aspect, and those (N * K, 4) boxes."""
        ph, pw = self.cfg["pose"]["input_size"]
        eboxes = stage_a.expand_to_aspect(boxes, ph / pw)
        c = stage_a.normalize(stage_a.crop(images.float() / 255.0, eboxes, (ph, pw)))
        return c.reshape(-1, ph, pw, 3).permute(0, 3, 1, 2).contiguous(), eboxes.reshape(-1, 4)

    def heatmaps(self, images, boxes):
        """(N * K, J, h, w) heatmaps of the crops at `boxes`, and their boxes."""
        outs, eb = [], []
        with torch.no_grad(), no_tf32():
            for i in range(0, len(images), self.block):
                c, e = self.crops(images[i:i + self.block], boxes[i:i + self.block])
                outs.append(nets.hrnet_forward(self.hconv, c, **self.hkw))
                eb.append(e)
        return torch.cat(outs), torch.cat(eb)

    def outputs(self, images):
        """Its own stage A end to end: (heads, (N, K, J, 3) keypoints, (N, K) valid)."""
        heads = self.yolo_heads(images)
        boxes, _, valid = self.detect(heads, images.shape[1:3])
        heat, eboxes = self.heatmaps(images, boxes)
        kps = stage_a.decode_heatmaps(heat, eboxes)
        return heads, kps.reshape(*valid.shape, *kps.shape[1:]), valid
