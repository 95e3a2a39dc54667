"""The port's decode-ahead frame loader (`tpupose_torch.runtime.loader`)
and `cli.common.dataset_frame_source` on a fabricated mini-dataset.

The Pillow plain version gives the frames of the JAX package's sequential
source (`tpupose.cli.common.dataset_frame_source(cfg, use_native=False)`)
bit for bit and in order, at any thread count and prefetch depth: the
same decoder on the same files. The card route (nvJPEG) runs only where
there is a card: chip_smoke.py holds it against this plain version. Here,
asking for CUDA without a card raises, and nothing is decoded with Pillow.
"""
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

import tpupose.cli.common as jcommon
from tpupose.data.config import load_config as j_load_config
import tpupose_torch.cli.common as tcommon
from tpupose_torch.data.config import load_config
from tpupose_torch.data.dataset import load_filenames
from tpupose_torch.data.fabricate import fabricate_mini_dataset
from tpupose_torch.cli import convert
from tpupose_torch.runtime import ingest_bench
from tpupose_torch.runtime import loader as tloader
from tpupose_torch.runtime.loader import FrameLoader
from tpupose_torch.utils.timing import StageTimer

torch.set_num_threads(1)
FRAMES = 9


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    root = tmp_path_factory.mktemp("miniloader")
    _, paths = fabricate_mini_dataset(root, num_frames=FRAMES)
    ref = list(jcommon.dataset_frame_source(j_load_config(paths["yaml"]), use_native=False))
    return paths, ref


def _frame_paths(paths):
    return load_filenames(load_config(paths["yaml"]).dataset)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("prefetch", [1, 8])
def test_plain_loader_equals_jax_frames(mini, threads, prefetch):
    paths, ref = mini
    frame_paths = _frame_paths(paths)
    with FrameLoader(frame_paths, prefetch=prefetch, threads=threads) as loader:
        got = list(loader)
        stats = loader.stats()
    assert len(got) == len(ref) == FRAMES
    for frame, (_, _, images, _, _) in zip(got, ref):
        assert isinstance(frame, np.ndarray) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, images)
    assert stats["frames_decoded"] == FRAMES and stats["decode_s"] > 0.0


def test_credit_window_bounds_decode_ahead(mini):
    paths, _ = mini
    with FrameLoader(_frame_paths(paths), prefetch=2, threads=4) as loader:
        next(loader)
        time.sleep(0.3)  # give the workers every chance to run ahead
        stats = loader.stats()
        assert stats["frames_decoded"] <= 1 + 2, stats
        assert stats["credit_wait_s"] > 0.0
        assert len(list(loader)) == FRAMES - 1
    loader = FrameLoader(_frame_paths(paths), prefetch=1, threads=1)
    loader.close()
    with pytest.raises(RuntimeError, match="after close"):
        next(loader)


def test_order_under_thread_churn(mini):
    """More workers than frames in flight, switching threads as often as the
    interpreter allows: frames still come out in index order."""
    paths, ref = mini
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with FrameLoader(_frame_paths(paths), prefetch=2, threads=8) as loader:
            got = list(loader)
    finally:
        sys.setswitchinterval(old)
    for frame, item in zip(got, ref, strict=True):
        np.testing.assert_array_equal(frame, item[2])


@pytest.mark.parametrize("fault", ["missing", "corrupt", "mismatched"])
def test_bad_view_raises_naming_the_paths(mini, tmp_path, fault):
    paths, ref = mini
    root = tmp_path / "copy"
    shutil.copytree(paths["root"], root, ignore=shutil.ignore_patterns("results", "configs"))
    frame_paths = [[p.replace(paths["root"], str(root)) for p in fr]
                   for fr in _frame_paths(paths)]
    bad = frame_paths[4][1]
    if fault == "missing":
        os.remove(bad)
    elif fault == "corrupt":
        with open(bad, "wb") as f:
            f.write(b"\xff\xd8 not a jpeg")
    else:
        from PIL import Image

        Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(bad, format="JPEG")
    with FrameLoader(frame_paths, prefetch=3, threads=2) as loader:
        for t in range(4):
            np.testing.assert_array_equal(next(loader), ref[t][2])
        with pytest.raises(RuntimeError, match="frame 4 decode failed") as e:
            next(loader)
        assert str(frame_paths[4]) in str(e.value)
        np.testing.assert_array_equal(next(loader), ref[5][2])
        assert loader.stats()["frames_decoded"] >= 6


def test_cuda_without_card_raises_and_decodes_nothing(mini, monkeypatch):
    paths, _ = mini

    def no_pillow(*args):
        raise AssertionError("decoded with Pillow")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tloader, "decode_frame_pil", no_pillow)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FrameLoader(_frame_paths(paths), device="cuda")
    cfg = load_config(paths["yaml"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tcommon.dataset_frame_source(cfg, True, None, 4, device="cuda"))
    for use_native in (True, False):  # no device is CUDA, as `Pipeline`'s
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(tcommon.dataset_frame_source(cfg, use_native))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ingest_bench.report(num_frames=1, num_views=1, width=16, height=16)
    with pytest.raises(ValueError, match="unknown nvJPEG backend"):
        tloader.NvJpegDecoder("cuda", "bogus")
    with pytest.raises(ValueError):
        FrameLoader(_frame_paths(paths), prefetch=0)


@pytest.mark.parametrize("use_native", [True, False])
def test_dataset_frame_source_positional(mini, use_native):
    """`(cfg, use_native, timer, prefetch)` as the JAX package's: the same
    frames, ids and timestamps either way; decode_wait per frame, and the
    loader's decode_work per frame decoded."""
    paths, ref = mini
    timer = StageTimer()
    got = list(tcommon.dataset_frame_source(load_config(paths["yaml"]), use_native,
                                            timer, 2, device="cpu"))
    assert len(got) == len(ref)
    for (f1, t1, im1, d1, m1), (f2, t2, im2, _, _) in zip(got, ref):
        assert (f1, t1, d1, m1) == (f2, t2, None, None)
        np.testing.assert_array_equal(im1, im2)
    assert timer.counts["decode_wait"] == FRAMES
    assert timer.counts.get("decode_work", 0) == (FRAMES if use_native else 0)
    assert ("Decode work" in timer.report()) == use_native


def test_dataset_frame_source_early_end_is_descriptive(mini, monkeypatch):
    paths, _ = mini
    real_next = FrameLoader.__next__

    def short(self):
        if self._consumed == 3:
            raise StopIteration
        return real_next(self)

    monkeypatch.setattr(FrameLoader, "__next__", short)
    source = tcommon.dataset_frame_source(load_config(paths["yaml"]), device="cpu")
    with pytest.raises(RuntimeError, match=f"ended after 3 of {FRAMES} frames"):
        list(source)


def test_card_frame_source_refuses_pillow(mini, tmp_path, monkeypatch):
    """Asked for the card, `dataset_frame_source` decodes nothing with
    Pillow: the sequential loop and files nvJPEG cannot read raise before
    a frame is read (a card posed by `is_available`)."""
    def no_pillow(*args):
        raise AssertionError("decoded with Pillow")

    paths, _ = mini
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tloader, "decode_frame_pil", no_pillow)
    monkeypatch.setattr(tcommon, "load_images", no_pillow)
    with pytest.raises(ValueError, match="use_native=False"):
        next(tcommon.dataset_frame_source(load_config(paths["yaml"]), False, device="cuda"))
    _, png = fabricate_mini_dataset(tmp_path, num_frames=2, image_format="png")
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="JPEG files only"):
            next(tcommon.dataset_frame_source(load_config(png["yaml"]), True, device=device))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_convert_int8_decodes_on_its_device(mini, tmp_path, monkeypatch, device):
    """`convert --int8` reads its calibration frames through the loader on
    its resolved `--device`, as `evalmodel --int8` does."""
    class Seen(Exception):
        pass

    def loader(frame_paths, prefetch=4, threads=2, device=None, backend=None):
        raise Seen(device)

    paths, _ = mini
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tloader, "FrameLoader", loader)
    with pytest.raises(Seen) as e:
        convert.main(["--dataset", "MiniCampus", "--config-dir", paths["config_dir"],
                      "--device", device, "--int8", "--int8-calib", "2",
                      "--out", str(tmp_path / "bundle")])
    assert e.value.args[0] == torch.device(device)


def test_png_frames_through_the_pool(tmp_path):
    _, paths = fabricate_mini_dataset(tmp_path, num_frames=3, image_format="png")
    cfg = load_config(paths["yaml"])
    got = list(tcommon.dataset_frame_source(cfg, True, None, 4, device="cpu"))
    ref = list(tcommon.dataset_frame_source(cfg, False, device="cpu"))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[2], b[2])


def test_device_prefetch_passes_card_frames_through(monkeypatch):
    """A CUDA tensor is handed on as it is and at once: no pinned copy, no
    host round trip, not held back `depth` items (here CPU tensors posing
    as CUDA ones); host frames are still copied `depth` ahead, in order."""
    frames = [torch.full((2, 4, 4, 3), i, dtype=torch.uint8) for i in range(4)]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: pytest.fail("pinned"))
    pulled = []

    def source():
        for i, f in enumerate(frames):
            pulled.append(i)
            yield i, i, f, None, None

    out = tcommon.device_prefetch(source(), "cpu", depth=3)
    for i, f in enumerate(frames):
        item = next(out)
        assert item[0] == i and item[2] is f and pulled == list(range(i + 1))
    host = [np.full((2, 4, 4, 3), i, np.uint8) for i in range(2)]
    monkeypatch.undo()
    mixed = [(0, 0, host[0], None, None), (1, 1, host[1], None, None)]
    got = list(tcommon.device_prefetch(iter(mixed), "cpu", depth=3))
    assert [g[0] for g in got] == [0, 1]
    np.testing.assert_array_equal(got[1][2].numpy(), host[1])
