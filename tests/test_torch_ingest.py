"""The port's ingest measurements (`tpupose_torch.runtime.ingest_bench`) at
a tiny size on the CPU: the fabricated JPEGs are the JAX module's files
byte for byte, and both measurements count every frame once. The rates
themselves come from chip_smoke.py's phase 17 on the card; here they are
only positive. The card routes (nvJPEG) need a card and are not run.
"""
import filecmp
import io

import pytest
import torch

from tpupose.runtime.ingest_bench import fabricate_jpeg_dataset as j_fabricate
from tpupose_torch.runtime import ingest_bench as ib

torch.set_num_threads(1)
SMALL = dict(num_frames=5, num_views=2, width=64, height=48)


@pytest.mark.parametrize("kw", [SMALL, dict(num_frames=3, num_views=3, width=96, height=64,
                                            quality=70, seed=4)])
def test_fabricate_equals_jax(tmp_path, kw):
    got = ib.fabricate_jpeg_dataset(str(tmp_path / "port"), **kw)
    ref = j_fabricate(str(tmp_path / "jax"), **kw)
    assert len(got) == len(ref) == kw["num_frames"]
    for g_row, r_row in zip(got, ref):
        assert len(g_row) == kw["num_views"]
        for g, r in zip(g_row, r_row):
            assert g.replace(str(tmp_path / "port"), "") == r.replace(str(tmp_path / "jax"), "")
            assert filecmp.cmp(g, r, shallow=False), g


def test_fabricate_any_frame_size(tmp_path):
    """A frame size that is no multiple of 16 (the Shelf rig's 1032x776 is
    not); the files repeat every 16 frames, byte for byte."""
    from PIL import Image

    paths = ib.fabricate_jpeg_dataset(str(tmp_path), num_frames=18, num_views=2, width=40,
                                      height=24)
    for row in paths:
        for p in row:
            with Image.open(p) as img:
                assert img.size == (40, 24)
    assert filecmp.cmp(paths[1][1], paths[17][1], shallow=False)
    assert not filecmp.cmp(paths[1][1], paths[2][1], shallow=False)


def test_bench_decode_counts_every_image(tmp_path):
    paths = ib.fabricate_jpeg_dataset(str(tmp_path), **SMALL)
    out = ib.bench_decode(paths, threads_list=(1, 3), prefetch=2)
    assert out["num_images"] == 10
    assert set(out["pillow"]) == {1, 3} and all(r > 0 for r in out["pillow"].values())
    assert out["nvjpeg"] == {} and out["pil"] > 0


@pytest.mark.parametrize("clip", [2, 8])
def test_bench_disk_to_device_delivers_all_frames(tmp_path, clip):
    paths = ib.fabricate_jpeg_dataset(str(tmp_path), **SMALL)
    out = ib.bench_disk_to_device(paths, threads=2, prefetch=2, clip=clip, device="cpu")
    assert out["frames"] == 5 and out["bytes"] == 5 * 2 * 48 * 64 * 3
    assert out["fps"] > 0 and out["gbps"] > 0
    with pytest.raises(ValueError, match="route"):
        ib.bench_disk_to_device(paths, device="cpu", route="bogus")


def test_report_structure():
    buf = io.StringIO()
    res = ib.report(threads_list=(1, 2), file=buf, device="cpu", **SMALL)
    assert set(res) == {"decode", "disk_to_device"}
    assert set(res["disk_to_device"]) == {"pillow"}
    text = buf.getvalue()
    assert "Pillow pool 2 threads" in text and "host CPUs" in text and "disk -> pillow" in text
    assert "-> cpu -> reduce" in text
