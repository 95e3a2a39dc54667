"""Serving bundles of the port (`tpupose_torch.cli.convert`, `--bundle` in
the CLIs) against the JAX package's (`tpupose.cli.convert`).

A bundle holds the BN-folded serving modules' state_dicts and the JAX
package's `bundle.json` manifest. The CLI tests run on one mini-dataset
that `tpupose.data.fabricate.fabricate_mini_dataset(with_weights=True)`
writes (3 views of 10 rendered 720x1280 JPEG frames, tiny random
checkpoints in the published formats), as tests/test_torch_cli.py does.

Tolerances and why:
* A bundle restores every tensor `torch.equal` to what was written, and a
  pipeline served from it gives the direct run's pkl exactly: the same
  tensors through the same program. An int8 bundle equals the in-process
  quantization on the same frames for the same reason.
* The port's bf16 bundle against the JAX package's restored arrays: equal
  but for one bf16 step (relative 2^-7) on at most 1e-4 of the values,
  the BN-folding difference of tests/test_torch_cli.py (XLA's f32 rsqrt on
  the CPU is one ulp off the correctly rounded one).
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import jax
import pytest
import torch

import tpupose.cli.common as jcommon
from tpupose.cli import convert as jconvert
from tpupose.data.config import load_config as j_load_config
from tpupose.data.fabricate import fabricate_mini_dataset
import tpupose_torch.models.convert as tconv
from tpupose_torch.cli import convert, evalmodel, testmodel
from tpupose_torch.models import layers as tl
from tpupose_torch.models import quantize as tq
from tpupose_torch.models.convert import state_dict_from_jax
from tpupose_torch.models.hrnet import hrnet_init, tiny_test_config
from tpupose_torch.models.yolov3 import tiny_yolo_test_config, yolov3_init
from tpupose_torch.pipeline.facade import Pipeline

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
CONVERTERS = ("load_darknet_weights", "read_darknet_file", "darknet_array_to_state_dict",
              "load_hrnet_torch_checkpoint")


def _tiny_models(kind):
    gen = torch.Generator().manual_seed(0)
    det_cfg, pose_cfg = tiny_yolo_test_config(), tiny_test_config()
    detector = tl.fold_batchnorm(yolov3_init(det_cfg, gen), dtype=torch.bfloat16)
    pose = tl.fold_batchnorm(hrnet_init(pose_cfg, gen), dtype=torch.bfloat16)
    if kind == "int8":
        x = torch.rand((2, 3, *pose_cfg.input_size), generator=gen)
        pose = tq.quantize_hrnet(pose, pose_cfg, x)
        s = det_cfg.input_size
        detector = tq.quantize_yolo(detector, det_cfg, torch.rand((2, 3, s, s), generator=gen))
    if kind == "packed":
        from tpupose_torch.ops.packing import pack_hrnet_branch0

        pose = pack_hrnet_branch0(pose)
        pose_cfg = pose.cfg
    return det_cfg, detector, pose_cfg, pose


def _assert_modules_equal(got, ref):
    sd_got, sd_ref = got.state_dict(), ref.state_dict()
    assert sd_got.keys() == sd_ref.keys()
    for k, v in sd_ref.items():
        assert sd_got[k].dtype == v.dtype and torch.equal(sd_got[k], v), k
    for (name, m), (_, r) in zip(got.named_modules(), ref.named_modules()):
        assert type(m) is type(r), name


@pytest.mark.parametrize("kind", ["bf16", "int8", "packed"])
def test_bundle_round_trip(tmp_path, kind):
    det_cfg, detector, pose_cfg, pose = _tiny_models(kind)
    out = str(tmp_path / "bundle")
    manifest = convert.write_bundle(out, det_cfg, detector, pose_cfg, pose,
                                    dtype="int8" if kind == "int8" else "bfloat16",
                                    quantized=kind == "int8")
    assert convert.read_manifest(out) == manifest
    assert sorted(os.listdir(out)) == ["bundle.json", "det.pt", "pose.pt"]
    det_r, pose_r = convert.load_bundle(out, det_cfg, pose_cfg)
    _assert_modules_equal(det_r, detector)
    _assert_modules_equal(pose_r, pose)
    x = torch.rand((2, 3, *pose_cfg.input_size), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(pose_r(x), pose(x))
    if kind == "int8":  # the kernels' weight layout is rebuilt on load
        conv = pose_r.layer1[0].conv1
        assert torch.equal(conv.weight_k, tl.pack_weight(conv.weight_q))


def test_bundle_config_mismatch_rejected(tmp_path):
    det_cfg, detector, pose_cfg, pose = _tiny_models("bf16")
    out = str(tmp_path / "bundle")
    convert.write_bundle(out, det_cfg, detector, pose_cfg, pose)
    with pytest.raises(ValueError, match="input_size"):
        convert.load_bundle(out, det_cfg, dataclasses.replace(pose_cfg, input_size=(128, 96)))
    with pytest.raises(ValueError, match="pack_branch0"):
        convert.load_bundle(out, det_cfg, dataclasses.replace(pose_cfg, pack_branch0=True))
    # serving-only fields do not change the weights: they load
    _, pose_r = convert.load_bundle(out, det_cfg, dataclasses.replace(
        pose_cfg, decode_refine="parabolic", int8_resident=True))
    _assert_modules_equal(pose_r, pose)
    manifest = convert.read_manifest(out)
    manifest["format"] = 2
    with open(os.path.join(out, "bundle.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="unsupported bundle format 2"):
        convert.load_bundle(out, det_cfg, pose_cfg)


def test_jax_bundle_refused(tmp_path):
    """A bundle the JAX package wrote (orbax directories) is refused with a
    message that names its format, before anything is read."""
    import tpupose.models.hrnet as jh
    import tpupose.models.yolov3 as jy

    # the refusal reads no weights, so one array a tree will do
    tree = {"conv1": {"weight": np.zeros((3, 3, 3, 8), np.float32)}}
    out = str(tmp_path / "jax_bundle")
    jconvert.write_bundle(out, jy.tiny_yolo_test_config(), tree, jh.tiny_test_config(), tree)
    assert os.path.isdir(os.path.join(out, "det")) and os.path.isdir(os.path.join(out, "pose"))
    with pytest.raises(ValueError, match="bundle of the JAX package.*orbax"):
        convert.load_bundle(out, tiny_yolo_test_config(), tiny_test_config())


# -- the CLIs on a fabricated dataset --------------------------------------------

@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    root = tmp_path_factory.mktemp("minicampus")
    _, paths = fabricate_mini_dataset(root, num_frames=10, with_weights=True)
    paths["pkl"] = os.path.join(paths["root"], "results", "MiniCampus", "logs",
                                "YOLOv3_HRPose_Iterative_"
                                + os.path.basename(paths["root"]) + ".pkl")
    return paths


def _args(mini, *extra):
    return ["--dataset", "MiniCampus", "--config-dir", mini["config_dir"], *extra]


def _preds(mini):
    with open(mini["pkl"], "rb") as f:
        return pickle.load(f)


def _assert_preds_equal(got, ref):
    assert list(got) == list(ref) and got
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


def _no_converters(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("checkpoint converter called in --bundle mode")

    for name in CONVERTERS:
        monkeypatch.setattr(tconv, name, boom)


def test_convert_main_matches_jax(mini, capsys):
    j_out, t_out = os.path.join(mini["root"], "jax_bundle"), os.path.join(mini["root"], "bundle")
    jconvert.main(_args(mini, "--out", j_out))
    convert.main(_args(mini, *CPU, "--out", t_out))
    out = capsys.readouterr().out
    assert f"bundle written to {t_out}" in out and '"dtype": "bfloat16"' in out, out
    jm, tm = convert.read_manifest(j_out), convert.read_manifest(t_out)
    for key in ("format", "folded", "dtype", "quantized"):
        assert tm[key] == jm[key], key
    for key in ("det_config", "pose_config"):
        shared = set(tm[key]) & set(jm[key])
        assert len(shared) >= 6 and {k: tm[key][k] for k in shared} == \
            {k: jm[key][k] for k in shared}, key
    assert tm["provenance"]["yolo_header"] == jm["provenance"]["yolo_header"]

    jcfg = j_load_config(mini["yaml"])
    j_det, j_pose = jconvert.load_bundle(j_out, jcommon.yolo_config_from(jcfg),
                                         jcommon.hrnet_config_from(jcfg))
    for role, tree in (("det", j_det), ("pose", j_pose)):
        got = torch.load(os.path.join(t_out, f"{role}.pt"), weights_only=True)
        ref = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), tree))
        assert got.keys() == ref.keys() and all(v.dtype == torch.bfloat16 for v in got.values())
        differ = total = 0
        for k in ref:
            a, b = got[k].float(), ref[k].to(torch.bfloat16).float()
            torch.testing.assert_close(a, b, rtol=2**-7, atol=0, msg=k)
            differ += int((a != b).sum())
            total += a.numel()
        assert differ <= 1e-4 * total, (role, differ, total)


def test_evalmodel_bundle_gives_direct_pkl(mini, capsys, monkeypatch):
    evalmodel.main(_args(mini, *CPU))
    direct = _preds(mini)
    bundle = os.path.join(mini["root"], "bundle_bf16")
    convert.main(_args(mini, *CPU, "--out", bundle))
    capsys.readouterr()
    _no_converters(monkeypatch)
    evalmodel.main(_args(mini, *CPU, "--bundle", bundle))
    assert "Average PCP" in capsys.readouterr().out
    _assert_preds_equal(_preds(mini), direct)


def test_int8_bundle_equals_in_process_int8(mini, capsys, monkeypatch):
    """`convert --int8` calibrates on the frames `evalmodel --int8` uses,
    through the same `quantize_models`: the bundle holds the in-process
    int8 models, and serving it gives the in-process run's pkl with no
    converter and no calibration."""
    int8 = ("--int8", "--int8-calib", "2", "--int8-on-drift", "warn")
    quantized = {}
    quantize = Pipeline.quantize_models

    def kept(self, *a, **k):
        quantize(self, *a, **k)
        quantized["models"] = (self.detector, self.pose_model)

    monkeypatch.setattr(Pipeline, "quantize_models", kept)
    evalmodel.main(_args(mini, *CPU, *int8))
    direct, (det_q, pose_q) = _preds(mini), quantized["models"]
    bundle = os.path.join(mini["root"], "bundle_int8")
    convert.main(_args(mini, *CPU, "--out", bundle, *int8))
    out = capsys.readouterr().out
    assert '"quantized": true' in out and "calibrating + self-checking on frames [0, 1]" in out
    manifest = convert.read_manifest(bundle)
    assert manifest["dtype"] == "int8" and manifest["provenance"]["int8_calib_images"] == 6

    _no_converters(monkeypatch)

    def no_quantize(*a, **k):
        raise AssertionError("quantize_models called on a quantized bundle")

    monkeypatch.setattr(Pipeline, "quantize_models", no_quantize)
    cfg, det_cfg, pose_cfg = _configs(mini)
    det_b, pose_b = convert.load_bundle(bundle, det_cfg, pose_cfg)
    _assert_modules_equal(det_b, det_q)
    _assert_modules_equal(pose_b, pose_q)
    evalmodel.main(_args(mini, *CPU, "--bundle", bundle, "--int8"))
    out = capsys.readouterr().out
    assert "bundle is already int8-quantized" in out and "Average PCP" in out, out
    _assert_preds_equal(_preds(mini), direct)
    testmodel.main(_args(mini, *CPU, "--bundle", bundle, "--int8", "--clip", "4"))
    out = capsys.readouterr().out
    assert "bundle is already int8-quantized" in out and "processed 10 frames" in out, out


def _configs(mini):
    from tpupose_torch.cli import common
    from tpupose_torch.data.config import load_config

    cfg = load_config(mini["yaml"])
    return cfg, common.yolo_config_from(cfg), common.hrnet_config_from(cfg)
