"""The port's CLIs (`tpupose_torch.cli.evalmodel`, `testmodel`, `score`)
and checkpoint loaders against the JAX package's, on one mini-dataset that
`tpupose.data.fabricate.fabricate_mini_dataset(with_weights=True)` writes:
3 views of 24 rendered 720x1280 JPEG frames, calibration, actorsGT.mat, a
replay dump, a reference-schema YAML and tiny random checkpoints in the
published formats (darknet 0.2 `.weights`, `pose_hrnet` `.pth`). The
tests of the port's CLIs alone that need no confirmed track run on the
same dataset as the port's `tpupose_torch.data.fabricate` writes it (the
same files but the tiny weights, drawn from the port's own models); on
those weights the tracker confirms no track (0 track-frames in 24, where
the JAX package's weights give some), so the tests that compare tracked
poses keep the JAX package's dataset.

Tolerances and why:
* Loaders: the state_dicts equal `state_dict_from_jax` of the JAX
  loaders' trees exactly (both read the same floats from the same files).
* Built pipelines: BN folded into bf16 weights by each package (f32
  arithmetic, then one rounding to bf16) give equal weights but for one
  bf16 step (relative 2^-7) on a few elements in 10^5 (3 of 244,105 YOLO
  and 4 of 174,697 HRNet values, measured): XLA's f32 rsqrt on the CPU
  and torch's differ in the last bit, which can flip the bf16 rounding of
  w * gamma / sqrt(var + eps). Everything else is exact.
* Replay and synthetic modes: the same tables and `Average PCP: 100.00`;
  the pkl's 3D poses within 5e-3 m, the band of the tracker parity tests
  (f32 sums in another order on each side).
* The port's NN mode: `--clip 7` (3 clips + 3 trailing frames) against
  `--clip 0` within atol 2e-2, the JAX package's own rule for the same
  check (tests/test_real_data_path.py).

Every CLI call passes `--device cpu`: the port's entry points run on CUDA
unless told otherwise.
"""
import functools
import glob
import json
import os
import pickle
import re
import shutil

import numpy as np
import jax
import pytest
import torch
import yaml

import tpupose.cli.common as jcommon
import tpupose.models.convert as jconv
from tpupose.cli import evalmodel as j_evalmodel
from tpupose.cli import score as j_score
from tpupose.data.config import load_config as j_load_config
from tpupose.data.fabricate import fabricate_mini_dataset
from tpupose.models.quantize import QuantizationDriftError as JDriftError
from tpupose.pipeline.facade import Pipeline as JPipeline
import tpupose_torch.cli.common as tcommon
import tpupose_torch.models.convert as tconv
from tpupose_torch.cli import evalmodel, score, testmodel
from tpupose_torch.data.config import load_config
from tpupose_torch.data.fabricate import fabricate_mini_dataset as t_fabricate_mini_dataset
from tpupose_torch.models.convert import state_dict_from_jax
from tpupose_torch.models.quantize import QuantizationDriftError
from tpupose_torch.pipeline.facade import Pipeline

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
TIMING = ("Person Detect", "Pose Detect", "Track Processing", "fps:", "tracking fps",
          "Decode")


def _fabricated(tmp_path_factory, fabricate):
    root = tmp_path_factory.mktemp("minicampus")
    _, paths = fabricate(root, with_weights=True)
    assert paths["hrnet_checkpoint"], "tiny .pth missing"
    paths["pkl"] = os.path.join(paths["root"], "results", "MiniCampus", "logs",
                                "YOLOv3_HRPose_Iterative_"
                                + os.path.basename(paths["root"]) + ".pkl")
    paths["track_dir"] = os.path.join(paths["root"], "results", "MiniCampus",
                                      "TrackResult")
    return paths


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return _fabricated(tmp_path_factory, fabricate_mini_dataset)


@pytest.fixture(scope="module")
def port_mini(tmp_path_factory):
    return _fabricated(tmp_path_factory, t_fabricate_mini_dataset)


def _args(mini, *extra):
    return ["--dataset", "MiniCampus", "--config-dir", mini["config_dir"], *extra]


def _tables(out):
    """The printed lines without the timing report."""
    return [ln for ln in out.splitlines() if not ln.startswith(TIMING)]


def _artifacts(mini):
    """(pkl dict, {camera json name: parsed json}) as the last run left them."""
    with open(mini["pkl"], "rb") as f:
        preds = pickle.load(f)
    jsons = {}
    for path in sorted(glob.glob(os.path.join(mini["track_dir"], "Camera*.json"))):
        with open(path) as f:
            jsons[os.path.basename(path)] = json.load(f)
    return preds, jsons


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_sd_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


def _configs(mini):
    tcfg = load_config(mini["yaml"])
    return tcfg, tcommon.yolo_config_from(tcfg), tcommon.hrnet_config_from(tcfg)


# -- checkpoint loaders ------------------------------------------------------

def test_loaders_match_jax(mini):
    jcfg = j_load_config(mini["yaml"])
    tcfg, det_cfg, pose_cfg = _configs(mini)
    j_det, header = jconv.load_darknet_weights(mini["yolo_weights"],
                                               jcommon.yolo_config_from(jcfg))
    assert (header["major"], header["minor"]) == (0, 2)
    _assert_sd_equal(tconv.load_darknet_weights(mini["yolo_weights"], det_cfg),
                     state_dict_from_jax(_tree_np(j_det)))
    j_pose = jconv.load_hrnet_torch_checkpoint(mini["hrnet_checkpoint"])
    model = tconv.load_hrnet_torch_checkpoint(mini["hrnet_checkpoint"], pose_cfg)
    _assert_sd_equal(model.state_dict(), state_dict_from_jax(_tree_np(j_pose)))


@pytest.mark.parametrize("minor", [1, 2])
def test_darknet_round_trip(mini, tmp_path, minor):
    """Format 0.1 stores `seen` as int32, 0.2 as int64: both round-trip,
    and the JAX reader reads the port's file to the same floats."""
    _, det_cfg, _ = _configs(mini)
    sd = tconv.load_darknet_weights(mini["yolo_weights"], det_cfg)
    data = tconv.state_dict_to_darknet_array(sd, det_cfg)
    _, ref = tconv.read_darknet_file(mini["yolo_weights"])
    np.testing.assert_array_equal(data, ref)
    path = tmp_path / f"v{minor}.weights"
    tconv.write_darknet_file(path, {"major": 0, "minor": minor, "revision": 5,
                                    "seen": 3_000_000_000 if minor == 2 else 7}, data)
    assert os.path.getsize(path) == 12 + (8 if minor == 2 else 4) + 4 * data.size
    header, back = tconv.read_darknet_file(path)
    assert header == {"major": 0, "minor": minor, "revision": 5,
                      "seen": 3_000_000_000 if minor == 2 else 7}
    np.testing.assert_array_equal(back, data)
    j_header, j_back = jconv.read_darknet_file(path)
    assert j_header == header
    np.testing.assert_array_equal(j_back, data)
    _assert_sd_equal(tconv.load_darknet_weights(path, det_cfg), sd)


@pytest.mark.parametrize("cut", ["short", "long", "half"])
def test_darknet_wrong_length_raises(mini, tmp_path, cut):
    """A payload one float short or long, or cut in half, raises."""
    _, det_cfg, _ = _configs(mini)
    header, data = tconv.read_darknet_file(mini["yolo_weights"])
    data = {"short": data[:-1], "long": np.append(data, np.float32(1.0)),
            "half": data[: data.size // 2]}[cut]
    tconv.write_darknet_file(tmp_path / "bad.weights", header, data)
    with pytest.raises(ValueError, match="darknet weights"):
        tconv.load_darknet_weights(tmp_path / "bad.weights", det_cfg)


def test_hrnet_checkpoint_wrapped_and_prefixed(mini, tmp_path):
    """A `{"state_dict": ...}` container with DataParallel's `module.`
    prefix loads to the same weights; a missing key fails strict loading."""
    _, _, pose_cfg = _configs(mini)
    sd = torch.load(mini["hrnet_checkpoint"], weights_only=True)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "epoch": 3},
               tmp_path / "wrapped.pth")
    plain = tconv.load_hrnet_torch_checkpoint(mini["hrnet_checkpoint"], pose_cfg)
    wrapped = tconv.load_hrnet_torch_checkpoint(tmp_path / "wrapped.pth", pose_cfg)
    _assert_sd_equal(wrapped.state_dict(), plain.state_dict())
    torch.save({k: v for k, v in sd.items() if not k.startswith("final_layer")},
               tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="final_layer"):
        tconv.load_hrnet_torch_checkpoint(tmp_path / "short.pth", pose_cfg)


def test_built_pipelines_match_jax(mini):
    jcfg = j_load_config(mini["yaml"])
    tcfg, _, _ = _configs(mini)
    cam = jcommon.load_camera_parameter(jcfg)
    jpipe = jcommon.build_pipeline_real(jcfg, cam, 1280, 720)
    tpipe = tcommon.build_pipeline_real(tcfg, tcommon.load_camera_parameter(tcfg),
                                        1280, 720, device="cpu")
    assert tpipe.device == torch.device("cpu")
    assert vars(tpipe.tracker_cfg) == vars(jpipe.tracker_cfg)
    assert vars(tpipe.det_cfg) == vars(jpipe.det_cfg)
    pose_fields = vars(tpipe.pose_cfg)
    assert {k: v for k, v in vars(jpipe.pose_cfg).items() if k in pose_fields} == pose_fields
    for name in ("P", "K", "RT", "size"):
        np.testing.assert_array_equal(getattr(tpipe.cams, name).numpy(),
                                      np.asarray(getattr(jpipe.cams, name)), err_msg=name)
    for name in ("rk_inv", "center"):  # tolerance of tests/test_torch_geometry.py
        np.testing.assert_allclose(getattr(tpipe.cams, name).numpy(),
                                   np.asarray(getattr(jpipe.cams, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for model, params in ((tpipe.detector, jpipe.det_params),
                          (tpipe.pose_model, jpipe.pose_params)):
        # bf16 -> f32 -> bf16 is exact, and numpy has no bf16 of torch's
        ref = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), params))
        got = model.state_dict()
        assert set(got) == set(ref)
        assert all(v.dtype == torch.bfloat16 for v in got.values())
        differ = total = 0
        for k in ref:
            a, b = got[k].float(), ref[k].to(torch.bfloat16).float()
            torch.testing.assert_close(a, b, rtol=2**-7, atol=0, msg=k)
            differ += int((a != b).sum())
            total += a.numel()
        assert differ <= 1e-4 * total, (differ, total)


def test_dataset_frame_source_matches_jax(mini):
    """The PIL frame source gives the JAX package's frames, ids and
    timestamps, and `device_prefetch` passes them through unchanged."""
    ref = list(jcommon.dataset_frame_source(j_load_config(mini["yaml"]), use_native=False))
    cfg = load_config(mini["yaml"])
    got = list(tcommon.device_prefetch(tcommon.dataset_frame_source(cfg, device="cpu"), "cpu",
                                       depth=5))
    assert len(got) == len(ref) == 24
    for (f1, t1, im1, _, _), (f2, t2, im2, _, _) in zip(got, ref):
        assert (f1, t1) == (f2, t2)
        assert torch.is_tensor(im1) and im1.shape == (3, 720, 1280, 3)
        np.testing.assert_array_equal(im1.numpy(), im2)


def test_bundle_and_qat_raise_not_implemented(mini, monkeypatch, capsys):
    """`--bundle` names a directory that must hold a bundle: a missing one
    raises FileNotFoundError naming its manifest (serving bundles are ported;
    tests/test_torch_bundle.py serves them). `--qat-steps`
    and the default `--int8-on-drift escalate` do what the JAX package does
    on the same fixture, whose random weights fail the self-check: QAT from
    the start refuses to serve at once, and escalation runs distill-QAT,
    checks again and refuses with the post-QAT numbers. Both packages'
    `escalate_steps` are cut from 900 to 2 for the CPU. The JAX CLI runs
    the default only (its `qat_steps` refusal is tests/test_int8_selfcheck.py's);
    each JAX run is a minute of compiling on the CPU."""
    for main in (evalmodel.main, testmodel.main):
        with pytest.raises(FileNotFoundError, match="bundle.json"):
            main(_args(mini, *CPU, "--bundle", os.path.join(mini["root"], "no_bundle")))
    for cls in (JPipeline, Pipeline):
        monkeypatch.setattr(cls, "quantize_models",
                            functools.partialmethod(cls.quantize_models, escalate_steps=2))
    runs = ((j_evalmodel.main, [], JDriftError, []),
            (evalmodel.main, CPU, QuantizationDriftError, []),
            (evalmodel.main, CPU, QuantizationDriftError, ["--qat-steps", "1"]))
    for main, device, error, extra in runs:
        with pytest.raises(error) as e:
            main(_args(mini, *device, "--int8", "--int8-calib", "1", *extra))
        out = capsys.readouterr().out
        assert "int8 self-check" in str(e.value) and "refusing to serve" in str(e.value)
        escalated = not extra
        assert ("escalating to label-free distill-QAT (2 steps" in out) == escalated, out
        assert ("after distill-QAT" in str(e.value)) == escalated, str(e.value)


def test_cli_errors(port_mini, monkeypatch, capsys):
    with pytest.raises(FileNotFoundError, match=os.path.join("Bogus", "model_configs.yaml")):
        evalmodel.main(["--dataset", "Bogus", "--config-dir", port_mini["config_dir"], *CPU])
    with pytest.raises(SystemExit) as e:
        score.main([])
    assert e.value.code == 2 and "--pred" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (evalmodel.main, testmodel.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--synthetic", "--frames", "2"])


# -- the CLIs end to end -------------------------------------------------------

def test_replay_matches_jax(mini, capsys):
    j_evalmodel.main(_args(mini, "--replay", mini["dump"]))
    j_out = capsys.readouterr().out
    j_preds, j_jsons = _artifacts(mini)
    evalmodel.main(_args(mini, *CPU, "--replay", mini["dump"]))
    t_out = capsys.readouterr().out
    t_preds, t_jsons = _artifacts(mini)

    assert "Average PCP: 100.00" in t_out and "Average PCP: 100.00" in j_out, t_out
    assert _tables(t_out) == _tables(j_out)
    assert list(t_preds) == list(j_preds) and set(range(5, 24)) <= set(t_preds)
    for k in j_preds:
        assert t_preds[k].shape == j_preds[k].shape, k
        np.testing.assert_allclose(t_preds[k], j_preds[k], atol=5e-3, err_msg=str(k))
    assert list(t_jsons) == list(j_jsons) and len(t_jsons) == 3
    for name, ref in j_jsons.items():
        got = t_jsons[name]
        assert got["image_wh"] == ref["image_wh"] == [1280, 720]
        assert list(got["frames"]) == list(ref["frames"])
        for frame, entry in ref["frames"].items():
            assert [p["id"] for p in got["frames"][frame]["poses"]] == \
                [p["id"] for p in entry["poses"]], (name, frame)

    # the port's score CLI on the port's pkl prints the JAX score CLI's table
    score_args = ["--pred", mini["pkl"], "--gt", mini["root"], "--dataset", "MiniCampus",
                  "--ranges", "5:24"]
    j_score.main(score_args)
    j_out = capsys.readouterr().out
    score.main(score_args)
    assert capsys.readouterr().out == j_out and "Average PCP: 100.00" in j_out


def test_panoptic_replay_matches_jax(tmp_path, capsys):
    """A fabricated MiniPanoptic (timestamp-keyed frames, every-12th-file
    GT) through both CLIs' --replay: the AP / Recall table and the MPJPE
    line. MPJPE is a mean over joints of poses that agree within 5e-3 m,
    so its printed value is held within 0.05 mm."""
    from tpupose.data.fabricate import fabricate_mini_panoptic

    _, paths = fabricate_mini_panoptic(tmp_path / "minipanoptic")
    args = ["--dataset", "Panoptic", "--config-dir", paths["config_dir"],
            "--replay", paths["dump"]]
    j_evalmodel.main(args)
    j_out = capsys.readouterr().out
    evalmodel.main(args + CPU)
    t_out = capsys.readouterr().out
    j_mpjpe = float(re.search(r"MPJPE: ([0-9.]+)mm", j_out).group(1))
    t_mpjpe = float(re.search(r"MPJPE: ([0-9.]+)mm", t_out).group(1))
    assert abs(t_mpjpe - j_mpjpe) <= 0.05 and t_mpjpe < 20.0, (t_out, j_out)
    table = [ln for ln in _tables(t_out) if not ln.startswith("MPJPE")]
    assert table == [ln for ln in _tables(j_out) if not ln.startswith("MPJPE")]
    assert "100.00" in [ln for ln in table if "AP" in ln][0], t_out


def test_synthetic_matches_jax(capsys):
    j_evalmodel.main(["--synthetic", "--frames", "30"])
    j_out = capsys.readouterr().out
    evalmodel.main(["--synthetic", "--frames", "30", *CPU])
    t_out = capsys.readouterr().out
    assert "Average PCP: 100.00" in t_out and _tables(t_out) == _tables(j_out), t_out
    testmodel.main(["--synthetic", "--frames", "30", *CPU])
    out = capsys.readouterr().out
    assert re.search(r"confirmed track-frames: [1-9]\d*", out) and "tracking fps" in out


def test_nn_clip_mode_matches_frame_mode(mini, capsys, monkeypatch):
    """`--clip 7` routes 3 clips through `process_clip` and the 3 trailing
    frames through `process_frame`, with the per-frame path's results."""
    evalmodel.main(_args(mini, *CPU, "--clip", "0"))
    out = capsys.readouterr().out
    assert "Average PCP" in out and "fps" in out, out
    frame_mode, jsons = _artifacts(mini)
    assert len(jsons) >= 1 and set(frame_mode) == set(range(24))

    calls = {"clip": 0, "clip_frames": 0, "frame": 0}
    clip_fn, frame_fn = Pipeline.process_clip, Pipeline.process_frame

    def counted_clip(self, frame_ids, clip_images):
        calls["clip"] += 1
        calls["clip_frames"] += len(frame_ids)
        return clip_fn(self, frame_ids, clip_images)

    def counted_frame(self, frame_id, images):
        calls["frame"] += 1
        return frame_fn(self, frame_id, images)

    monkeypatch.setattr(Pipeline, "process_clip", counted_clip)
    monkeypatch.setattr(Pipeline, "process_frame", counted_frame)
    evalmodel.main(_args(mini, *CPU, "--clip", "7"))
    assert "Average PCP" in capsys.readouterr().out
    assert calls == {"clip": 3, "clip_frames": 21, "frame": 3}, calls
    clip_mode, _ = _artifacts(mini)
    assert set(clip_mode) == set(frame_mode)
    for k in frame_mode:
        a, b = frame_mode[k], clip_mode[k]
        assert a.shape == b.shape, k
        if a.size:
            np.testing.assert_allclose(a, b, atol=2e-2)


def test_nn_int8_mode(mini, capsys):
    evalmodel.main(_args(mini, *CPU, "--int8", "--int8-calib", "2",
                         "--int8-on-drift", "warn"))
    out = capsys.readouterr().out
    assert "--int8: calibrating + self-checking on frames [0, 1]" in out
    assert "int8 self-check" in out and "Average PCP" in out, out
    preds, jsons = _artifacts(mini)
    assert set(preds) == set(range(24))
    for v in preds.values():
        assert v.ndim == 3 and v.shape[1:] == (3, 17) or v.size == 0
        assert np.isfinite(v).all()
    for cam in jsons.values():
        assert cam["image_wh"] == [1280, 720]
        for frame in cam["frames"].values():
            for pose in frame["poses"]:
                assert len(pose["points_2d"]) == 17 and len(pose["scores"]) == 17


def test_testmodel_save_images(port_mini, tmp_path, capsys):
    """testmodel --save-images with SAVE_IMAGE on: one overlay JPEG per
    camera per frame under <OUTPUT>/<dataset>/Images, from both the clip
    path (a clip of 10) and the trailing per-frame path (4 frames)."""
    with open(port_mini["yaml"]) as f:
        raw = yaml.safe_load(f)
    raw["SAVE_IMAGE"] = True
    raw["OUTPUT"] = str(tmp_path / "out")
    raw["DATASET"]["TEST_RANGE"] = [0, 14]
    cfg_dir = tmp_path / "configs" / "MiniCampus"
    cfg_dir.mkdir(parents=True)
    (cfg_dir / "model_configs.yaml").write_text(yaml.safe_dump(raw))
    testmodel.main(["--dataset", "MiniCampus", "--config-dir", str(tmp_path / "configs"),
                    "--save-images", "--clip", "10", *CPU])
    out = capsys.readouterr().out
    assert "processed 14 frames" in out and "fps" in out, out
    images = glob.glob(str(tmp_path / "out" / "MiniCampus" / "Images" / "*.jpg"))
    assert len(images) == 14 * 3
    shutil.rmtree(tmp_path / "out")
