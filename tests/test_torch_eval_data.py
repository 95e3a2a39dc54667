"""The port's scorers, writers, config and dataset readers, replay dumps
and host helpers against the JAX package's, on the same inputs made from
numpy seeds.

All of these are numpy code on both sides, so the comparisons are exact:
equal dicts and arrays, score tables equal character for character, JSON
and pickle artifacts equal byte for byte or value for value, overlay
pixels equal.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import pickle

import numpy as np
import pytest
import scipy.io as scio
import torch
import yaml

import tpupose.data.config as jcfg
import tpupose.data.dataset as jds
import tpupose.data.replay as jrep
import tpupose.eval.mot as jmot
import tpupose.eval.panoptic as jpan
import tpupose.eval.pcp as jpcp
import tpupose.eval.transforms as jtr
import tpupose.eval.writers as jwr
import tpupose.utils.natsort as jnat
import tpupose.utils.timing as jtime
import tpupose.utils.viz as jviz
import tpupose_torch.data.config as tcfg
import tpupose_torch.data.dataset as tds
import tpupose_torch.data.replay as trep
import tpupose_torch.eval.mot as tmot
import tpupose_torch.eval.panoptic as tpan
import tpupose_torch.eval.pcp as tpcp
import tpupose_torch.eval.transforms as ttr
import tpupose_torch.eval.writers as twr
import tpupose_torch.utils.natsort as tnat
import tpupose_torch.utils.timing as ttime
import tpupose_torch.utils.viz as tviz

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").iterdir())


def _equal(a, b, path="."):
    """Deep equality of nested dicts / lists / tuples / numpy arrays /
    scalars, NaN equal to NaN."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _predictions(rng, n_frames, n_actors, gt3d, drop=0.2, noise=0.05):
    """{frame: (N, 3, 17)}: noisy copies of the GT, some dropped, some
    spurious, some frames empty."""
    preds = {}
    for f in range(n_frames):
        poses = [gt3d[f, a] + rng.normal(scale=noise, size=(17, 3))
                 for a in range(n_actors) if rng.uniform() > drop]
        if rng.uniform() < 0.3:
            poses.append(rng.normal(size=(17, 3)))
        if f % 7 == 3:
            poses = []
        preds[f] = np.asarray([p.T for p in poses]).reshape(-1, 3, 17)
    return preds


def _gt3d(rng, n_frames, n_actors):
    base = rng.normal(scale=0.3, size=(n_actors, 17, 3)) + rng.uniform(-2, 2, (n_actors, 1, 3))
    drift = np.cumsum(rng.normal(scale=0.01, size=(n_frames, n_actors, 1, 3)), axis=0)
    return base[None] + drift


def _actors_gt(gt3d, missing):
    """The actorsGT layout: actors_gt[a][f] is a (14, 3) Shelf pose or an
    empty array where (f, a) is in `missing`."""
    n_frames, n_actors = gt3d.shape[:2]
    return [[np.zeros((0, 0)) if (f, a) in missing else jtr.coco2shelf3d(gt3d[f, a].T)
             for f in range(n_frames)] for a in range(n_actors)]


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_pcp_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n_frames, n_actors = 30, 4
    gt3d = _gt3d(rng, n_frames, n_actors)
    missing = {(int(f), int(a)) for f, a in rng.integers(0, [n_frames, n_actors], (10, 2))}
    actors = _actors_gt(gt3d, missing)
    preds = _predictions(rng, n_frames, n_actors, gt3d)
    ranges = [[2, 14], [17, 30]]
    ref = jpcp.evaluate_pcp(ranges, preds, actors)
    got = tpcp.evaluate_pcp(ranges, preds, actors)
    _equal(got, ref)
    assert got["table"] == ref["table"]
    assert 0.0 < ref["average"] < 1.0  # the fixture scores bones both ways

    # the file-level scorer: actorsGT.mat in the reference's cell layout
    actor3d = np.empty((1, n_actors), dtype=object)
    for a in range(n_actors):
        frames = np.empty((n_frames, 1), dtype=object)
        for f in range(n_frames):
            frames[f, 0] = actors[a][f]
        actor3d[0, a] = frames
    scio.savemat(tmp_path / "actorsGT.mat", {"actor3D": actor3d})
    with open(tmp_path / "preds.pkl", "wb") as f:
        pickle.dump(preds, f)
    for name in ("Shelf", "Panoptic"):
        ref = jpcp.evaluate_pcp_from_pickle(ranges, tmp_path / "preds.pkl", tmp_path, name)
        got = tpcp.evaluate_pcp_from_pickle(ranges, tmp_path / "preds.pkl", tmp_path, name)
        _equal(got, ref)
    with pytest.raises(ValueError, match="EVAL_RANGE"):
        tpcp.evaluate_pcp([[5, 999]], preds, actors)


def _write_panoptic_gt(root, rng, timestamps, n_bodies):
    anno = root / "hdPose3d_stage1_coco19"
    anno.mkdir()
    for t in timestamps:
        bodies = []
        poses = rng.normal(scale=30.0, size=(n_bodies, 19, 3)) + rng.uniform(-200, 200, (n_bodies, 1, 3))
        for b in range(n_bodies):
            j19 = np.concatenate([poses[b], rng.uniform(0.0, 1.0, (19, 1))], axis=1)
            j19[3, 3] = 1.0 if b else 0.05  # body 0 fails the vis[2] gate
            bodies.append({"id": b, "joints19": j19.ravel().tolist()})
        if t == timestamps[12]:
            bodies = []  # a scored file with nobody in it
        with open(anno / f"body3DScene_{t:08d}.json", "w") as f:
            json.dump({"version": 0.7, "bodies": bodies}, f)


def test_panoptic_scorer_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(2)
    timestamps = list(range(5, 5 + 12 * 6))
    _write_panoptic_gt(tmp_path, rng, timestamps, n_bodies=3)
    ref_gt = jpan.load_panoptic_gt(tmp_path)
    got_gt = tpan.load_panoptic_gt(tmp_path)
    _equal(got_gt, ref_gt)
    assert len(ref_gt) == 5 and all(len(g["joints_3d"]) == 2 for g in ref_gt.values())
    np.testing.assert_array_equal(tpan.GT_AXES_M, jpan.GT_AXES_M)

    preds = {}
    for t, g in ref_gt.items():
        # COCO-17 (3, 17) predictions in metres near each GT body (the
        # inverse of coco2panoptic14's row selection), plus a stray
        poses = []
        for g14 in g["joints_3d"]:
            coco = np.repeat(g14[:1], 17, axis=0)
            coco[[5, 7, 9, 11, 13, 15, 6, 8, 10, 12, 14, 16]] = g14[2:]
            poses.append(coco / 1000.0 + rng.normal(scale=0.02 * (1 + t % 3), size=(17, 3)))
        poses.append(rng.normal(size=(17, 3)))
        preds[t] = np.transpose(np.asarray(poses), (0, 2, 1))
    ref = jpan.evaluate_panoptic(ref_gt, preds)
    got = tpan.evaluate_panoptic(got_gt, preds)
    _equal([list(map(float, got[0])), list(map(float, got[1])), got[2], got[3]],
           [list(map(float, ref[0])), list(map(float, ref[1])), ref[2], ref[3]])
    assert 0.0 < ref[0][-1] and ref[0][0] < 1.0

    with open(tmp_path / "preds.pkl", "wb") as f:
        pickle.dump(preds, f)
    ref = jpan.evaluate_panoptic_from_pickle(tmp_path / "preds.pkl", tmp_path)
    ref_out = capsys.readouterr().out
    got = tpan.evaluate_panoptic_from_pickle(tmp_path / "preds.pkl", tmp_path)
    assert capsys.readouterr().out == ref_out
    assert got["table"] == ref["table"] and got["mpjpe"] == ref["mpjpe"]


def test_evaluate_mot_matches_jax():
    rng = np.random.default_rng(3)
    gt_frames, pred_frames = [], []
    for f in range(40):
        gts = {g: rng.normal(size=(17, 3)) + g for g in range(4) if (f + g) % 9}
        preds = {}
        for g, pose in gts.items():
            if rng.uniform() < 0.85:
                pid = 10 + g + (100 if f > 25 and g == 1 else 0)  # one id switch
                preds[pid] = pose + rng.normal(scale=0.1 + 0.3 * (g == 3), size=(17, 3))
        if rng.uniform() < 0.2:
            preds[99] = rng.normal(size=(17, 3)) * 5
        gt_frames.append(gts)
        pred_frames.append(preds)
    ref = jmot.evaluate_mot(gt_frames, pred_frames)
    got = tmot.evaluate_mot(gt_frames, pred_frames)
    _equal(got, ref)
    assert ref["id_switches"] >= 1 and ref["false_positives"] > 0 and ref["misses"] > 0
    _equal(tmot.evaluate_mot([], []), jmot.evaluate_mot([], []))


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        pose = rng.normal(size=(3, 17))
        np.testing.assert_array_equal(ttr.coco2shelf3d(pose), jtr.coco2shelf3d(pose))
        np.testing.assert_array_equal(ttr.coco2panoptic(pose), jtr.coco2panoptic(pose))
        np.testing.assert_array_equal(ttr.coco2panoptic14(pose), jtr.coco2panoptic14(pose))
        np.testing.assert_array_equal(ttr.coco17to19(pose.T), jtr.coco17to19(pose.T))
        gt = rng.normal(size=(14, 3))
        preds = rng.normal(size=(6, 14, 3))
        preds[1, 3, 0] = preds[4] = np.nan
        np.testing.assert_array_equal(ttr.nan_masked_sqdist(gt, preds),
                                      jtr.nan_masked_sqdist(gt, preds))
    assert ttr.COCO17_NAMES == jtr.COCO17_NAMES


def test_writers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    annotations = []
    for f in range(6):
        for cid in range(3):
            for pid in range(rng.integers(0, 3)):
                annotations.append({
                    "timestamp": f"frame{f}" if f % 2 else f, "cid": cid, "pid": int(pid),
                    "pose": rng.uniform(0, 1000, (17, 2)).astype(np.float32),
                    "scores": rng.uniform(size=17).astype(np.float32)})
    annotations = [a for a in annotations if isinstance(a["timestamp"], int)]
    poses = {f: rng.normal(size=(2, 3, 17)).astype(np.float32) for f in range(6)}
    jwr.write_2d_result((720, 1280), annotations, save_dir=tmp_path / "jax")
    twr.write_2d_result((720, 1280), annotations, save_dir=tmp_path / "torch")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 3
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    assert json.loads((tmp_path / "torch" / names[0]).read_text())["image_wh"] == [1280, 720]
    jwr.write_3d_result(poses, str(tmp_path / "j" / "p.pkl"))
    twr.write_3d_result(poses, str(tmp_path / "t" / "p.pkl"))
    _equal(pickle.loads((tmp_path / "t" / "p.pkl").read_bytes()),
           pickle.loads((tmp_path / "j" / "p.pkl").read_bytes()))


#: The port's own pose-model keys (ViTPose's widths), at their defaults
#: in every reference YAML; the JAX package has no such keys.
PORT_POSE_KEYS = {"embed_dim": 1280, "depth": 32, "num_heads": 16}


def _config_dicts(port, ref):
    got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
    for key, default in PORT_POSE_KEYS.items():
        assert got["pose_model"].pop(key) == default, key
    assert got == want
    return got


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(name, tmp_path):
    path = ROOT / "configs" / name / "model_configs.yaml"
    got = _config_dicts(tcfg.load_config(str(path)), jcfg.load_config(str(path)))
    assert got["dataset"]["test_dataset"] == name
    # the YAML parse split from the build
    _config_dicts(tcfg.config_from_raw(yaml.safe_load(path.read_text())),
                  jcfg.load_config(str(path)))
    # the tracker configuration built from it
    for views in (3, 5):
        t = dataclasses.asdict(tcfg.tracker_config_from(tcfg.load_config(str(path)), views,
                                                        max_dets=4))
        j = dataclasses.asdict(jcfg.tracker_config_from(jcfg.load_config(str(path)), views,
                                                        max_dets=4))
        assert t == j and t["num_cameras"] == views


def test_panoptic_typo_repair_matches_jax(tmp_path):
    """The reference's shipped Panoptic YAML has a bare `PERSON_M` line in
    place of `PERSON_MATCHERS:`, which no YAML parser reads."""
    text = (ROOT / "configs" / "Panoptic" / "model_configs.yaml").read_text()
    assert "\nPERSON_MATCHERS:" in text
    broken = tmp_path / "model_configs.yaml"
    broken.write_text(text.replace("\nPERSON_MATCHERS:", "\nPERSON_M"))
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(broken.read_text())
    got = _config_dicts(tcfg.load_config(str(broken)), jcfg.load_config(str(broken)))
    fixed = dataclasses.asdict(tcfg.load_config(str(ROOT / "configs" / "Panoptic"
                                                     / "model_configs.yaml")))
    assert got["matcher"] == fixed["matcher"]
    assert got["matcher"] != dataclasses.asdict(tcfg.MatcherConfig())  # not the defaults


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_shelf_config_is_shelf_yaml():
    """chip_smoke.py's phase 10 config is configs/Shelf/model_configs.yaml
    with three keys changed: the checkpoint paths, MAX_CANDIDATES, and the
    dataset root / output."""
    cs = _load_chip_smoke()
    shelf = yaml.safe_load((ROOT / "configs" / "Shelf" / "model_configs.yaml").read_text())
    assert "MAX_CANDIDATES" not in shelf["DETECT_MODELS"]["YOLOV3"]
    shelf["DETECT_MODELS"]["YOLOV3"]["MAX_CANDIDATES"] = 4
    _equal(cs.SHELF_CONFIG, shelf)
    raw = cs.shelf_config("/data/x", "/data/x/y.weights", "/data/x/h.pth")
    assert raw["DETECT_MODELS"]["YOLOV3"].pop("WEIGHT") == "/data/x/y.weights"
    assert raw["POSE_MODELS"]["HRPOSE"].pop("CHECKPOINT_FILE") == "/data/x/h.pth"
    assert raw["DATASET"].pop("ROOT") == "/data/x"
    assert raw.pop("OUTPUT") == "/data/x/results"
    for key in ("WEIGHT",):
        shelf["DETECT_MODELS"]["YOLOV3"].pop(key)
    shelf["POSE_MODELS"]["HRPOSE"].pop("CHECKPOINT_FILE")
    shelf["DATASET"].pop("ROOT")
    shelf.pop("OUTPUT")
    _equal(raw, shelf)
    cfg = tcfg.config_from_raw(cs.shelf_config("/r", "/r/y.weights", "/r/h.pth"))
    assert cfg.detect_model.max_candidates == 4 and len(cfg.dataset.folders_order) == 5
    assert cfg.pipeline.conf_threshold == 0.5 and cfg.matcher.epi_threshold == 60


def test_natsort_and_filenames_match_jax(tmp_path):
    names = [f"cam-{i}.jpg" for i in (10, 9, 1, 100, 0, 11)] + ["a2b10", "a2b9", "a10b1"]
    assert tnat.natsorted(names) == jnat.natsorted(names)
    assert tnat.natsorted(names)[:3] == ["a2b9", "a2b10", "a10b1"]
    for c in ("Camera0", "Camera1"):
        (tmp_path / c).mkdir()
        for i in (10, 2, 1, 30):
            (tmp_path / c / f"hd_00_{c[-1]}_{i:08d}.jpg").write_bytes(b"")
    ds = tcfg.DatasetConfig(test_dataset="Panoptic", root=str(tmp_path),
                            folders_order=["Camera0", "Camera1"])
    got = tds.load_filenames(ds)
    assert got == jds.load_filenames(jcfg.DatasetConfig(**dataclasses.asdict(ds)))
    assert [tds.parse_timestamp("Panoptic", f[0]) for f in got] == [1, 2, 10, 30]
    assert tds.parse_timestamp("Shelf", got[0][0]) == jds.parse_timestamp("Shelf", got[0][0])


def test_replay_dump_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    dets = rng.uniform(0, 1000, (3, 6, 17, 3)).astype(np.float32)
    mask = rng.uniform(size=(3, 6)) < 0.6
    frame = trep.dets_to_dump_frame(dets, mask)
    _equal(frame, jrep.dets_to_dump_frame(dets, mask))
    for got, ref in zip(trep.dump_frame_to_dets(frame, 3, 8),
                        jrep.dump_frame_to_dets(frame, 3, 8)):
        np.testing.assert_array_equal(got, ref)
    back, back_mask = trep.dump_frame_to_dets(frame, 3, 6)
    np.testing.assert_array_equal(back[back_mask], dets[mask])  # compacted per camera
    np.testing.assert_array_equal(back_mask.sum(1), mask.sum(1))
    trep.save_detection_dump(tmp_path / "d.pkl", {0: frame, 7: frame})
    _equal(trep.load_detection_dump(tmp_path / "d.pkl"),
           jrep.load_detection_dump(tmp_path / "d.pkl"))

    # the frame source over a config's TEST_RANGE, missing frames empty
    raw = yaml.safe_load((ROOT / "configs" / "CampusSeq1" / "model_configs.yaml").read_text())
    raw["DATASET"]["ROOT"] = str(tmp_path / "none")
    raw["DATASET"]["TEST_RANGE"] = [0, 9]
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(raw))
    views = len(raw["DATASET"]["FOLDERS_ORDER"])
    dump = {0: frame, 7: frame}
    got = list(trep.replay_frame_source(tcfg.load_config(str(tmp_path / "c.yaml")), dump, 6))
    ref = list(jrep.replay_frame_source(jcfg.load_config(str(tmp_path / "c.yaml")), dump, 6))
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        assert g[:3] == r[:3]
        np.testing.assert_array_equal(g[3], r[3])
        np.testing.assert_array_equal(g[4], r[4])
    assert got[7][4].sum() == mask[:views].sum() and not got[3][4].any()


def test_stage_timer_report_matches_jax():
    for stages in ({"track": [(0.25, 4)]},
                   {"person_detect": [(0.5, 2)], "pose_detect": [(0.75, 3)],
                    "track": [(0.125, 1), (0.5, 8)], "decode_wait": [(0.03, 3)]},
                   {"decode_work": [(1.5, 10)], "decode_wait": [(0.2, 10)]},
                   {}):
        j, t = jtime.StageTimer(), ttime.StageTimer()
        for stage, adds in stages.items():
            for seconds, count in adds:
                j.add(stage, seconds, count)
                t.add(stage, seconds, count)
        for views in (1, 3, 5):
            assert t.report(num_views=views) == j.report(num_views=views)
    t = ttime.StageTimer()
    with t.time("track", block_on=(torch.zeros(2), [torch.ones(1)])):
        pass
    assert t.counts == {"track": 1} and t.totals["track"] >= 0.0


def test_profiler_trace(tmp_path):
    with ttime.profiler_trace(None):
        pass
    with ttime.profiler_trace(str(tmp_path / "trace")):
        (torch.ones(8) * 2).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]


def test_draw_skeleton_overlay_matches_jax():
    rng = np.random.default_rng(7)
    for pid in range(4):
        img = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
        pose = rng.uniform(-10, 90, (17, 2))
        scores = rng.uniform(size=17)
        ref = jviz.draw_skeleton_overlay(img.copy(), pose, scores, pid, 0.3)
        got = tviz.draw_skeleton_overlay(img.copy(), pose, scores, pid, 0.3)
        np.testing.assert_array_equal(got, ref)
        assert (got != img).any()
