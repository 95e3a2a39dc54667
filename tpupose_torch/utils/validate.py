"""Runtime validation: non-finite guards and tracker-state invariants.

Counterpart of `tpupose/utils/validate.py`. The reference's robustness is
numeric epsilons (`c==0 -> 1e-5`, `F += 1e-12`, `norm==0 -> 1`), kept as
guards in the geometry. These are debug aids on top: both read tensors on
the host, so neither belongs on the sync-free tracker path
(`tracking.tracker.tracker_step` reads nothing on the host).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensors(out):
    """Every tensor in a nest of tuples, lists, dicts and NamedTuples."""
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def checked_finite(fn):
    """`fn` wrapped to raise FloatingPointError when a floating tensor of
    its output holds a NaN or an infinity. Each call reads one flag per
    tensor on the host.

    Usage:
        out = checked_finite(step)(args...)
    """

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"non-finite value in output of {getattr(fn, '__name__', fn)}")
        return out

    return wrapped


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def assert_tracker_invariants(state, cfg):
    """Structural checks on a `TrackerState` (read on the host); raises
    AssertionError naming the first that fails."""
    active = state.active.cpu().numpy()
    ids = state.track_id.cpu().numpy()
    counts = state.hist_count.cpu().numpy()
    hits = state.hits.cpu().numpy()
    tsu = state.time_since_update.cpu().numpy()
    confirmed = state.confirmed.cpu().numpy()

    live_ids = ids[active]
    _check(len(set(live_ids.tolist())) == len(live_ids), "duplicate track ids")
    _check(np.all(live_ids >= 0), "active track with unset id")
    _check(np.all(live_ids < int(state.next_id)), "id >= next_id")
    _check(np.all(counts[active] >= 1), "active track with empty history")
    _check(np.all(counts <= cfg.hist_len), "history overflow")
    _check(np.all(hits[active] >= 1), "active track with zero hits")
    _check(np.all(tsu[active] >= 0), "active track with negative time since update")
    # confirmed implies enough hits
    _check(np.all(hits[active & confirmed] >= cfg.n_init), "confirmed with too few hits")
    # history timestamps strictly increasing within the valid range
    ht = state.hist_time.cpu().numpy()
    poses = state.hist_pose.cpu().numpy()
    for i in np.where(active)[0]:
        _check(np.all(np.diff(ht[i, : counts[i]]) > 0), f"non-monotonic history for slot {i}")
        _check(np.isfinite(poses[i, : counts[i]]).all(), f"NaN pose in slot {i}")
