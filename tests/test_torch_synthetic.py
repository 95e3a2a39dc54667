"""The port's adversarial scene generators against the JAX package's: the
same numpy draws from the same seed, so every field is exactly equal."""
import numpy as np
import pytest

import tpupose.data.synthetic as js
import tpupose_torch.data.synthetic as ts

FIELDS = ("P", "K", "RT", "gt3d", "gt2d", "detections", "visible")

CASES = {
    "adversarial_default": ("make_adversarial_scene",
                            dict(num_frames=12, num_cameras=4, seed=3)),
    "adversarial_fp_drops": ("make_adversarial_scene",
                             dict(num_frames=10, num_cameras=5, num_actors=4,
                                  fp_per_view=2, drop_prob=0.3, seed=7)),
    "adversarial_two_views_unshuffled": ("make_adversarial_scene",
                                         dict(num_frames=9, num_cameras=3, drop_prob=0.5,
                                              enforce_two_views=True, shuffle=False,
                                              crossing=False, seed=1)),
    "continuous_bench_stream": ("make_continuous_adversarial_scene",
                                dict(num_frames=16, num_cameras=5, num_actors=3,
                                     noise_px=1.5, seed=1)),
    "continuous_fp_unshuffled": ("make_continuous_adversarial_scene",
                                 dict(num_frames=8, num_cameras=4, fp_per_view=1,
                                      fp_score=0.9, drop_prob=0.2, shuffle=False,
                                      occlusion_px=80.0, seed=5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scene_equals_jax(name):
    fn, kw = CASES[name]
    ref, got = getattr(js, fn)(**kw), getattr(ts, fn)(**kw)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field),
                                      err_msg=field)
        assert getattr(got, field).dtype == getattr(ref, field).dtype, field
    assert (got.width, got.height) == (ref.width, ref.height)
    # the scene really is adversarial: some actor view is lost
    assert not got.visible.all() or kw.get("fp_per_view")
