"""The PyTorch port's whole-scene vote inference against the JAX package's,
on the CPU, with the same weights, the same scene and the same seed.

Both draw each vote's pad-resampling from numpy at ``seed + 1009 * vote``,
so they classify the same blocks; with random weights a point whose two best
logits are within float32 rounding can flip, hence agreement on >= 99.9% of
the points rather than all, equal vote mass a point, and mIoU within 1e-3.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.data import scene_labelweights
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.infer import whole_scene_vote_predict as jax_vote
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch.infer import whole_scene_vote_predict
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

from test_torch_bristrunet import randomize

MODELS = {
    "pointnet2_ssg": {"sa_npoints": (32, 16, 8)},
    "bristrunet": {"sa_npoints": (32, 16, 8)},
    # 128-point blocks: level 0 in four windows of 32, levels 1 and 2 (32 and
    # 8 points) global; the registry's depths, so its rule table applies
    "ptv3_pooled": {"dims": (32, 64, 128), "head_dim": 16, "window_size": 32},
}
GRID = dict(num_classes=5, block_points=128, block_size=6.0, stride=3.0,
            num_votes=2, batch_size=8, seed=3)


@pytest.fixture(scope="module")
def scene():
    xyz, rgb, labels = toy_bridge_scene(6000, seed=0)
    pts6 = np.concatenate([xyz, rgb], axis=1).astype(np.float32)
    return pts6, labels, scene_labelweights([labels], 5)


def both_models(name, in_features=3):
    jmodel = jax_get_model(name, 5, **MODELS[name])
    x0 = jnp.zeros((1, 128, 3))
    f0 = jnp.zeros((1, 128, in_features))
    variables = randomize(jax.jit(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(x0, f0))
    kwargs = dict(MODELS[name])
    if in_features != 3:
        kwargs["in_features"] = in_features
    model = get_model(name, 5, **kwargs)
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    return jmodel, variables, model


def assert_votes_agree(got, want, n):
    assert got["pred"].shape == (n,) and got["pred"].dtype == np.int32
    assert got["vote_pool"].shape == (n, 5) and got["vote_pool"].dtype == np.float64
    assert (got["pred"] == want["pred"]).mean() >= 0.999
    np.testing.assert_allclose(got["vote_pool"].sum(1), want["vote_pool"].sum(1), rtol=1e-12)
    assert (got["vote_pool"].sum(1) > 0).all()  # every point was voted on
    assert abs(got["metrics"]["mIoU"] - want["metrics"]["mIoU"]) <= 1e-3
    assert abs(got["metrics"]["OA"] - want["metrics"]["OA"]) <= 1e-3


@pytest.mark.parametrize("name", sorted(MODELS))
def test_vote_matches_jax(scene, name):
    pts6, labels, lw = scene
    jmodel, variables, model = both_models(name)
    want = jax_vote(jmodel, variables, pts6, labels, lw, **GRID)
    got = whole_scene_vote_predict(model, pts6, labels, lw, **GRID)
    assert_votes_agree(got, want, len(pts6))
    assert "timings" not in got


def test_vote_normalized_scene_matches_jax(scene):
    pts6, labels, lw = scene
    jmodel, variables, model = both_models("pointnet2_ssg")
    kw = dict(GRID, block_size=0.5, stride=0.25, normalize_scene=True)
    want = jax_vote(jmodel, variables, pts6, labels, lw, **kw)
    before = pts6.copy()
    got = whole_scene_vote_predict(model, pts6, labels, lw, **kw)
    assert_votes_agree(got, want, len(pts6))
    np.testing.assert_array_equal(pts6, before)  # the caller's scene is untouched


def test_vote_nine_channel_mode_matches_jax(scene):
    pts6, labels, lw = scene
    jmodel, variables, model = both_models("pointnet2_ssg", in_features=9)
    kw = dict(GRID, feature_mode="nine")
    want = jax_vote(jmodel, variables, pts6, labels, lw, **kw)
    got = whole_scene_vote_predict(model, pts6, labels, lw, **kw)
    assert_votes_agree(got, want, len(pts6))


def test_vote_timings_and_seed(scene):
    pts6, labels, lw = scene
    model = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(0),
                      **MODELS["pointnet2_ssg"])
    a = whole_scene_vote_predict(model, pts6, labels, lw,
                                 collect_timings=True, **GRID)
    t = a["timings"]
    assert t["table_upload_s"] >= 0
    for key in ("grid_s", "h2d_s", "dispatch_s", "fetch_s", "scatter_s"):
        assert len(t[key]) == GRID["num_votes"] and all(v >= 0 for v in t[key]), key
    b = whole_scene_vote_predict(model, pts6, labels, lw, **GRID)
    np.testing.assert_array_equal(a["vote_pool"], b["vote_pool"])  # same seed, same votes
    c = whole_scene_vote_predict(model, pts6, labels, lw, **dict(GRID, seed=4))
    assert not np.array_equal(a["vote_pool"], c["vote_pool"])


def test_vote_refuses_an_unknown_feature_mode(scene):
    pts6, labels, lw = scene
    model = get_model("pointnet2_ssg", 5, **MODELS["pointnet2_ssg"])
    with pytest.raises(ValueError, match="feature_mode"):
        whole_scene_vote_predict(model, pts6, labels, lw, 5, feature_mode="six")
