"""The PyTorch port's PointNet++ MSG (``pointnet2_msg``, the Partsize
9-channel model) against the JAX package, on the CPU.

The JAX model is initialised from a seed, its BatchNorms moved away from the
identity (tests/test_torch_ssg.py ``randomize_bn``), its variables converted
with the port's utils/weights.py and loaded with strict=True. Eval logits
agree to 2e-4 (PARITY.md §7), the FPS picks and ball indices of an MSG level
bit for bit. A reference-layout state_dict (each branch's first conv over
[features, rel-xyz]) goes through the JAX package's ``convert_state_dict``
and the port's ``flax_to_state_dict`` and comes back bit for bit, and the
port loads it as it stands: the port applies that conv with its columns
rolled. The train step and the recipe through the CLIs are in
tests/test_torch_msg_train.py.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import ops as jops
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models.common import MultiScaleSetAbstractionMsg as JaxMsg
from pointcloud_bridge_tpu.utils.torch_import import convert_state_dict, validate_variables
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.models import (
    MultiScaleSetAbstractionMsg,
    PointNet2MSG,
    get_model,
)
from pointcloud_bridge_tpu_torch.models.common import FeatFirstConv
from pointcloud_bridge_tpu_torch.ops.grouping import _query_ball_radii
from pointcloud_bridge_tpu_torch.utils.weights import (
    _msg_level,
    flax_to_state_dict,
    state_dict_to_flax,
)

from test_torch_ssg import randomize_bn

# sa2 of pointnet2_msg: 256 centres, radii (0.1, 0.2), K (16, 32), 96 channels in
LEVEL = dict(npoint=256, radius_list=(0.1, 0.2), nsample_list=(16, 32),
             mlp_list=((64, 64, 128), (64, 96, 128)))


def _jit_init_apply(jmodel, xyz, feats):
    """Variables (BatchNorms randomised) and eval output of a JAX module;
    jitted, as eager init and apply take ~10x longer."""
    x = jnp.asarray(xyz)
    f = None if feats is None else jnp.asarray(feats)
    variables = randomize_bn(
        jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(x, f))
    out = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, x, f)
    return variables, jax.tree_util.tree_map(np.asarray, out)


# -------------------------------------------------------------- one MSG level


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(size=(2, 1024, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 1024, 96)).astype(np.float32)
    variables, (new_xyz, out) = _jit_init_apply(JaxMsg(**LEVEL), xyz, feats)
    return variables, xyz, feats, new_xyz, out


def _port_level(variables):
    layer = MultiScaleSetAbstractionMsg(LEVEL["npoint"], LEVEL["radius_list"],
                                        LEVEL["nsample_list"], 3 + 96, LEVEL["mlp_list"])
    nested = {k: {"sa2": v} for k, v in variables.items()}
    sd = flax_to_state_dict(nested, _msg_level(2, len(LEVEL["mlp_list"])))
    layer.load_state_dict({k[len("sa2."):]: v for k, v in sd.items()}, strict=True)
    return layer.eval()


def test_msg_level_matches_jax(level):
    variables, xyz, feats, new_xyz, want = level
    with torch.no_grad():
        got_xyz, got = _port_level(variables)(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert got.shape == (2, 256, 256) and want.shape == got.shape
    np.testing.assert_array_equal(got_xyz.numpy(), new_xyz)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_msg_level_fps_and_balls_are_bit_identical(level):
    """FPS picks of the level and each radius's ball indices, from the one
    multi-radius query the layer makes, against the JAX ops."""
    _, xyz, _, _, _ = level
    fps = ops.farthest_point_sample(torch.from_numpy(xyz), 256)
    np.testing.assert_array_equal(
        fps.numpy(), np.asarray(jops.farthest_point_sample(jnp.asarray(xyz), 256)))
    centres = ops.index_points(torch.from_numpy(xyz), fps)
    balls = tuple(zip(LEVEL["radius_list"], LEVEL["nsample_list"]))
    for (r, k), idx in zip(balls, _query_ball_radii(balls, torch.from_numpy(xyz), centres)):
        want = jops.query_ball_point(r, k, jnp.asarray(xyz), jnp.asarray(centres.numpy()))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


@pytest.mark.parametrize("in_ch", [7, 3])
def test_featfirst_conv_applies_the_weight_to_xyz_first_input(in_ch):
    """Weight columns [f0..f3, x, y, z] meet input columns [x, y, z, f0..f3];
    with no features (3 columns) the order is the same."""
    conv = FeatFirstConv(in_ch, 2, 2)
    x = torch.randn(5, in_ch)
    w = conv.weight.flatten(1)
    want = x[:, 3:] @ w[:, :in_ch - 3].T + x[:, :3] @ w[:, in_ch - 3:].T + conv.bias
    torch.testing.assert_close(conv(x), want)


# ------------------------------------------------------------ the whole model


@pytest.fixture(scope="module", params=[(1, 1280, 9), (2, 512, 3)],
                ids=["B1_N1280_9ch", "B2_N512_fps_past_n"])
def msg(request):
    """(variables, xyz, feats, JAX logits) at B=1, N=1280 with 9 channels
    (the JAX package's own parity size) and at N=512 < 1024, where FPS runs
    past N."""
    b, n, c = request.param
    rng = np.random.default_rng(8)
    block = rng.uniform(size=(b, n, 3 + c)).astype(np.float32)
    xyz, feats = block[..., :3].copy(), block[..., 3:].copy()
    variables, want = _jit_init_apply(jax_get_model("pointnet2_msg", 5), xyz, feats)
    return variables, xyz, feats, want


def test_msg_eval_logits_match_jax(msg):
    variables, xyz, feats, want = msg
    model = get_model("pointnet2_msg", 5, in_features=feats.shape[-1])
    model.load_state_dict(flax_to_state_dict(variables, "pointnet2_msg"), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert got.shape == want.shape == xyz.shape[:2] + (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() == 1.0


def test_msg_weights_round_trip_exactly_and_completely(msg):
    variables = msg[0]
    sd = flax_to_state_dict(variables, "pointnet2_msg")
    model = PointNet2MSG(in_features=msg[2].shape[-1])
    assert set(sd) == set(model.state_dict())
    back = state_dict_to_flax(sd, "pointnet2_msg")
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


@pytest.fixture(scope="module")
def reference_sd():
    """A state_dict in the reference's layout: random arrays under the
    names and shapes of the JAX package's ``_rules_pointnet2_msg``, each
    branch's first conv [O, feats + 3, 1, 1], at 9 input channels."""
    rng = np.random.default_rng(5)
    shapes = {k: tuple(v.shape) for k, v in PointNet2MSG(in_features=9).state_dict().items()}
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = np.zeros((), np.int64)
        elif key.endswith("running_var"):
            sd[key] = (0.5 + rng.uniform(size=shape)).astype(np.float32)
        else:
            sd[key] = rng.normal(scale=0.3, size=shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("key,shape", [
    ("sa1.conv_blocks.0.0.weight", (16, 12, 1, 1)),
    ("sa1.conv_blocks.1.2.weight", (64, 32, 1, 1)),
    ("sa2.conv_blocks.1.0.weight", (64, 99, 1, 1)),
    ("sa3.conv_blocks.0.1.weight", (196, 128, 1, 1)),
    ("sa4.conv_blocks.1.0.weight", (256, 515, 1, 1)),
    ("sa4.bn_blocks.1.1.running_var", (384,)),
    ("fp4.mlp_convs.0.weight", (256, 1536, 1)),
    ("fp2.mlp_convs.0.weight", (256, 352, 1)),
    ("fp1.mlp_bns.2.running_mean", (128,)),
    ("conv1.weight", (128, 128, 1)),
    ("conv2.weight", (5, 128, 1)),
])
def test_parameter_names_and_shapes_follow_reference(key, shape):
    assert tuple(PointNet2MSG(in_features=9).state_dict()[key].shape) == shape


def test_reference_layout_comes_back_bit_for_bit(reference_sd):
    """JAX ``convert_state_dict`` (strict: every key used) then the port's
    ``flax_to_state_dict``: the same arrays, so "conv2d_featfirst" is the
    exact inverse of the JAX package's "conv_featfirst"."""
    variables = convert_state_dict("pointnet2_msg", reference_sd, strict=True)
    back = flax_to_state_dict(variables, "pointnet2_msg")
    assert set(back) == set(reference_sd)
    for key, want in reference_sd.items():
        np.testing.assert_array_equal(back[key].numpy(), want, err_msg=key)


def test_reference_layout_loads_unchanged_and_matches_jax(reference_sd):
    """The port loads the reference-layout state_dict as it stands and gives
    the logits the JAX model gives with the JAX conversion of it: a port
    that dropped the roll of the first conv's columns fails here."""
    rng = np.random.default_rng(9)
    block = rng.uniform(size=(1, 1100, 12)).astype(np.float32)
    xyz, feats = block[..., :3].copy(), block[..., 3:].copy()
    jmodel = jax_get_model("pointnet2_msg", 5)
    variables = convert_state_dict("pointnet2_msg", reference_sd, strict=True)
    init = jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(
        jnp.asarray(xyz), jnp.asarray(feats))
    validate_variables(variables, init)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(xyz), jnp.asarray(feats)))
    model = PointNet2MSG(in_features=9)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in reference_sd.items()},
                          strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


# ------------------------------------------------------------ weight plumbing


@pytest.mark.parametrize("in_features,width", [(3, 6), (9, 12), (0, 3)])
def test_in_features_sets_the_first_conv_width(in_features, width):
    model = PointNet2MSG(in_features=in_features)
    for b in (0, 1):
        assert model.sa1.conv_blocks[b][0].weight.shape[1] == width
    assert model.sa2.conv_blocks[0][0].weight.shape[1] == 3 + 96


def test_default_takes_the_colours_the_clis_feed():
    model = get_model("pointnet2_msg", 5, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = model(torch.rand(1, 300, 3), torch.rand(1, 300, 3))
    assert out.shape == (1, 300, 5) and torch.isfinite(out).all()


@pytest.mark.parametrize("arg", ["axis_name", "sp_axis"])
def test_unported_arguments_raise(arg):
    """axis_name syncs every BatchNorm; sp_axis slices every level's
    queries over that mesh axis, and a forward raises where no mesh bound
    the axis, as the JAX model raises on an unbound axis name."""
    from test_torch_cls_models import all_bns_synced

    if arg == "axis_name":
        assert all_bns_synced(get_model("pointnet2_msg", 5, axis_name="data"), "data")
    else:
        model = get_model("pointnet2_msg", 5, **{arg: "unbound_sp"}).eval()
        assert all(getattr(model, f"sa{i}").sp_axis == "unbound_sp" for i in range(1, 5))
        assert model.fp1.sp_axis == "unbound_sp" and not model.fp1.sp_gather
        with torch.no_grad(), pytest.raises(RuntimeError, match="bound to no process group"):
            model(torch.rand(1, 64, 3), torch.rand(1, 64, 3))
    get_model("pointnet2_msg", 5, **{arg: None})


def test_generator_makes_weights_reproducible():
    a, b, c = (get_model("pointnet2_msg", 5, generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.sa1.conv_blocks[0][0].weight, c.sa1.conv_blocks[0][0].weight)


def test_train_mode_moves_the_batch_statistics_and_drops_out():
    model = get_model("pointnet2_msg", 5, generator=torch.Generator().manual_seed(0))
    xyz, rgb = torch.rand(2, 200, 3), torch.rand(2, 200, 3)
    before = model.sa3.bn_blocks[1][2].running_mean.clone()
    out = model.train()(xyz, rgb)
    assert out.shape == (2, 200, 5) and torch.isfinite(out).all()
    assert not torch.equal(model.sa3.bn_blocks[1][2].running_mean, before)
    assert model.drop1.p == 0.5
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(xyz, rgb), model(xyz, rgb))


def test_train_mode_forward_at_64_points_holds_to_the_jax_float64_forward():
    """At N = 64 (sa1's 1024 centres past N, every level's BatchNorm over few
    distinct rows) the JAX float32 model in train mode parts from its own
    float64 forward by ~0.024 in its logits: flax's BatchNorm takes the
    variance as E[x^2] - E[x]^2 (``use_fast_variance``), which cancels in
    float32. The port's float32 forward (``F.batch_norm``) is held to the
    JAX float64 train-mode forward within 1e-3 of max|logit|, and its
    updated statistics within 1e-5 of max|stat| (B = 2, 6 feature channels,
    dropout 0)."""
    rng = np.random.default_rng(64)
    block = rng.uniform(size=(2, 64, 9)).astype(np.float32)
    xyz, feats = block[..., :3].copy(), block[..., 3:].copy()
    jmodel = jax_get_model("pointnet2_msg", 5, dropout_rate=0.0)
    variables = randomize_bn(jax.jit(lambda a, b: jmodel.init(
        jax.random.PRNGKey(0), a, b, train=False))(jnp.asarray(xyz), jnp.asarray(feats)))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        logits, mut = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=True,
                                                           mutable=["batch_stats"]))(
            v64, xyz.astype(np.float64), feats.astype(np.float64))
        want = np.asarray(logits, np.float64)  # the head's last Dense casts to float32
        want_stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
    finally:
        jax.config.update("jax_enable_x64", x64)
    model = get_model("pointnet2_msg", 5, in_features=6, dropout_rate=0.0)
    model.load_state_dict(flax_to_state_dict(variables, "pointnet2_msg"), strict=True)
    got = model.train()(torch.from_numpy(xyz), torch.from_numpy(feats)).detach().double().numpy()
    assert got.shape == want.shape == (2, 64, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    stats = state_dict_to_flax(model.state_dict(), "pointnet2_msg")["batch_stats"]
    for path, ref in jax.tree_util.tree_leaves_with_path(want_stats):
        leaf = np.asarray(dict(jax.tree_util.tree_leaves_with_path(stats))[path], np.float64)
        np.testing.assert_allclose(leaf, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=jax.tree_util.keystr(path))
