"""The PyTorch port's Partsize extras against the JAX package, on the CPU:
``pointnet2_sem_seg`` (the 4-level SSG segmentation model) and the two
PointNet++ classifiers ``pointnet2_cls_ssg`` and ``pointnet2_cls_msg``.

As tests/test_torch_msg.py: the JAX model initialised from a seed, its
BatchNorms moved away from the identity, its variables converted with the
port's utils/weights.py and loaded strictly; eval logits within 2e-4. The
classifiers run at B = 2, since their FC BatchNorms normalise over the
batch alone in train mode, with and without colours (``in_features`` 3 and
0, the JAX signature's ``features=None``).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch.models import (
    PointNet2ClsMSG,
    PointNet2ClsSSG,
    PointNet2SSGPartsize,
    PointNetCls,
    get_model,
)
from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY
from pointcloud_bridge_tpu_torch.utils.weights import (
    MODEL_RULES,
    flax_to_state_dict,
    state_dict_to_flax,
)

from test_torch_ssg import randomize_bn

# (name, B, N, feature channels)
CASES = [
    ("pointnet2_sem_seg", 1, 1280, 9),
    ("pointnet2_sem_seg", 2, 512, 3),
    ("pointnet2_cls_ssg", 2, 1024, 0),
    ("pointnet2_cls_ssg", 2, 1024, 3),
    ("pointnet2_cls_msg", 2, 1024, 0),
    ("pointnet2_cls_msg", 2, 700, 3),
]
IDS = [f"{n}_B{b}_N{p}_{c}ch" for n, b, p, c in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    name, b, n, c = request.param
    rng = np.random.default_rng(11)
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    feats = rng.uniform(size=(b, n, c)).astype(np.float32) if c else None
    jmodel = jax_get_model(name, 5)
    x, f = jnp.asarray(xyz), None if feats is None else jnp.asarray(feats)
    variables = randomize_bn(
        jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(x, f))
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, x, f))
    return name, variables, xyz, feats, want


def test_eval_logits_match_jax(case):
    name, variables, xyz, feats, want = case
    model = get_model(name, 5, in_features=0 if feats is None else feats.shape[-1])
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    per_point = name == "pointnet2_sem_seg"
    assert got.shape == want.shape == (xyz.shape[:2] if per_point else xyz.shape[:1]) + (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_weights_round_trip_exactly_and_completely(case):
    name, variables, _, feats, _ = case
    sd = flax_to_state_dict(variables, name)
    model = get_model(name, 5, in_features=0 if feats is None else feats.shape[-1])
    assert set(sd) == set(model.state_dict())
    back = state_dict_to_flax(sd, name)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


@pytest.mark.parametrize("cls,key,shape", [
    (PointNet2SSGPartsize, "sa1.mlp_convs.0.weight", (32, 6, 1, 1)),
    (PointNet2SSGPartsize, "sa4.mlp_convs.0.weight", (256, 259, 1, 1)),
    (PointNet2SSGPartsize, "fp4.mlp_convs.0.weight", (256, 768, 1)),
    (PointNet2SSGPartsize, "fp2.mlp_convs.0.weight", (256, 320, 1)),
    (PointNet2SSGPartsize, "conv2.weight", (5, 128, 1)),
    (PointNet2ClsSSG, "sa1.mlp_convs.0.weight", (64, 3, 1, 1)),
    (PointNet2ClsSSG, "sa2.mlp_convs.0.weight", (128, 131, 1, 1)),
    (PointNet2ClsSSG, "sa3.mlp_convs.0.weight", (256, 259, 1, 1)),
    (PointNet2ClsSSG, "fc1.weight", (512, 1024)),
    (PointNet2ClsSSG, "bn2.running_var", (256,)),
    (PointNet2ClsSSG, "fc3.weight", (5, 256)),
    (PointNet2ClsMSG, "sa1.conv_blocks.2.0.weight", (64, 3, 1, 1)),
    (PointNet2ClsMSG, "sa2.conv_blocks.0.0.weight", (64, 323, 1, 1)),
    (PointNet2ClsMSG, "sa2.bn_blocks.2.1.weight", (128,)),
    (PointNet2ClsMSG, "sa3.mlp_convs.0.weight", (256, 643, 1, 1)),
    (PointNet2ClsMSG, "fc2.bias", (256,)),
])
def test_parameter_names_and_shapes_follow_reference(cls, key, shape):
    assert tuple(cls(num_classes=5).state_dict()[key].shape) == shape


@pytest.mark.parametrize("name", ["pointnet2_cls_ssg", "pointnet2_cls_msg"])
def test_classifier_train_mode_moves_statistics_and_drops_out(name):
    model = get_model(name, 5, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    xyz = torch.rand(3, 600, 3)
    before = model.bn1.running_mean.clone()
    a = model.train()(xyz)
    b = model(xyz)
    assert a.shape == (3, 5) and torch.isfinite(a).all()
    assert not torch.equal(model.bn1.running_mean, before)
    assert model.drop1.p == model.drop2.p == 0.4
    assert not torch.equal(a, b)  # another dropout mask
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(xyz), model(xyz))


@pytest.mark.parametrize("name,default", [("pointnet2_sem_seg", 3), ("pointnet2_cls_ssg", 0),
                                          ("pointnet2_cls_msg", 0)])
def test_in_features_default_and_refusals(name, default):
    model = get_model(name, 5)
    first = next(p for k, p in model.named_parameters() if k.startswith("sa1.") and
                 k.endswith("weight") and p.dim() == 4)
    assert first.shape[1] == 3 + default
    assert next(p for k, p in get_model(name, 5, in_features=9).named_parameters()
                if k == "sa1." + k.split(".", 1)[1] and p.dim() == 4).shape[1] == 12
    # axis_name (a refusal until the parallel layer was ported) now syncs
    # every BatchNorm over that mesh axis
    assert all_bns_synced(get_model(name, 5, axis_name="data"), "data")


def all_bns_synced(model, axis):
    from pointcloud_bridge_tpu_torch.models import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    return bool(bns) and all(m.axis_name == axis for m in bns)


def test_pointnet_cls_waits_for_pointnet():
    """pointnet_cls waited for PointNet's TNet and is ported with it: the
    registry builds PointNetCls, and its parameters and buffers are named as
    its weight rules say (flax names, a Dense [out, in])."""
    assert MODEL_REGISTRY["pointnet_cls"] is PointNetCls
    model = get_model("pointnet_cls", 5)
    assert isinstance(model, PointNetCls)
    want = set()
    for tp, _, kind in MODEL_RULES["pointnet_cls"]():
        leaves = ("weight", "bias")
        if kind == "bn":
            leaves += ("running_mean", "running_var", "num_batches_tracked")
        want |= {f"{tp}.{leaf}" for leaf in leaves}
    sd = model.state_dict()
    assert set(sd) == want
    assert sd["stn.conv1.weight"].shape == (64, 3) and sd["fstn.fc3.weight"].shape == (4096, 256)
