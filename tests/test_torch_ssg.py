"""The PyTorch port's PointNet++ SSG against the JAX package, on the CPU.

The JAX model is initialised from a seed, its BatchNorm scale, bias and
statistics are moved away from the identity in numpy (a fresh BatchNorm
would hide a mapping error), and its variables are converted with the
port's utils/weights.py and loaded with strict=True. Eval logits agree to
2e-4 (PARITY.md §7's band for torch-vs-JAX parity).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from pointcloud_bridge_tpu.utils.torch_import import convert_state_dict
from pointcloud_bridge_tpu_torch.models import PointNet2SSG, get_model
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

SA_NPOINTS = (128, 32, 8)


def randomize_bn(variables, seed=0):
    """Numpy copy of variables with every BatchNorm away from identity."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def walk(p, s):
        for key in s:
            if "mean" in s[key]:
                c = s[key]["mean"].shape
                s[key]["mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
                s[key]["var"] = (0.5 + rng.uniform(size=c)).astype(np.float32)
                p[key]["scale"] = (0.5 + rng.uniform(size=c)).astype(np.float32)
                p[key]["bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
            else:
                walk(p[key], s[key])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def ssg():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(size=(2, 512, 3)).astype(np.float32)
    rgb = rng.uniform(size=(2, 512, 3)).astype(np.float32)
    jmodel = JaxSSG(num_classes=5, sa_npoints=SA_NPOINTS)
    # jitted: eager init/apply dispatch op by op and take ~10x longer
    variables = jax.jit(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False)
    )(jnp.asarray(xyz), jnp.asarray(rgb))
    variables = randomize_bn(variables)
    want = np.asarray(
        jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
            variables, jnp.asarray(xyz), jnp.asarray(rgb)
        )
    )
    return variables, xyz, rgb, want


def test_ssg_eval_logits_match_jax(ssg):
    variables, xyz, rgb, want = ssg
    model = get_model("pointnet2_ssg", num_classes=5, sa_npoints=SA_NPOINTS)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), torch.from_numpy(rgb))
    assert got.shape == (2, 512, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() == 1.0


def test_state_dict_round_trips_through_convert_state_dict(ssg):
    """port state_dict -> the JAX package's convert_state_dict gives back
    the original flax variables, leaf for leaf."""
    variables = ssg[0]
    model = PointNet2SSG(num_classes=5, sa_npoints=SA_NPOINTS)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_state_dict("pointnet2_ssg", sd, strict=True)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize(
    "key,shape",
    [
        ("sa1.mlp_convs.0.weight", (64, 6, 1, 1)),
        ("sa3.mlp_convs.2.weight", (512, 256, 1, 1)),
        ("sa2.mlp_bns.1.running_var", (128,)),
        ("fp3.mlp_convs.0.weight", (256, 768, 1)),
        ("fp1.mlp_convs.2.weight", (128, 128, 1)),
        ("conv1.weight", (128, 128, 1)),
        ("bn1.running_mean", (128,)),
        ("conv2.weight", (13, 128, 1)),
        ("conv2.bias", (13,)),
    ],
)
def test_parameter_names_and_shapes_follow_reference(key, shape):
    sd = PointNet2SSG(num_classes=13).state_dict()
    assert tuple(sd[key].shape) == shape


def test_generator_makes_weights_reproducible():
    a = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(3))
    b = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(3))
    c = get_model("pointnet2_ssg", 5, generator=torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(
        a.state_dict().items(), b.state_dict().values(), c.state_dict().values()
    ):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)


def test_unported_model_raises_not_implemented():
    """No name of the JAX registry is left unported (``randlanet`` builds);
    a name outside the registry raises ValueError."""
    assert get_model("randlanet", num_classes=5) is not None
    with pytest.raises(ValueError, match="unknown model"):
        get_model("randlanet_v2", num_classes=5)


def test_train_mode_forward_updates_batch_stats(rng):
    """Train mode: finite logits of the right shape, BN running stats move
    (momentum 0.1), dropout active; eval mode is deterministic."""
    model = PointNet2SSG(num_classes=4, sa_npoints=(32, 16, 8),
                         generator=torch.Generator().manual_seed(0))
    xyz = torch.from_numpy(rng.uniform(size=(2, 64, 3)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(size=(2, 64, 3)).astype(np.float32))
    before = model.sa1.mlp_bns[0].running_mean.clone()
    model.train()
    out = model(xyz, rgb)
    assert out.shape == (2, 64, 4) and torch.isfinite(out).all()
    assert not torch.equal(model.sa1.mlp_bns[0].running_mean, before)
    assert model.sa1.mlp_bns[0].momentum == 0.1 and model.bn1.eps == 1e-5
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(xyz, rgb), model(xyz, rgb))
