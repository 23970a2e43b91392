"""The port's model registry against the JAX package's: every name of the
JAX registry resolves to the port's class of the same name and has weight
rules, a name outside the registry raises ValueError, and the reference
name ``pointnet2`` builds, takes converted weights and serves like
``pointnet2_ssg``."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.data import BlockDataset, make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.infer.blocks import run_block_inference as jax_run_block_inference
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from pointcloud_bridge_tpu_torch.infer import run_block_inference
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY
from pointcloud_bridge_tpu_torch.utils.weights import MODEL_RULES, flax_to_state_dict

from test_torch_ssg import randomize_bn

SA_NPOINTS = (64, 32, 16)


def _jax_class_name(ctor):
    """The class name behind a registry entry; a partial, a configuration of
    a class, by its class and its arguments."""
    if isinstance(ctor, functools.partial):
        return ctor.func.__name__, tuple(sorted(ctor.keywords.items()))
    return ctor.__name__


# the classes (and configurations of classes) the port has, by the name
# both packages give them
PORTED_CLASSES = {_jax_class_name(ctor) for ctor in MODEL_REGISTRY.values()}


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_jax_registry_name_resolves_or_raises(name):
    """Every name resolves: to the class (or configuration of a class) of
    the same name, with weight rules, and it builds."""
    jax_name = _jax_class_name(JAX_REGISTRY[name])
    assert jax_name in PORTED_CLASSES
    assert _jax_class_name(MODEL_REGISTRY[name]) == jax_name
    assert name in MODEL_RULES
    model = get_model(name, 5)
    assert type(model).__name__ == (jax_name if isinstance(jax_name, str) else jax_name[0])


def test_the_port_knows_no_name_the_jax_registry_lacks():
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert set(MODEL_RULES) == set(MODEL_REGISTRY)


def test_the_port_serves_twenty_of_the_twenty_six_names():
    """All 26 of the JAX registry's names are served, RandLA-Net and the
    superpoint models among them, and every one has weight rules."""
    assert len(JAX_REGISTRY) == 26 and len(MODEL_REGISTRY) == 26
    assert {"randlanet", "randlanet_ss", "spg", "spt", "superpoint_graph",
            "superpoint_transformer"} <= set(MODEL_REGISTRY)
    assert MODEL_RULES.keys() == MODEL_REGISTRY.keys()


def test_unknown_name_raises_value_error():
    with pytest.raises(ValueError, match="unknown model"):
        get_model("no_such_model", 5)


def test_pointnet2_builds_converts_weights_and_serves():
    """``pointnet2`` is the reference's name for the SSG model: the JAX
    variables convert under that name, load strictly, and block inference
    gives the JAX package's predictions."""
    blocks = make_training_blocks(
        *toy_bridge_scene(8000, seed=0), num_points=256, block_size=4.0, sample_rate=0.3,
        file_name="scene0", seed=0,
    )[:4]
    ds = BlockDataset.from_blocks(blocks, ["scene0"])
    jmodel = jax_get_model("pointnet2", 5, sa_npoints=SA_NPOINTS)
    x0, c0 = jnp.asarray(ds.points[:1]), jnp.asarray(ds.colors[:1])
    variables = randomize_bn(
        jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(2), a, b, train=False))(x0, c0)
    )
    want = jax_run_block_inference(jmodel, variables, ds, num_classes=5, batch_size=4)
    model = get_model("pointnet2", 5, sa_npoints=SA_NPOINTS)
    assert type(model) is type(get_model("pointnet2_ssg", 5, sa_npoints=SA_NPOINTS))
    model.load_state_dict(flax_to_state_dict(variables, "pointnet2"), strict=True)
    got = run_block_inference(model, ds, num_classes=5, batch_size=4)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert got["global"]["OA"] == want["global"]["OA"]
    assert torch.isfinite(torch.as_tensor(got["global"]["mIoU"]))
