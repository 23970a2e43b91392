"""The port's export (utils/export.py) and its custom ops (``pcb::``,
ops/_kernels.py ``custom_op``) on the CPU: an SSG program exported, saved,
loaded and run against the port's eager forward and the JAX package's
StableHLO round trip; the graph names the ops, not their plain versions;
each op's fake implementation gives the plain version's shapes and types;
the eager path never goes through an op."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.utils.export import export_stablehlo, load_stablehlo
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.ops import attention, grouping, interpolate, sampling
from pointcloud_bridge_tpu_torch.utils.export import (
    dump_program_text,
    export_program,
    load_program,
)
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_ssg import randomize_bn

SA_NPOINTS = (16, 8, 4)


@pytest.fixture(scope="module")
def ssg():
    """SSG at (1, 64, 3) with sa_npoints (16, 8, 4), as the JAX package's
    export test has it, with BatchNorms away from the identity: the JAX
    variables, the port model on them, and the inputs."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(size=(1, 64, 3)).astype(np.float32)
    feats = rng.uniform(size=(1, 64, 3)).astype(np.float32)
    jmodel = jax_get_model("pointnet2_ssg", num_classes=5, sa_npoints=SA_NPOINTS)
    model = get_model("pointnet2_ssg", 5, sa_npoints=SA_NPOINTS,
                      generator=torch.Generator().manual_seed(0))
    # the JAX tree from the port's (no JAX init to compile)
    variables = randomize_bn(state_dict_to_flax(model.state_dict()))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model.eval(), xyz, feats


def test_exported_ssg_round_trips_and_agrees_with_jax(ssg, tmp_path):
    """The loaded .pt2 gives the port's eager logits exactly, and the JAX
    package's StableHLO round trip's within 1e-5."""
    jmodel, variables, model, xyz, feats = ssg
    path = export_program(model, None, str(tmp_path / "ssg.pt2"), 1, 64, 3)
    program = load_program(path)
    x, f = torch.from_numpy(xyz), torch.from_numpy(feats)
    with torch.no_grad():
        got = program(x, f)
        eager = model(x, f)
    assert got.shape == (1, 64, 5)
    assert torch.equal(got, eager)
    call = load_stablehlo(export_stablehlo(jmodel, variables, str(tmp_path / "ssg.stablehlo"),
                                           1, 64, 3))
    want = np.asarray(call(jnp.asarray(xyz), jnp.asarray(feats)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_program_text_names_the_kernels_ops(ssg, tmp_path):
    """The graph calls pcb::fps, pcb::ball_query, pcb::group and
    pcb::interpolate once a level each, the launches of one eager forward,
    so no plain version was traced in their place; the variables argument
    loads strictly first."""
    _, variables, model, _, _ = ssg
    path = dump_program_text(model, flax_to_state_dict(variables), str(tmp_path / "ssg.txt"),
                             1, 64, 3)
    text = open(path).read()
    for op, count in (("fps", 3), ("ball_query", 3), ("group", 3), ("interpolate", 3)):
        assert text.count(f"torch.ops.pcb.{op}.default(") == count, op
    assert "topk" not in text and "pcb.ball_query_radii" not in text
    assert os.path.getsize(path) > 1000


def _fake_case(name):
    """(op, inputs) of one op at a small shape."""
    g = torch.Generator().manual_seed(1)

    def r(*shape, dtype=torch.float32):
        return torch.rand(*shape, generator=g).to(dtype)

    xyz, centres = r(2, 40, 3), r(2, 10, 3)
    idx = torch.randint(0, 40, (2, 10, 6), generator=g, dtype=torch.int32)
    qkv = r(1, 20, 2, 32)
    return {
        "fps": (sampling.FPS_OP, (xyz, 7, torch.zeros(2, dtype=torch.int32))),
        "ball_query": (grouping.BALL_QUERY_OP, (xyz, centres, 0.3, 6)),
        "ball_query_radii": (grouping.BALL_QUERY_RADII_OP, (xyz, centres, [0.2, 0.4], [5, 9])),
        "group": (grouping.GROUP_OP, (xyz, centres, idx, r(2, 40, 4))),
        "group_no_features": (grouping.GROUP_OP, (xyz, centres, idx, None)),
        "knn": (grouping.KNN_OP, (xyz, centres, 5)),
        "knn_c": (grouping.KNN_C_OP, (r(2, 40, 7), r(2, 10, 7), 5)),
        "interpolate": (interpolate.INTERPOLATE_OP, (xyz, centres, r(2, 10, 9), 3)),
        "attention": (attention.ATTENTION_OP, (qkv, qkv * 0.5, qkv + 1)),
        "attention_bf16": (attention.ATTENTION_OP, tuple(t.to(torch.bfloat16)
                                                         for t in (qkv, qkv * 0.5, qkv + 1))),
        "segment_sum": (grouping.SEGMENT_SUM_OP,
                        (r(30, 5), torch.randint(0, 8, (30,), generator=g), 8)),
    }[name]


@pytest.mark.parametrize("name", ["fps", "ball_query", "ball_query_radii", "group",
                                  "group_no_features", "knn", "knn_c", "interpolate",
                                  "attention", "attention_bf16", "segment_sum"])
def test_fake_implementation_matches_the_plain_version(name):
    """Each op's fake implementation gives exactly the shapes and types of
    its plain version's outputs (lse and the indices included)."""
    op, args = _fake_case(name)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real]


def test_eager_path_does_not_reach_the_ops(monkeypatch):
    """Outside export the models call the wrappers, not the ops: with every
    op replaced by one that raises, the eager SSG, BriStruNet, PTv3 and
    DGCNN forwards still run."""
    def refuse(*args, **kwargs):
        raise AssertionError("an op was called on the eager path")

    for module, name in ((sampling, "FPS_OP"), (grouping, "BALL_QUERY_OP"),
                         (grouping, "BALL_QUERY_RADII_OP"), (grouping, "GROUP_OP"),
                         (grouping, "KNN_OP"), (grouping, "KNN_C_OP"),
                         (interpolate, "INTERPOLATE_OP"), (attention, "ATTENTION_OP")):
        monkeypatch.setattr(module, name, refuse)
    x = torch.rand(1, 128, 3)
    with torch.no_grad():
        for name, kwargs in (("pointnet2_ssg", {"sa_npoints": SA_NPOINTS}),
                             ("bristrunet", {"sa_npoints": (32, 16, 8)}),
                             ("ptv3", {"embed_dim": 64, "depth": 1}),
                             ("dgcnn", {})):
            out = get_model(name, 5, **kwargs).eval()(x, x)
            assert out.shape == (1, 128, 5)
