"""The PyTorch port's PTv3 family (flat and pooled) and its attention op
against the JAX package, on the CPU.

On the CPU the JAX ``_attention`` is ``jax.nn.dot_product_attention`` (its
flash kernel runs on a TPU only) and the port's ``attention`` computes what
``attention_plain`` does: the two plain versions are held together here, the
CUDA kernel against ``attention_plain`` on the card by chip_smoke.py. The
backward is in test_torch_attention_bwd.py, training in
test_torch_ptv3_train.py. Flax modules
are initialised from a seed, perturbed in numpy (fresh biases are zero, a
fresh norm is the identity), converted with utils/weights.py and loaded with
strict=True. Modules agree to 2e-5, whole models to 2e-4 (PARITY.md §7's
band for torch-vs-JAX parity).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pointcloud_bridge_tpu.data import BlockDataset, make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.infer.blocks import run_block_inference as jax_run_block_inference
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import ptv3 as jptv3
from pointcloud_bridge_tpu.models import ptv3_pooled as jpooled
from pointcloud_bridge_tpu_torch.infer import run_block_inference
from pointcloud_bridge_tpu_torch.models import (
    GEGLU,
    BatchNorm,
    Dense,
    FeedForward,
    PointAttention,
    PointTransformerBlock,
    PointTransformerV3,
    PointTransformerV3Pooled,
    SerializedPool,
    SerializedUnpool,
    get_model,
    morton_code,
)
from pointcloud_bridge_tpu_torch.models.ptv3 import serialize
from pointcloud_bridge_tpu_torch.ops import attention as attn_ops
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    ptv3_pooled_rules,
    ptv3_rules,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize

MODULE_TOL = 2e-5
MODEL_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def module_rules(module):
    """Rules of a port module whose layer names are the flax names."""
    kinds = ((Dense, "dense"), (BatchNorm, "bn"), (nn.LayerNorm, "ln"))
    return [(name, tuple(name.split(".")), kind)
            for name, m in module.named_modules()
            for cls, kind in kinds if isinstance(m, cls)]


def run_both(jmodule, tmodule, *arrays, **jkw):
    """Init the flax module on ``arrays``, randomise, load the converted
    weights into the port module -> (port output, JAX output)."""
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    variables = randomize(
        jax.jit(lambda *a: jmodule.init(jax.random.PRNGKey(0), *a, **jkw))(*jargs))
    want = jax.jit(lambda v, *a: jmodule.apply(v, *a, **jkw))(variables, *jargs)
    tmodule.load_state_dict(flax_to_state_dict(variables, module_rules(tmodule)), strict=True)
    tmodule.eval()
    with torch.inference_mode():
        got = tmodule(*[None if a is None else _t(a) for a in arrays])
    return got, want


def assert_close(got, want, tol=MODULE_TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # not a dead output
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# ------------------------------------------------------------ serialisation


def _clouds(kind, rng):
    xyz = rng.uniform(-3.0, 5.0, size=(3, 256, 3)).astype(np.float32)
    if kind == "repeated":  # padded blocks repeat points: equal keys
        xyz[:, 128:] = xyz[:, :128]
        xyz[1, :64] = xyz[1, 0]
    elif kind == "planar":  # an axis of zero extent
        xyz[..., 2] = 1.5
        xyz[2, :, 0] = -0.25
    elif kind == "grid":  # coarse coordinates: many ties and exact extremes
        xyz = rng.integers(0, 5, size=(3, 256, 3)).astype(np.float32)
    return xyz


@pytest.mark.parametrize("kind", ["random", "repeated", "planar", "grid"])
def test_morton_code_and_order_equal_jax_bit_for_bit(rng, kind):
    xyz = _clouds(kind, rng)
    want = np.asarray(jptv3.morton_code(jnp.asarray(xyz)))
    got = morton_code(_t(xyz))
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if kind != "random":
        assert any(len(np.unique(row)) < row.size for row in want)  # keys do tie
    want_order = np.asarray(jnp.argsort(jnp.asarray(want), axis=1))
    order, inv_order = serialize(_t(xyz))
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(inv_order.numpy(), np.argsort(want_order, axis=1))
    rows = np.arange(256)[None].repeat(3, 0)
    np.testing.assert_array_equal(np.take_along_axis(order.numpy(), inv_order.numpy(), 1), rows)


# ---------------------------------------------------------------- attention

ATTENTION_SHAPES = [(2, 256, 2, 32), (2, 128, 2, 192), (8, 64, 4, 32)]


@pytest.mark.parametrize("packed", [False, True], ids=["contiguous", "packed_qkv_views"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=str)
def test_attention_plain_matches_jax(rng, shape, packed):
    b, n, h, d = shape
    qkv = rng.normal(size=(b, n, 3, h, d)).astype(np.float32)
    want = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(qkv[:, :, i]) for i in range(3))))
    if packed:
        q, k, v = _t(qkv).unbind(2)
        assert not q.is_contiguous() and q.stride(1) == 3 * h * d
    else:
        q, k, v = (_t(np.ascontiguousarray(qkv[:, :, i])) for i in range(3))
    got = attn_ops.attention(q, k, v)  # a CPU tensor takes the plain version
    assert got.shape == shape and got.is_contiguous()
    assert torch.equal(got, attn_ops.attention_plain(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_kernel_reads_packed_views_and_window_folds_in_place(rng):
    """What the CUDA wrapper hands the kernel: a slice of the packed qkv
    projection and its window fold as they are (same memory, row stride
    3*H*D), anything else as a contiguous copy."""
    b, n, h, d, w = 2, 256, 2, 32, 64
    qkv = _t(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    for t in qkv.reshape(b, n, 3, h, d).unbind(2):
        assert attn_ops._rows(t) is t and t.stride(1) == 3 * h * d
        fold = t.reshape(b * (n // w), w, h, d)
        assert fold.data_ptr() == t.data_ptr()  # the fold is a view
        assert attn_ops._rows(fold) is fold and fold.stride(1) == 3 * h * d
    odd = torch.empty(b, n, d, h).transpose(2, 3)  # channels not contiguous
    copied = attn_ops._rows(odd)
    assert copied is not odd and copied.is_contiguous()


def test_attention_refuses_what_it_does_not_take(rng):
    q = _t(rng.normal(size=(2, 16, 2, 32)).astype(np.float32))
    with pytest.raises(TypeError, match="float32"):
        attn_ops.attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="one shape"):
        attn_ops.attention(q, q[:, :8], q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_ops.attention_cuda(q, q, q)  # the kernel wrapper never runs on the CPU
    assert 32 in attn_ops.FLASH_HEAD_DIMS and 192 in attn_ops.FLASH_HEAD_DIMS
    assert 16 not in attn_ops.FLASH_HEAD_DIMS


# ------------------------------------------------------------------ modules


def test_geglu_matches_jax(rng):
    x = rng.normal(size=(2, 64, 24)).astype(np.float32)
    got, want = run_both(jptv3.GEGLU(40), GEGLU(24, 40), x)
    assert got.shape == (2, 64, 40)
    assert_close(got, want)


def test_feed_forward_matches_jax(rng):
    x = rng.normal(size=(2, 64, 24)).astype(np.float32)
    got, want = run_both(jptv3.FeedForward(96, 24, 0.1), FeedForward(24, 96, 0.1), x, train=False)
    assert_close(got, want)


@pytest.mark.parametrize("window,with_pos", [(0, True), (64, True), (0, False), (96, True)],
                         ids=["global", "windowed", "no_pos", "window_not_dividing_n"])
def test_point_attention_matches_jax(rng, window, with_pos):
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 256, 32)).astype(np.float32) if with_pos else None
    jm = jptv3.PointAttention(32, 2, window_size=window)
    got, want = run_both(jm, PointAttention(32, 2, window_size=window), x, pos, train=False)
    assert_close(got, want)


def test_point_attention_window_changes_the_result(rng):
    x = _t(rng.normal(size=(1, 128, 32)).astype(np.float32))
    outs = []
    for window in (0, 128, 256, 32):  # one window and a window over N are global
        m = PointAttention(32, 2, window_size=window,
                           generator=torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not torch.allclose(outs[0], outs[3], atol=1e-3)


@pytest.mark.parametrize("window", [0, 64])
def test_point_transformer_block_matches_jax(rng, window):
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 256, 32)).astype(np.float32)
    jm = jptv3.PointTransformerBlock(32, 2, window_size=window)
    tm = PointTransformerBlock(32, 2, window_size=window)
    assert tm.norm1.eps == tm.norm2.eps == 1e-6 and tm.mlp.geglu.proj.weight.shape == (256, 32)
    got, want = run_both(jm, tm, x, pos, train=False)
    assert_close(got, want)


def test_serialized_pool_matches_jax(rng):
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    xyz = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    (h, xyz_c), (want_h, want_xyz) = run_both(
        jpooled.SerializedPool(4, 48), SerializedPool(4, 32, 48), x, xyz)
    assert h.shape == (2, 64, 48)
    assert_close(h, want_h)
    np.testing.assert_allclose(xyz_c.numpy(), np.asarray(want_xyz), rtol=1e-6, atol=1e-6)


def test_serialized_unpool_matches_jax(rng):
    coarse = rng.normal(size=(2, 64, 48)).astype(np.float32)
    skip = rng.normal(size=(2, 256, 32)).astype(np.float32)
    got, want = run_both(jpooled.SerializedUnpool(4, 32), SerializedUnpool(4, 48, 32),
                         coarse, skip)
    assert got.shape == (2, 256, 32)
    assert_close(got, want)


# ------------------------------------------------------------- whole models

FLAT = dict(embed_dim=64, depth=2, num_heads=2)
POOLED = dict(dims=(32, 64, 128), enc_depths=(1, 1, 2), dec_depths=(1, 1), strides=(4, 4),
              window_size=64, head_dim=16)
POOLED_RULES = ptv3_pooled_rules(POOLED["enc_depths"], POOLED["dec_depths"])


_BOTH = {}


def both_models(name, rules, feature_channels=3, **kwargs):
    """The JAX model and the port's with its converted weights, and their
    eval logits on one seeded input; built once a configuration."""
    key = (name, feature_channels, tuple(sorted(kwargs.items())))
    if key not in _BOTH:
        _BOTH[key] = _both_models(name, rules, feature_channels, **kwargs)
    return _BOTH[key]


def _both_models(name, rules, feature_channels, **kwargs):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32)
    feats = (None if feature_channels is None
             else rng.uniform(size=(2, 256, feature_channels)).astype(np.float32))
    jargs = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    jmodel = jax_get_model(name, 5, **kwargs)
    variables = randomize(
        jax.jit(lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(*jargs))
    want = np.asarray(
        jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, *jargs))
    model = get_model(name, 5, **kwargs)
    model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model(_t(xyz), None if feats is None else _t(feats))
    return variables, model, got, want, (xyz, feats)


def assert_logits_match(got, want):
    assert got.shape == (2, 256, 5) and got.dtype == torch.float32
    assert want.std(axis=1).min() > 1e-3  # the logits vary over the points
    np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("feature_channels", [None, 3, 6], ids=["xyz_only_padded", "rgb", "cut"])
def test_ptv3_logits_match_jax(window, feature_channels):
    _, model, got, want, _ = both_models(
        "ptv3", ptv3_rules(2), feature_channels, window_size=window, **FLAT)
    assert isinstance(model, PointTransformerV3)
    assert_logits_match(got, want)


@pytest.mark.parametrize("feature_channels", [None, 3, 6], ids=["xyz_only_padded", "rgb", "cut"])
def test_ptv3_pooled_logits_match_jax(feature_channels):
    _, model, got, want, _ = both_models("ptv3_pooled", POOLED_RULES, feature_channels, **POOLED)
    assert isinstance(model, PointTransformerV3Pooled)
    # level 0 (256 points) is windowed, levels 1 and 2 (64, 16) are global
    assert [model._level_window(n) for n in (256, 64, 16)] == [64, 0, 0]
    assert model.enc2_block0.attn.num_heads == 8 and model.enc0_block0.attn.num_heads == 2
    assert_logits_match(got, want)


@pytest.mark.parametrize("name,rules,kwargs", [
    ("ptv3", ptv3_rules(2), dict(FLAT, window_size=64)),
    ("ptv3_pooled", POOLED_RULES, POOLED),
], ids=["ptv3_windowed", "ptv3_pooled"])
def test_permuting_the_points_permutes_the_logits(name, rules, kwargs):
    _, model, got, _, (xyz, feats) = both_models(name, rules, **kwargs)
    perm = np.random.default_rng(2).permutation(256)
    with torch.inference_mode():
        again = model(_t(xyz[:, perm]), _t(feats[:, perm]))
    np.testing.assert_allclose(again.numpy(), got.numpy()[:, perm], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,rules,kwargs", [
    ("ptv3", ptv3_rules(2), FLAT),
    ("ptv3_pooled", POOLED_RULES, POOLED),
])
def test_ptv3_weights_round_trip_is_exact_and_complete(name, rules, kwargs):
    """flax -> state_dict -> flax gives every leaf back bit for bit, and the
    rule table covers every flax leaf and every entry of the state_dict."""
    variables, model, _, _, _ = both_models(name, rules, **kwargs)
    back = state_dict_to_flax(model.state_dict(), rules)

    def leaves(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want, got = leaves(variables), leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(flax_to_state_dict(variables, rules)) == set(model.state_dict())
    prefixes = [r[0] for r in rules]
    assert len(prefixes) == len(set(prefixes))
    assert sorted(prefixes) == sorted(r[0] for r in module_rules(model))


@pytest.mark.parametrize("name", ["ptv3", "ptv3_pooled"])
def test_registry_rules_cover_the_registry_default_model(name):
    """The rule table under a registry name is that of the registry's
    default model, the one both inference CLIs build."""
    model = get_model(name, 5, generator=torch.Generator().manual_seed(0))
    from pointcloud_bridge_tpu_torch.utils.weights import rules_for

    assert sorted(r[0] for r in rules_for(name)) == sorted(r[0] for r in module_rules(model))
    if name == "ptv3":
        assert model.depth == 8 and model.block7.attn.num_heads == 2
        assert model.block0.attn.qkv.weight.shape == (3 * 384, 384)
    else:
        assert model.dims == (64, 128, 256) and model.enc_depths == (2, 2, 2)
        assert model.window_size == 1024 and model.enc2_block1.attn.num_heads == 8
    other = get_model(name, 5, generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("cls,kwargs", [
    (PointTransformerV3, {"sp_axis": "sp"}),
    (PointTransformerV3, {"axis_name": "data"}),
    (PointTransformerV3Pooled, {"sp_axis": "sp"}),
], ids=lambda v: v.__name__ if isinstance(v, type) else "-".join(v))
def test_unported_arguments_raise(cls, kwargs):
    """axis_name syncs the head's BatchNorm; sp_axis runs the model
    sequence-parallel over that mesh axis (global attention as ring
    attention, the pooled model's levels sliced or whole), and a forward
    raises where no mesh bound the axis, as the JAX model raises on an
    unbound axis name."""
    from test_torch_cls_models import all_bns_synced

    if "axis_name" in kwargs:
        assert all_bns_synced(cls(**kwargs), kwargs["axis_name"])
        return
    model = cls(**kwargs).eval()
    assert model.sp_axis == kwargs["sp_axis"]
    with torch.no_grad(), pytest.raises(RuntimeError, match="bound to no process group"):
        model(torch.rand(1, 64, 3), torch.rand(1, 64, 3))


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("cls,kwargs", [
    (PointTransformerV3, {"compute_dtype": "bfloat16"}),
    (PointTransformerV3, {"stream_dtype": "bfloat16"}),
    (PointTransformerV3, {"remat": True}),
    (PointTransformerV3, {"num_experts": 8}),
    (PointTransformerV3, {"moe_every": 1}),
    (PointTransformerV3Pooled, {"stream_dtype": "bfloat16"}),
    (PointTransformerV3Pooled, {"remat": True}),
    (PointTransformerBlock, {"dim": 32, "num_heads": 2, "num_experts": 4}),
    (PointTransformerBlock, {"dim": 32, "num_heads": 2, "dtype": "bfloat16"}),
], ids=lambda v: v.__name__ if isinstance(v, type) else "-".join(v))
def test_ported_arguments_keep_the_parameters(cls, kwargs):
    """Each option constructs and keeps the float32 model's parameter names
    and shapes, all float32; a MoE block trades ``mlp`` for ``moe_mlp``."""
    base = {k: v for k, v in kwargs.items() if k in ("dim", "num_heads")}
    small = {} if cls is PointTransformerBlock else (
        dict(embed_dim=32, depth=2, num_heads=2) if cls is PointTransformerV3 else POOLED)
    got = _shapes(cls(**small, **kwargs))
    want = _shapes(cls(**small, **base))
    if "num_experts" not in kwargs:
        assert got == want
    else:
        moe = {k for k in got if ".moe_mlp." in k or k.startswith("moe_mlp.")}
        assert moe and not any(".mlp." in k or k.startswith("mlp.") for k in moe)
        assert {k: v for k, v in got.items() if k not in moe} == {
            k: v for k, v in want.items() if k in got or "mlp" not in k}
        e = kwargs["num_experts"]
        assert {v[0] for k, v in got.items() if "experts_" in k} == {e}
    assert all(p.dtype == torch.float32 for p in cls(**small, **kwargs).parameters())


def test_ptv3_moe_is_not_ported():
    """``ptv3_moe`` is the flat model with 8 experts, top 2, in every other
    block (1, 3, 5, 7 of 8), at the registry's default width."""
    model = get_model("ptv3_moe", 5, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, PointTransformerV3)
    for i in range(8):
        block = getattr(model, f"block{i}")
        assert hasattr(block, "moe_mlp") == (i % 2 == 1), i
        if i % 2:
            assert block.moe_mlp.num_experts == 8 and block.moe_mlp.top_k == 2
            assert block.moe_mlp.capacity_factor == 1.25


def test_pooled_refuses_shapes_it_cannot_pool():
    model = get_model("ptv3_pooled", 5, **POOLED).eval()
    with pytest.raises(ValueError, match="divisible by prod"):
        model(torch.zeros(1, 250, 3), None)
    with pytest.raises(ValueError, match="window_size"):
        model(torch.zeros(1, 16 * 9, 3), None)  # 144 points, windows of 64
    with pytest.raises(ValueError, match="share a length"):
        get_model("ptv3_pooled", 5, dims=(32, 64), enc_depths=(1, 1, 1))


def test_ptv3_train_mode_forward_and_backward_on_the_cpu(rng):
    """Train mode runs on the CPU through the attention Function's plain
    versions: finite logits, the head's BatchNorm statistics move, every
    parameter gets a finite gradient (test_torch_ptv3_train.py holds the
    step to the JAX package)."""
    model = get_model("ptv3_pooled", 5, generator=torch.Generator().manual_seed(0),
                      drop_rate=0.0, head_drop_rate=0.0, **POOLED)
    model.train()
    xyz = _t(rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32))
    rgb = _t(rng.uniform(size=(2, 256, 3)).astype(np.float32))
    before = model.head_bn.running_mean.clone()
    logits = model(xyz, rgb)
    assert torch.isfinite(logits).all()
    assert not torch.equal(model.head_bn.running_mean, before)
    logits.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


# ------------------------------------------------------------------ serving


def test_block_inference_with_ptv3_pooled_matches_jax():
    """7 blocks of 256 points (batch 4: a full batch and an overlapping
    tail) through both packages' block inference with the same weights."""
    blocks, names = [], []
    for seed in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(8000, seed=seed)
        blocks += make_training_blocks(
            xyz, rgb, labels, num_points=256, block_size=4.0, sample_rate=0.3,
            file_name=f"scene{seed}", seed=seed)[:4 if seed == 0 else 3]
        names.append(f"scene{seed}")
    ds = BlockDataset.from_blocks(blocks, names)
    jmodel = jax_get_model("ptv3_pooled", 5, **POOLED)
    variables = randomize(jax.jit(
        lambda a, b: jmodel.init(jax.random.PRNGKey(1), a, b, train=False)
    )(jnp.asarray(ds.points[:1]), jnp.asarray(ds.colors[:1])))
    want = jax_run_block_inference(jmodel, variables, ds, num_classes=5, batch_size=4)
    model = get_model("ptv3_pooled", 5, **POOLED)
    model.load_state_dict(flax_to_state_dict(variables, POOLED_RULES), strict=True)
    got = run_block_inference(model, ds, num_classes=5, batch_size=4)
    assert got["predictions"].shape == (7, 256)
    assert (got["predictions"] == want["predictions"]).mean() >= 0.999
    for key in ("mIoU", "OA", "mAcc", "F1_score"):
        assert abs(got["global"][key] - want["global"][key]) <= 1e-3, key
