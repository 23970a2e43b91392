"""The PTv3 production options of the PyTorch port against the JAX package,
on the CPU: bfloat16 attention and its backward, the bfloat16 stream and
compute paths of ``ptv3`` and ``ptv3_pooled``, the stream's LayerNorm,
remat, gradient accumulation, and configs/train_ptv3_big_prod.yaml through
train_cli.

Bands. bf16 rounds to 8 bits: eps = 2^-8, and a rounding is within eps/2
of its value. Attention in bf16 agrees with ``jax.nn.dot_product_attention``
in bf16 within 2 eps * max|JAX| (float32 sums in another order may round to
the neighbouring bf16; the backward rounds dP to bf16 in JAX and not in the
port's contract).
A model's bf16 logits are two chains of bf16 roundings that part where a
float32 sum lands either side of a rounding boundary (XLA and PyTorch sum in
other orders), and the parting grows with depth: within 2e-2 * max(1,
max|logits|), with argmax agreement of 0.99 at least. The JAX model is
compiled with ``xla_allow_excess_precision`` off, so that it rounds wherever
flax casts (by default XLA drops a bf16 rounding that a float32 cast
follows, and moves these logits by up to 0.036). The port's GELU is one
call that computes in float32 and rounds once, as XLA computes a fused GELU
by default; the strict JAX model rounds each operation of its GELU, and the
two part within the bands. The pooled model's bf16
stream, the deepest chain (six blocks, two pools, two unpools, each level
entering and leaving the stream), is held to 2.5e-2: there the port parts
from the JAX model by 0.0340 at a max|logits| of 1.65, about as far as the
JAX model's own two compilations part from each other (0.0333).
The bands cannot tell a bf16 model from one that stayed float32, so the
types are also read where they flow (``test_bf16_options_compute_in_bf16``).
Remat is exact: the same bits as without it.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import flax.linen as fnn

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.config import Config as JaxConfig
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu.train.loop import make_accum_train_step
from pointcloud_bridge_tpu_torch import train_cli
from pointcloud_bridge_tpu_torch.config import Config
from pointcloud_bridge_tpu_torch.models import Dropout, get_model
from pointcloud_bridge_tpu_torch.models.ptv3 import LayerNorm
from pointcloud_bridge_tpu_torch.ops import attention as attn_ops
from pointcloud_bridge_tpu_torch.train import make_train_step
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    ptv3_pooled_rules,
    ptv3_rules,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize
from test_torch_ptv3 import FLAT, POOLED, POOLED_RULES
from test_torch_ptv3_train import CLASS_WEIGHTS, _leaves, _write_scenes

EPS = 2.0 ** -8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """A numpy float32 array rounded to bf16 -> (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


# ----------------------------------------------------------- bf16 attention


@pytest.mark.parametrize("b,n,h,d", [(2, 96, 2, 32), (8, 64, 2, 32), (1, 130, 3, 64)],
                         ids=["global", "window_fold", "ragged_d64"])
def test_bf16_attention_and_backward_match_jax(rng, b, n, h, d):
    q, k, v, g = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(4))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_bf16(a) for a in (q, k, v, g))
    want, vjp = jax.vjp(jax.nn.dot_product_attention, jq, jk, jv)
    want_grads = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = attn_ops.attention(*leaves)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    out.backward(tg)
    for name, got, w in [("out", out, want)] + list(zip(("dq", "dk", "dv"),
                                                        (t.grad for t in leaves), want_grads)):
        w = np.asarray(w.astype(jnp.float32))
        assert got.dtype == torch.bfloat16, name
        err = np.abs(got.detach().float().numpy() - w).max()
        assert err <= 2 * EPS * np.abs(w).max(), f"{name}: {err}"


def test_bf16_attention_refuses_mixed_types():
    q = torch.zeros(1, 8, 1, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="expected torch.bfloat16 as q"):
        attn_ops.attention(q, q.float(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn_ops.attention(q.half(), q.half(), q.half())


def test_rows_copies_a_view_off_alignment():
    """A contiguous view 4 bytes off 16-byte alignment is copied into an
    aligned buffer (``.contiguous()`` would hand it back as it is); an
    aligned packed-qkv slice passes in place."""
    flat = torch.zeros(4 * 8 * 2 * 32 + 1)
    view = flat[1:].view(4, 8, 2, 32)
    assert view.is_contiguous() and view.data_ptr() % 16
    fixed = attn_ops._rows(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    packed = torch.zeros(4, 8, 3, 2, 32, dtype=torch.bfloat16)
    q = packed.unbind(2)[1]
    assert attn_ops._rows(q).data_ptr() == q.data_ptr()


def test_backward_hands_the_kernels_an_aligned_gradient(monkeypatch):
    """The backward kernels read the output and its gradient with 16-byte
    loads: ``attention_backward_cuda`` hands them a copy of a contiguous
    view 2 bytes off alignment, and the kernels' wrappers refuse one."""
    flat = torch.zeros(4 * 8 * 2 * 32 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(4, 8, 2, 32)
    assert view.is_contiguous() and view.data_ptr() % 16
    fixed = attn_ops._dense(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    aligned = torch.zeros(4, 8, 2, 32, dtype=torch.bfloat16)
    assert attn_ops._dense(aligned) is aligned

    handed = []

    def dq(q, k, v, out, lse, grad_out):
        handed.extend([out, grad_out])
        return q, lse

    monkeypatch.setattr(attn_ops, "attention_backward_dq_cuda", dq)
    monkeypatch.setattr(attn_ops, "attention_backward_dkv_cuda",
                        lambda q, k, v, lse, delta, grad_out: handed.append(grad_out) or (q, q))
    attn_ops.attention_backward_cuda(aligned, aligned, aligned, view, None, view)
    assert len(handed) == 3 and all(t.data_ptr() % 16 == 0 for t in handed)
    assert all(torch.equal(t, view) for t in handed)

    monkeypatch.setattr(attn_ops._kernels, "check_tensor", lambda *args: None)
    with pytest.raises(ValueError, match="grad_out: expected 16-byte alignment"):
        attn_ops._check_saved(grad_out=(view, (4, 8, 2, 32), torch.bfloat16))
    attn_ops._check_saved(grad_out=(aligned, (4, 8, 2, 32), torch.bfloat16))


@pytest.mark.parametrize("fault", ["fwd", "dq", "dv", "dk"])
def test_fault_probe_still_plants_one_skipped_tile(fault):
    """probes/bf16_fault_probe.py, which shows on the card that phase 3e
    fails a kernel that leaves one tile out of a product, still finds its
    product line in the bf16 kernel source: one line changes, to the same
    product skipped at step 1."""
    from pointcloud_bridge_tpu_torch.probes import bf16_fault_probe as probe

    source = (probe.ROOT / probe.CSRC / probe.FAULTS[fault][0]).read_text()
    planted = probe.plant(source, fault)
    changed = [(a, b) for a, b in zip(source.splitlines(), planted.splitlines()) if a != b]
    assert len(changed) == 1 and len(planted.splitlines()) == len(source.splitlines())
    assert changed[0][1] == changed[0][0].replace(
        probe.FAULTS[fault][1], "if (step != 1) " + probe.FAULTS[fault][1])
    with pytest.raises(ValueError, match="not once"):
        probe.plant(planted + planted, fault)


# ------------------------------------------------------------- bf16 models


def _bf16_models(name, rules, kwargs, option):
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32)
    rgb = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    jmodel = jax_get_model(name, 5, **kwargs, **option)
    variables = randomize(
        jax.jit(lambda a, c: jmodel.init(jax.random.PRNGKey(0), a, c))(xyz, rgb))
    strict = jax.jit(lambda v, a, c: jmodel.apply(v, a, c)).lower(variables, xyz, rgb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(strict(variables, xyz, rgb))
    model = get_model(name, 5, **kwargs, **option)
    model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model(_t(xyz), _t(rgb))
    return got, want


@pytest.mark.parametrize("option", [{"stream_dtype": "bfloat16"}, {"compute_dtype": "bfloat16"}],
                         ids=["stream", "compute"])
@pytest.mark.parametrize("name,rules,kwargs", [
    ("ptv3", ptv3_rules(2), dict(FLAT, window_size=64)),
    ("ptv3_pooled", POOLED_RULES, POOLED),
], ids=["ptv3", "ptv3_pooled"])
def test_bf16_logits_match_jax(name, rules, kwargs, option):
    got, want = _bf16_models(name, rules, kwargs, option)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    band = 2.5e-2 if (name, *option) == ("ptv3_pooled", "stream_dtype") else 2e-2
    assert err <= band * max(1.0, np.abs(want).max()), err
    assert (got.argmax(-1).numpy() == want.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("option", ["stream_dtype", "compute_dtype"])
@pytest.mark.parametrize("name,kwargs", [
    ("ptv3", dict(FLAT, window_size=64)), ("ptv3_pooled", POOLED),
    ("ptv3_moe", dict(FLAT, num_experts=4)),
], ids=["ptv3", "ptv3_pooled", "ptv3_moe"])
def test_bf16_options_compute_in_bf16(monkeypatch, name, kwargs, option):
    """What the logit bands cannot tell apart: a model that ignored the
    option and stayed float32 parts from the bf16 JAX model by less than
    the band. So the types are read where they flow: every Dense of a block
    but the router gives bf16 (with ``compute_dtype`` every Dense outside
    the head too), every attention call takes bf16 q, k and v, the MoE's
    two expert products run in bf16, and each block takes and gives x in bf16 with
    ``stream_dtype`` and in float32 with ``compute_dtype``; the parameters
    and the logits stay float32."""
    from pointcloud_bridge_tpu_torch.models import ptv3 as port_ptv3
    from pointcloud_bridge_tpu_torch.models.common import Dense
    from pointcloud_bridge_tpu_torch.models.moe import MoEFeedForward

    seen = {}
    calls = []

    def record(q, k, v):
        calls.append({q.dtype, k.dtype, v.dtype})
        return attn_ops.attention(q, k, v)

    monkeypatch.setattr(port_ptv3, "attention", record)
    einsum = torch.einsum
    experts = []

    def record_einsum(eq, *ops):
        if eq.startswith("gec"):
            experts.append({t.dtype for t in ops})
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, "einsum", record_einsum)
    model = get_model(name, 5, **kwargs, **{option: "bfloat16"}).eval()
    for mod_name, m in model.named_modules():
        if isinstance(m, (Dense, MoEFeedForward, port_ptv3.PointTransformerBlock)):
            m.register_forward_hook(lambda mod, i, o, mod_name=mod_name: seen.__setitem__(
                mod_name, (i[0].dtype, o.dtype)))
    rng = np.random.default_rng(9)
    xyz = _t(rng.uniform(-1.0, 1.0, size=(1, 256, 3)).astype(np.float32))
    with torch.inference_mode():
        logits = model(xyz, _t(rng.uniform(size=(1, 256, 3)).astype(np.float32)))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    blocks = [n for n, m in model.named_modules()
              if isinstance(m, port_ptv3.PointTransformerBlock)]
    assert blocks and len(calls) == len(blocks) and all(c == {torch.bfloat16} for c in calls)
    stream = torch.bfloat16 if option == "stream_dtype" else torch.float32
    for n, (dt_in, dt_out) in seen.items():
        in_block = any(n.startswith(b + ".") for b in blocks)
        if n in blocks or n.endswith("moe_mlp"):
            assert dt_in == dt_out == stream, n
        elif n.startswith("head_") or n.endswith("router"):
            assert dt_out == torch.float32, n
        elif in_block or option == "compute_dtype":
            assert dt_out == torch.bfloat16, n
    moes = sum(isinstance(m, MoEFeedForward) for m in model.modules())
    assert moes == (name == "ptv3_moe") and len(experts) == 2 * moes
    assert all(t == {torch.bfloat16} for t in experts)


def test_stream_layer_norm_takes_float32_statistics():
    """The stream's LayerNorm against flax's LayerNorm(dtype=bfloat16,
    use_fast_variance=False) on bf16 rows of mean 40 and spread 3: the
    statistics in float32 from the bf16 values, the output within one bf16
    rounding."""
    rng = np.random.default_rng(6)
    x = (40.0 + 3.0 * rng.normal(size=(4, 64, 96))).astype(np.float32)
    jx, tx = _bf16(x)
    ln = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16, use_fast_variance=False)
    variables = randomize(ln.init(jax.random.PRNGKey(0), jx))
    want = np.asarray(ln.apply(variables, jx).astype(jnp.float32))
    port = LayerNorm(96, dtype=torch.bfloat16)
    port.load_state_dict({"weight": _t(variables["params"]["scale"]),
                          "bias": _t(variables["params"]["bias"])})
    got = port(tx)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.detach().float().numpy() - want).max() <= EPS * np.abs(want).max()
    assert np.abs(want).max() > 1.0
    # float32 statistics: the same as nn.LayerNorm of the float32 values
    ref = torch.nn.functional.layer_norm(tx.float(), (96,), port.weight, port.bias, 1e-6)
    assert (got.float() - ref).abs().max() <= EPS * ref.abs().max()


# ------------------------------------------------------------------- remat


def _seed_dropouts(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return gen


@pytest.mark.parametrize("name,kwargs", [
    ("ptv3", dict(FLAT, window_size=64)), ("ptv3", dict(FLAT, stream_dtype="bfloat16")),
    ("ptv3_pooled", POOLED), ("ptv3_moe", dict(FLAT, num_experts=4)),
], ids=["ptv3", "ptv3_bf16_stream", "ptv3_pooled", "ptv3_moe"])
def test_remat_is_exact_with_dropout(rng, name, kwargs):
    """remat=True gives the forward, every gradient and the next forward's
    dropout masks of remat=False bit for bit, with the Dropouts drawing from
    the trainer's kind of generator (drop rate 0.3)."""
    xyz = _t(rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32))
    rgb = _t(rng.uniform(size=(2, 256, 3)).astype(np.float32))
    runs = []
    for remat in (False, True):
        model = get_model(name, 5, generator=torch.Generator().manual_seed(0), drop_rate=0.3,
                          head_drop_rate=0.5, remat=remat, **kwargs).train()
        gen = _seed_dropouts(model, 7)
        out = model(xyz, rgb)
        out.float().square().mean().backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        state = gen.get_state()
        with torch.no_grad():
            again = model(xyz, rgb)
        runs.append((out.detach(), grads, state, again))
    (out0, g0, s0, a0), (out1, g1, s1, a1) = runs
    assert torch.equal(out0, out1)
    assert set(g0) == set(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(s0, s1) and torch.equal(a0, a1)
    assert not torch.equal(out0, a0)  # the masks do change from call to call


# ---------------------------------------------------------- accumulation


def _accum_batch():
    rng = np.random.default_rng(8)
    return {
        "points": rng.uniform(-1.0, 1.0, size=(4, 128, 3)).astype(np.float32),
        "colors": rng.uniform(size=(4, 128, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, size=(4, 128)).astype(np.int32),
    }


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_jax(accum):
    """One SGD step of ``make_train_step(accum_steps=...)`` against the JAX
    package's ``make_accum_train_step``: the mean loss and accuracy, the
    gradient (the update over the learning rate), and the head's BatchNorm
    statistics chained over the microbatches."""
    kw = dict(FLAT, drop_rate=0.0, head_drop_rate=0.0)
    b = _accum_batch()
    jmodel = jax_get_model("ptv3", 5, **kw)
    variables = randomize(jax.jit(
        lambda x, c: jmodel.init(jax.random.PRNGKey(0), x, c, train=False))(
            b["points"][:1], b["colors"][:1]), seed=2)
    lr = 0.1
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=optax.identity().init(None))
    new, metrics = make_accum_train_step(jmodel, JaxConfig().loss, optax.identity(), accum,
                                         donate=False)(
        state, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(lr),
        jnp.asarray(CLASS_WEIGHTS), jax.random.PRNGKey(0))

    rules = ptv3_rules(2)
    model = get_model("ptv3", 5, **kw)
    model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    step = make_train_step(model, Config().loss, torch.optim.SGD(model.parameters(), lr=lr),
                           accum_steps=accum)
    got = step({"points": _t(b["points"]), "colors": _t(b["colors"]),
                "labels": _t(b["labels"]).long()}, lr, _t(CLASS_WEIGHTS))
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(metrics["acc"]), atol=1e-6)
    back = state_dict_to_flax(model.state_dict(), rules)
    p0, want_p, got_p = (_leaves(t) for t in (variables["params"], new.params, back["params"]))
    for key in p0:
        want_g = (p0[key] - np.asarray(want_p[key])) / lr
        got_g = (p0[key] - got_p[key]) / lr
        assert np.abs(got_g - want_g).max() <= 2e-4 * np.abs(want_g).max() + 1e-5, key
    want_s, got_s = _leaves(new.batch_stats), _leaves(back["batch_stats"])
    for key in want_s:
        np.testing.assert_allclose(got_s[key], np.asarray(want_s[key]),
                                   rtol=0, atol=1e-5 * np.abs(want_s[key]).max())
    # the statistics did chain: accum BatchNorm updates, not one
    assert int(model.head_bn.num_batches_tracked) == accum


def test_accumulation_refuses_a_batch_it_cannot_split():
    model = get_model("ptv3", 5, **FLAT)
    step = make_train_step(model, Config().loss, torch.optim.SGD(model.parameters(), lr=0.1),
                           accum_steps=4)
    b = _accum_batch()
    with pytest.raises(ValueError, match="does not split"):
        step({"points": _t(b["points"][:3]), "colors": _t(b["colors"][:3]),
              "labels": _t(b["labels"][:3]).long()}, 0.1, _t(CLASS_WEIGHTS))


# ------------------------------------------- the production recipe, tiny


def test_train_cli_runs_the_production_config(tmp_path, monkeypatch):
    """configs/train_ptv3_big_prod.yaml through train_cli on the CPU as the
    file stands (bf16 stream, remat, 4 microbatches, EMA 0.999, warm-up)
    with its model cut to 48 wide and 2 blocks of 2 heads and its blocks to
    128 points: one epoch, then the checkpoint reloads through the trainer's
    own model build to the same logits."""
    _write_scenes(tmp_path)
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(REPO, "configs", "train_ptv3_big_prod.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model_extra"].update(embed_dim=48, depth=2, num_heads=2)
    raw.update(num_points=128, batch_size=8)
    (tmp_path / "prod.yaml").write_text(yaml.safe_dump(raw))
    out = train_cli.main(["--config", str(tmp_path / "prod.yaml"),
                          "--train-dir", str(tmp_path / "train"),
                          "--val-dir", str(tmp_path / "val"), "--num-epochs", "1",
                          "--sampler", "random", "--device", "cpu"])
    model = out["model"]
    assert model.remat and model.stream_dtype == torch.bfloat16
    assert [r["epoch"] for r in out["history"]] == [1]
    assert np.isfinite(out["history"][0]["train_loss"])
    assert out["history"][0]["lr"] == pytest.approx(1e-3 / 5)  # warm-up epoch 1 of 5
    assert os.path.exists(os.path.join(out["exp_dir"], "latest_ema"))

    cfg = Config.from_yaml(str(tmp_path / "prod.yaml"))
    again = get_model(cfg.model.name, cfg.model.num_classes, **cfg.model.extra)
    again.load_state_dict(
        restore_checkpoint(os.path.join(out["exp_dir"], "latest_checkpoint"))["model"])
    xyz = _t(np.random.default_rng(9).uniform(-1, 1, size=(2, 128, 3)).astype(np.float32))
    rgb = torch.rand(2, 128, 3, generator=torch.Generator().manual_seed(9))
    model.eval()
    again.eval()
    with torch.inference_mode():
        assert torch.equal(model(xyz, rgb), again(xyz, rgb))
