"""One train-mode step of the PyTorch port's ``randlanet`` and
``randlanet_ss`` against the JAX package's, on the CPU.

Both models at B = 2 x 2048 points (the deepest level keeps 11 and 8
points an element), every parameter perturbed and every BatchNorm moved
away from the identity, dropout 0, weighted cross-entropy. The reference
is the JAX package's step in float64 (under ``jax_enable_x64``, with the
weighted cross-entropy's formula in float64: tests/test_torch_randlanet.py
``jax_step``); both sides take its k-NN graphs (``JaxPicks``).

- The port's float64 step (the model and batch in float64) is held to it
  leaf by leaf within 1e-9 of each leaf's max: loss, logits, every
  gradient, the updated BatchNorm statistics and one plain-SGD step.
  Gradients are held in float64 because in float32 they are
  rounding-dominated: through twenty train-mode BatchNorms and the ReLUs,
  the JAX package's own float32 gradient is over 100% of a leaf's max|g|
  from its float64 one on some leaves, and a ReLU input that rounds to the
  other side of 0 moves a leaf by ~1e-3 of its max|g|. chip_smoke.py holds
  the port's float32 gradients on the card to its CPU ones.
- The port's float32 step, as the trainer runs it (``make_train_step``,
  the float32 loss), is held to the float64 reference: loss within 1e-5
  relative, logits within 2e-4, BatchNorm statistics within 1e-5 of
  max|stat|; every gradient present and finite, non-zero but for the two
  kinds of bias that are exactly 0.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch.models import get_model

from test_torch_randlanet import (
    SITES,
    JaxPicks,
    jax_init_variables,
    jax_step64,
    port_step,
)

TOL = 2e-4
F64 = 1e-9  # of max|leaf|, the port's float64 step against JAX's
NAMES = ("randlanet", "randlanet_ss")
# with XLA's algebraic simplifier, the compiled gradient of randlanet_ss's
# encoder is up to 100% of max|g| from the same step run op by op (which the
# port's agrees with to 1e-13): that step compiles without the pass
XLA_OPTIONS = {"randlanet": None, "randlanet_ss": {"xla_disable_hlo_passes": "algsimp"}}
# the flax modules of both models
MODULES = ["fc_start", "bn_start"] + [f"lfa{i}" for i in range(4)] + [
    f"up{i}_{p}" for i in range(4) for p in ("d1", "bn1", "d2", "bn2")] + [
    "head_d0", "head_bn", "head_d1"]
CASES = [(n, m) for n in NAMES for m in MODULES]
STAT_CASES = [(n, m) for n, m in CASES if "bn" in m or m.startswith("lfa")]


def step_batch(seed, b=2, n=2048):
    rng = np.random.default_rng(seed)
    return {"points": rng.uniform(-1.0, 1.0, size=(b, n, 3)).astype(np.float32),
            "colors": rng.uniform(size=(b, n, 3)).astype(np.float32),
            "labels": rng.integers(0, 5, size=(b, n)).astype(np.int32)}


def train_steps(name, make_model, jmodel, batch, sites, monkeypatch, compiler_options=None,
                **init_kwargs):
    """(JAX float64 step, port float32 step, port float64 step), all on the
    JAX step's picks."""
    variables = jax_init_variables(jmodel, jnp.asarray(batch["points"]),
                                   jnp.asarray(batch["colors"]), train=False, **init_kwargs)
    want64 = jax_step64(jmodel, variables, batch, JaxPicks(monkeypatch, sites),
                        compiler_options)
    return (want64, port_step(make_model, name, variables, batch),
            port_step(make_model, name, variables, batch, torch.float64))


def leaves(tree, key, module):
    return jax.tree_util.tree_leaves_with_path(tree[key][module] if module else {"": tree[key]})


def check(key, module, rel, want64, got, floor=1e-12):
    """Per leaf: |port - ref64| <= rel * max|ref64| + floor."""
    ref, port = leaves(want64, key, module), dict(leaves(got, key, module))
    assert len(ref) == len(port) > 0
    for path, r in ref:
        assert port[path].shape == r.shape, path
        err = np.abs(port[path] - r).max()
        assert err <= rel * np.abs(r).max() + floor, (
            f"{key} {module}{jax.tree_util.keystr(path)}: |port - JAX f64| {err:.3g}, "
            f"max {np.abs(r).max():.3g}")


def check_loss_and_logits(step, shape, rel64=1e-12, f64=F64):
    """The float32 step's loss within 1e-5 relative and logits within 2e-4
    of the float64 reference; the float64 step's loss within ``rel64``
    relative and logits within ``f64`` of their max."""
    want64, got, got64 = step
    for key in ("loss", "sgd_loss"):
        assert abs(got[key] - want64["loss"]) <= 1e-5 * abs(want64["loss"]), key
        assert abs(got64[key] - want64["loss"]) <= rel64 * abs(want64["loss"]), key
    assert got["logits"].shape == shape
    check("logits", None, 0.0, want64, got, TOL)
    check("logits", None, f64, want64, got64)


@pytest.fixture(scope="module")
def steps():
    """name -> the model's three steps, each model's run at its first use."""
    out = {}

    def step_of(name):
        if name not in out:
            mp = pytest.MonkeyPatch()
            try:
                out[name] = train_steps(name, lambda: get_model(name, 5, dropout_rate=0.0),
                                        jax_get_model(name, 5, dropout_rate=0.0),
                                        step_batch(1), SITES[name], mp, XLA_OPTIONS[name])
            finally:
                mp.undo()
        return out[name]
    return step_of


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_and_logits_match_jax(steps, name):
    check_loss_and_logits(steps(name), (2, 2048, 5))


@pytest.mark.parametrize("name,module", CASES)
def test_train_gradients_match_jax_in_float64(steps, name, module):
    check("grads", module, F64, steps(name)[0], steps(name)[2])


@pytest.mark.parametrize("name,module", STAT_CASES)
def test_train_batch_stats_match_jax(steps, name, module):
    want64, got, got64 = steps(name)
    check("batch_stats", module, 1e-5, want64, got)
    check("batch_stats", module, F64, want64, got64)


@pytest.mark.parametrize("name,module", CASES)
def test_sgd_step_matches_jax_in_float64(steps, name, module):
    check("sgd_params", module, F64, steps(name)[0], steps(name)[2])


@pytest.mark.parametrize("name", NAMES)
def test_every_parameter_gets_a_finite_gradient(steps, name):
    """Present and finite in the float32 step; non-zero except fc_start's
    bias, which feeds bn_start, and the attention scores' last bias
    (``score_fn.3``), which moves every score of a softmax alike: exactly 0
    in float64, and below 1e-4 of the same layer weight's gradient in
    float32."""
    grads, grads64 = steps(name)[1]["torch_grads"], steps(name)[2]["torch_grads"]
    for key, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), key
        if key == "fc_start.bias" or key.endswith("score_fn.3.bias"):
            weight = grads[key[:-len("bias")] + "weight"]
            assert g.abs().max() <= 1e-4 * weight.abs().max(), key
            assert grads64[key].abs().max() <= 1e-12, key
        else:
            assert g.abs().max() > 0, key
