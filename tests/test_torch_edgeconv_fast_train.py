"""One train step of ``dgcnn`` and ``dgcnn_global`` in the restructured
EdgeConv form against the JAX package's fast path, on the CPU: both
packages set to it by ``PCB_EDGECONV_FAST=1``.

The step is tests/test_torch_dgcnn_train.py's (``_step``: the same seeded
batch and weights, weighted cross-entropy, dropout 0, the graphs of the JAX
float32 step replayed in the JAX float64 step and in the port) and so are
the bands: each quantity held to the JAX float64 step within a base
tolerance (logits 2e-4, gradients 2e-4 * max|g| + 1e-6, BatchNorm
statistics 1e-5 * max|stat|, SGD parameters 1e-6) plus twice the JAX
float32 step's own error; the loss within 1e-5 relative plus twice that
error. An EdgeConv's BatchNorm statistics here come from moments (the JAX
package's ``_MomentBN``, the port's ``BatchNorm.affine_from_moments``),
whose mean2 - mu^2 cancels in float32 on both sides. The biases in front
of a BatchNorm keep an exactly zero gradient in this form too.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import numpy as np
import pytest

from pointcloud_bridge_tpu.models import dgcnn as jdgcnn
from pointcloud_bridge_tpu_torch.models import dgcnn as tdgcnn

from test_torch_dgcnn_train import CASES, MODULES, PRE_BN, STATS, _check, _step


def _recording(real, seen: list):
    """``real`` that also appends each answer to ``seen``."""
    def default(*args):
        seen.append(real(*args))
        return seen[-1]
    return default


@pytest.fixture(scope="module")
def steps():
    """name -> (JAX float32, JAX float64, port) of the step, and the forms
    each package's EdgeConvs took."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name in MODULES:
            mp.setenv("PCB_EDGECONV_FAST", "1")
            forms = {"jax": [], "port": []}
            for pkg, module in (("jax", jdgcnn), ("port", tdgcnn)):
                mp.setattr(module, "_edgeconv_fast_default",
                           _recording(module._edgeconv_fast_default, forms[pkg]))
            out[name] = _step(name, mp) + (forms,)
            mp.undo()
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(MODULES))
def test_both_packages_took_the_restructured_form(steps, name):
    forms = steps[name][3]
    assert forms["jax"] and forms["port"] and all(forms["jax"]) and all(forms["port"])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_train_loss_matches_jax(steps, name):
    want32, want64, got = steps[name][:3]
    tol = 1e-5 * abs(want64["loss"]) + 2 * abs(want32["loss"] - want64["loss"])
    for key in ("loss", "sgd_loss"):
        assert abs(got[key] - want64["loss"]) <= tol, (key, got[key], want64["loss"], tol)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_train_mode_logits_match_jax(steps, name):
    assert steps[name][2]["logits"].shape == (2, 128, 5)
    _check("logits", None, lambda r: 2e-4, steps[name][:3])


@pytest.mark.parametrize("name,module", CASES)
def test_gradients_match_jax(steps, name, module):
    _check("grads", module, lambda r: 2e-4 * np.abs(r).max() + 1e-6, steps[name][:3])


@pytest.mark.parametrize("name,module", [(n, m) for n in STATS for m in STATS[n]])
def test_batch_stats_match_jax(steps, name, module):
    """conv1-conv4 take their statistics from moments in this form."""
    _check("batch_stats", module, lambda r: 1e-5 * np.abs(r).max(), steps[name][:3])


@pytest.mark.parametrize("name,module", CASES)
def test_sgd_step_matches_jax(steps, name, module):
    _check("sgd_params", module, lambda r: 1e-6, steps[name][:3])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_zero_gradients_stay_zero(steps, name):
    """The biases in front of a BatchNorm: below 1e-4 * max|g| of their
    layer's weight, in the port and in the JAX step."""
    want32, _, got = steps[name][:3]
    grads = got["torch_grads"]
    for layer, flax_name in PRE_BN[name].items():
        bound = 1e-4 * grads[layer + ".weight"].abs().max().item()
        assert grads[layer + ".bias"].abs().max().item() <= bound, layer
        jweight = want32["grads"][flax_name]
        jbound = 1e-4 * np.abs(jweight.get("kernel", jweight.get("scale"))).max()
        assert np.abs(want32["grads"][flax_name]["bias"]).max() <= jbound, layer
