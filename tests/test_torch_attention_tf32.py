"""The arithmetic of the flash-attention kernels, on the CPU.

On the card the kernels (csrc/flash_attn.cu, flash_attn_bwd.cu) multiply on
the tensor cores in 3xTF32: each float32 operand is split into a TF32 number
and the rest, and a product is small . big + big . small + big . big with
float32 sums. ``split_tf32`` and ``einsum_3xtf32`` in ops/attention.py are
that arithmetic in plain PyTorch. Here they are held (a) against float64
products, within 2e-6 of the largest product, where one TF32 pass fails the
same test; (b) through ``attention_plain`` and ``attention_backward_plain``
against the JAX package (``jax.nn.dot_product_attention`` and its
``jax.vjp``) within the kernels' band, 2e-5 * max(1, max|ref|), on numpy
inputs that include scores above 50, where an error of a product goes into
an exponent. The emulation serves the tests alone: on the CPU ``Attention``
stays the exact plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu_torch.ops import attention as attn_ops

ATTN_TOL = 2e-5  # of max(1, max|ref|): chip_smoke.py's band for the kernels
SPLIT_TOL = 2e-6  # of max|product|, against float64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def einsum_1xtf32(equation, a, b):
    """One TF32 pass, big . big alone: what the kernels must not do (about
    three decimal digits)."""
    big_a, big_b = attn_ops.split_tf32(a)[0], attn_ops.split_tf32(b)[0]
    return torch.einsum(equation, big_a.double(), big_b.double()).float()


def test_split_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32 spacing in [1, 2)
    x = _t(np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                     1.0 + 2.0 ** -11 + 2.0 ** -23, -(1.0 + 2.0 ** -11), 3.0e-39, 0.0,
                     2.0 - 2.0 ** -23], np.float32))
    big, small = attn_ops.split_tf32(x)
    want = np.array([one, one + ulp, one, one + ulp, -(one + ulp), 3.0e-39, 0.0, 2.0], np.float32)
    # the denormal keeps what its 10 upper mantissa bits hold
    want[5] = big.numpy()[5]
    np.testing.assert_array_equal(big.numpy(), want)
    assert abs(big.numpy()[5] - np.float32(3.0e-39)) <= 2.0 ** -149 * 2 ** 12
    # both halves are TF32 numbers: 13 low mantissa bits clear
    for half in (big, small):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    with pytest.raises(TypeError, match="float32"):
        attn_ops.split_tf32(x.double())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_split_tf32_loses_under_two_to_minus_21(rng, scale):
    x = _t((rng.normal(size=20000) * scale).astype(np.float32))
    big, small = attn_ops.split_tf32(x)
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    rest = (x.double() - big.double() - small.double()).abs()
    assert (rest <= x.abs().double() * 2.0 ** -21).all()


@pytest.mark.parametrize("d", [32, 192])
@pytest.mark.parametrize("equation", ["bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd"],
                         ids=["rows_by_rows", "weights_by_rows"])
def test_einsum_3xtf32_against_float64(rng, d, equation):
    """Every product of the kernels is one of these two shapes. 3xTF32 stays
    within 2e-6 of the largest product; one TF32 pass does not."""
    n = 96
    if equation.startswith("bqhd"):
        a, b = (rng.normal(size=(2, n, 2, d)).astype(np.float32) for _ in range(2))
    else:
        a = rng.uniform(size=(2, 2, n, n)).astype(np.float32)
        b = rng.normal(size=(2, n, 2, d)).astype(np.float32)
    want = torch.einsum(equation, _t(a).double(), _t(b).double())
    band = SPLIT_TOL * want.abs().max().item()
    err3 = (attn_ops.einsum_3xtf32(equation, _t(a), _t(b)).double() - want).abs().max().item()
    err1 = (einsum_1xtf32(equation, _t(a), _t(b)).double() - want).abs().max().item()
    assert err3 <= band, f"3xTF32: {err3:.3g} > {band:.3g}"
    assert err1 > band, f"one TF32 pass passed a float32 test: {err1:.3g} <= {band:.3g}"


def _inputs(rng, shape, top):
    """numpy q, k, v and cotangent [B, N, H, D]; with ``top`` q and k are
    scaled by one factor so that the largest scaled score is ``top``."""
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    if top:
        s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
        f = np.float32(np.sqrt(top / (np.abs(s).max() / np.sqrt(shape[-1]))))
        q, k = q * f, k * f
    return q, k, v, g


def _close(name, got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= ATTN_TOL * max(1.0, np.abs(want).max()), f"{name}: max|err| {err:.3g}"


CASES = [((2, 96, 2, 32), 0.0), ((1, 80, 2, 192), 0.0), ((2, 65, 3, 64), 0.0),
         ((2, 96, 2, 32), 55.0), ((1, 80, 2, 192), 55.0)]


@pytest.mark.parametrize("shape,top", CASES, ids=lambda v: str(v).replace(" ", ""))
def test_attention_in_3xtf32_matches_jax(rng, shape, top):
    q, k, v, _ = _inputs(rng, shape, top)
    want = jax.nn.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = attn_ops.attention_plain(_t(q), _t(k), _t(v), einsum=attn_ops.einsum_3xtf32)
    _close("out", got, want)
    if top:
        scores = attn_ops._scores(_t(q), _t(k))
        assert scores.abs().max().item() > 50.0
        # and one TF32 pass is visibly outside the band here
        loose = attn_ops.attention_plain(_t(q), _t(k), _t(v), einsum=einsum_1xtf32)
        want = np.asarray(want)
        assert np.abs(loose.numpy() - want).max() > ATTN_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("shape,top", CASES, ids=lambda v: str(v).replace(" ", ""))
def test_attention_backward_in_3xtf32_matches_jax(rng, shape, top):
    q, k, v, g = _inputs(rng, shape, top)
    _, vjp = jax.vjp(jax.nn.dot_product_attention, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (_t(a) for a in (q, k, v, g))
    three = attn_ops.einsum_3xtf32
    out = attn_ops.attention_plain(tq, tk, tv, einsum=three)
    lse = torch.logsumexp(attn_ops._scores(tq, tk, three), dim=-1)
    got = attn_ops.attention_backward_plain(tq, tk, tv, out, lse, tg, einsum=three)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(name, a, b)


def test_the_cpu_path_of_attention_stays_the_exact_plain_version(rng):
    q, k, v, g = (_t(a) for a in _inputs(rng, (2, 40, 2, 32), 0.0))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn_ops.attention(*leaves)
    assert torch.equal(out, attn_ops.attention_plain(q, k, v))
    assert not torch.equal(out, attn_ops.attention_plain(q, k, v, einsum=attn_ops.einsum_3xtf32))
    lse = torch.logsumexp(attn_ops._scores(q, k), dim=-1)
    want = attn_ops.attention_backward_plain(q, k, v, out.detach(), lse, g)
    for a, b in zip(torch.autograd.grad(out, leaves, g), want):
        assert torch.equal(a, b)
