"""The backward of the PyTorch port's attention op against the JAX package,
on the CPU.

``Attention`` is an autograd Function on both devices. On the CPU its forward
is ``attention_plain`` plus each row's log-sum-exp and its backward is
``attention_backward_plain``, the plain version of the two CUDA backward
kernels (those are held against it on the card by chip_smoke.py). Here the
Function's gradients are held against ``jax.vjp`` through the JAX package's
``_attention``, which on the CPU is ``jax.nn.dot_product_attention``, on the
same numpy inputs and cotangent: contiguous tensors, the strided slices of a
packed qkv projection, and window folds of those. Band: 2e-5 * max(1,
max|ref|), the band of the forward (float32 sums in another order).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import ptv3 as jptv3
from pointcloud_bridge_tpu_torch.models import Dense
from pointcloud_bridge_tpu_torch.ops import _kernels
from pointcloud_bridge_tpu_torch.ops import attention as attn_ops

from test_torch_ptv3 import ATTENTION_SHAPES

GRAD_TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_grads_close(got, want, names=("dq", "dk", "dv")):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.abs(w).max() > 1e-3, name  # not a dead gradient
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), f"{name}: max|err| {err:.3g}"


def _inputs(rng, shape, layout):
    """numpy q, k, v and cotangent of ``shape`` = [B, N, H, D], and the same
    as torch tensors in ``layout``: contiguous leaves, the three views of one
    packed [B, N, 3, H, D] leaf, or those views folded into windows of N / 2
    (the shape is then [2 B, N / 2, H, D])."""
    b, n, h, d = shape
    qkv = rng.normal(size=(b, n, 3, h, d)).astype(np.float32)
    if layout == "contiguous":
        leaves = [_t(np.ascontiguousarray(qkv[:, :, i])).requires_grad_() for i in range(3)]
        views, arrays = leaves, [qkv[:, :, i] for i in range(3)]
    else:
        leaf = _t(qkv).requires_grad_()
        leaves, views = [leaf], list(leaf.unbind(2))
        arrays = [qkv[:, :, i] for i in range(3)]
        assert views[0].stride(1) == 3 * h * d and not views[0].is_contiguous()
        if layout == "window_fold":
            views = [t.reshape(2 * b, n // 2, h, d) for t in views]
            arrays = [a.reshape(2 * b, n // 2, h, d) for a in arrays]
            assert views[0].data_ptr() == leaf.data_ptr()  # a view, not a copy
    g = rng.normal(size=arrays[0].shape).astype(np.float32)
    return arrays, g, leaves, views


@pytest.mark.parametrize("layout", ["contiguous", "packed_qkv_views", "window_fold"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=str)
def test_attention_gradients_match_jax(rng, shape, layout):
    arrays, g, leaves, views = _inputs(rng, shape, layout)
    _, vjp = jax.vjp(jptv3._attention, *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(g))
    out = attn_ops.attention(*views)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "AttentionBackward"
    got = torch.autograd.grad(out, leaves, _t(g))
    if layout == "contiguous":
        assert_grads_close(got, want)
    else:  # one gradient for the packed leaf: the three stacked
        want = np.stack([np.asarray(w).reshape(shape) for w in want], axis=2)
        assert_grads_close(got, [want], names=("dqkv",))


@pytest.mark.parametrize("shape", ATTENTION_SHAPES + [(2, 37, 2, 32), (3, 1, 2, 32)], ids=str)
def test_attention_backward_plain_matches_autograd(rng, shape):
    """The formulas written out against autograd through attention_plain,
    ragged N and a single row included."""
    arrays, g, leaves, views = _inputs(rng, shape, "contiguous")
    out = attn_ops.attention_plain(*leaves)
    want = torch.autograd.grad(out, leaves, _t(g))
    q, k, v = (t.detach() for t in leaves)
    lse = torch.logsumexp(attn_ops._scores(q, k), dim=-1)
    assert lse.shape == (shape[0], shape[2], shape[1])
    got = attn_ops.attention_backward_plain(q, k, v, out.detach(), lse, _t(g))
    assert all(t.is_contiguous() and t.shape == shape for t in got)
    if shape[1] == 1:  # one key: the softmax is 1, dq and dk vanish
        assert got[0].abs().max() < 1e-6 and got[1].abs().max() < 1e-6
        np.testing.assert_allclose(got[2].numpy(), g, rtol=1e-6, atol=1e-6)
    else:
        assert_grads_close(got, [w.numpy() for w in want])
    # and through the Function
    again = torch.autograd.grad(attn_ops.attention(*leaves), leaves, _t(g))
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_attention_function_passes_gradcheck_in_float64(rng):
    """The Function itself takes any float type on the CPU (``attention()``
    goes on refusing all but float32, the kernels' type), so its backward is
    held to finite differences in float64."""
    q, k, v = (_t(rng.normal(size=(2, 5, 2, 4))).requires_grad_() for _ in range(3))
    assert q.dtype == torch.float64
    assert torch.autograd.gradcheck(attn_ops.Attention.apply, (q, k, v), eps=1e-6, atol=1e-7)
    with pytest.raises(TypeError, match="float32"):
        attn_ops.attention(q, k, v)


def test_gradients_reach_the_packed_qkv_weight(rng):
    """As PointAttention calls it: q, k, v are views of one projection, in
    windows; the projection's weight and bias get the plain path's gradient."""
    b, n, h, d, w = 2, 64, 2, 16, 32
    x = _t(rng.normal(size=(b, n, h * d)).astype(np.float32))
    g = _t(rng.normal(size=(b * n // w, w, h, d)).astype(np.float32))
    grads = []
    for fn in (attn_ops.attention, attn_ops.attention_plain):
        qkv = Dense(h * d, 3 * h * d, generator=torch.Generator().manual_seed(0))
        q, k, v = (t.reshape(b * n // w, w, h, d)
                   for t in qkv(x).reshape(b, n, 3, h, d).unbind(2))
        (fn(q, k, v) * g).sum().backward()
        grads.append((qkv.weight.grad, qkv.bias.grad))
    for got, want in zip(*grads):
        assert want.abs().max() > 1e-3
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_TOL * max(1.0, want.abs().max().item()))
    # the keys' bias shifts every score of a row alike: its gradient vanishes
    assert grads[0][1][h * d:2 * h * d].abs().max() < 1e-5


def test_attention_saves_its_inputs_as_the_views_it_was_given(rng):
    """No copy of a packed projection is kept for the backward: the saved q,
    k and v share the projection's storage; the output and a [B, H, N]
    log-sum-exp are saved beside them."""
    b, n, h, d = 2, 32, 2, 16
    leaf = _t(rng.normal(size=(b, n, 3, h, d)).astype(np.float32)).requires_grad_()
    q, k, v = leaf.unbind(2)
    out = attn_ops.attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    for s, t in zip(saved[:3], (q, k, v)):
        assert s.data_ptr() == t.data_ptr() and s.stride() == t.stride()
        assert s.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr()
    assert saved[3].data_ptr() == out.data_ptr()
    want_lse = torch.logsumexp(attn_ops._scores(q, k), dim=-1).detach()
    assert saved[4].shape == (b, h, n) and torch.equal(saved[4], want_lse)


def test_attention_without_a_gradient_keeps_nothing(rng):
    q = _t(rng.normal(size=(2, 16, 2, 32)).astype(np.float32))
    out = attn_ops.attention(q, q, q)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, attn_ops.attention_plain(q, q, q))
    with torch.no_grad():
        out = attn_ops.attention(q.clone().requires_grad_(), q, q)
    assert out.grad_fn is None
    with torch.inference_mode():
        assert torch.equal(attn_ops.attention(q, q, q), attn_ops.attention_plain(q, q, q))


def test_only_the_tensors_that_need_it_get_a_gradient(rng):
    q, k, v = (_t(rng.normal(size=(1, 8, 2, 32)).astype(np.float32)) for _ in range(3))
    k.requires_grad_()
    attn_ops.attention(q, k, v).sum().backward()
    assert q.grad is None and v.grad is None
    assert k.grad is not None and k.grad.shape == k.shape


def test_backward_kernel_wrappers_never_run_on_the_cpu(rng):
    """A CPU tensor takes the plain version through the Function; the kernel
    wrappers themselves refuse it."""
    q = _t(rng.normal(size=(2, 16, 2, 32)).astype(np.float32))
    lse = torch.zeros(2, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_ops.attention_backward_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_ops.attention_backward_dq_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_ops.attention_backward_dkv_cuda(q, q, q, lse, lse, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attn_ops.attention_cuda(q, q, q, need_lse=True)


def test_kernel_table_lists_the_attention_backward_kernels():
    names = [k.name for k in _kernels.KERNELS]
    assert names[8:11] == ["flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"]
    assert names[11:14] == ["flash_attn_bf16", "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16"]
    assert names[14:] == ["edge_reduce", "edge_reduce_bwd"]
    assert len(set(names)) == len(names) == 16
    for k in (_kernels.FLASH_ATTN_BWD_DQ, _kernels.FLASH_ATTN_BWD_DKV):
        assert (_kernels._REPO / k.source).is_file()
        assert k.source.endswith("csrc/flash_attn_bwd.cu")
        assert k.replaces.startswith("pointcloud_bridge_tpu/models/ptv3.py:")
        assert k.symbol in (_kernels._REPO / k.source).read_text()
        assert len(k.argtypes) == 17
    # the forward's entry point takes the lse pointer after the output
    assert len(_kernels.FLASH_ATTN.argtypes) == 14
    source = (_kernels.CSRC / "flash_attn.cu").read_text()
    assert "float* o, float* lse, int b" in source
    _kernels.FLASH_ATTN_BWD_DQ.launches = 3
    _kernels.reset_launch_counts()
    assert set(_kernels.launch_counts()) == set(names)
    assert not any(_kernels.launch_counts().values())
