"""The order of K3b's adds, on the CPU.

csrc/group_bwd.cu sums each point's gradient row as a left fold from 0.0
over its slots in ascending s * K + k, one float32 add at a time, so a call
gives the same bits every time. ``grouping.group_backward_order`` is that
fold in plain PyTorch, which chip_smoke.py's phase 3b holds the kernel to
bit for bit. Here it is held to a direct numpy fold (bit for bit), to the
plain scatter (``group_backward_plain``) and to JAX's scatter (the gradient
of the JAX ``group_points`` and ``index_points``) within 1e-6; the kernel's
ranking of a bucket filled in any order is emulated; and ``index_points``
routes a float32 CUDA tensor that needs a gradient through
``IndexPoints``, whose backward is the same kernel.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops.core import index_points as j_index_points
from pointcloud_bridge_tpu_torch.ops import core, grouping

INT_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def fold_in_slot_order(g, idx, n, c0, c1):
    """The specification, one slot at a time in ascending s * K + k."""
    b, s, k, _ = g.shape
    out = np.zeros((b, n, c1 - c0), np.float32)
    flat = np.clip(idx.reshape(b, s * k), 0, n - 1)
    rows = g[..., c0:c1].reshape(b, s * k, c1 - c0)
    for bi in range(b):
        for p in range(s * k):
            j = flat[bi, p]
            out[bi, j] = (out[bi, j] + rows[bi, p]).astype(np.float32)
    return out


def ball_like(rng, b, n, s, k, empty=1, sparse=2):
    """Ball-query indices: ascending hits among the first 3/4 of the points
    (the others get no slot), the first hit repeated in the trailing slots
    of a sparse ball, N in every slot of an empty one."""
    idx = np.sort(rng.integers(0, 3 * n // 4, size=(b, s, k)), axis=-1).astype(np.int32)
    idx[:, :empty] = n
    for r in range(empty, empty + sparse):
        idx[:, r, 1 + r % (k - 1):] = idx[:, r, :1]
    return idx


# (B, N, S, K, width, c0, c1): the SSG step's sa2 and sa3, BriStruNet's
# sa1 feature slice, the MSG family's K = 64, dxyz alone, xyz and features
SHAPES = [(2, 64, 16, 32, 3 + 8, 3, 11), (2, 32, 8, 32, 3 + 12, 3, 15),
          (1, 128, 32, 16, 3 + 3, 3, 6), (2, 96, 24, 64, 3 + 4, 3, 7),
          (2, 40, 10, 8, 3 + 5, 0, 3), (1, 50, 12, 8, 3 + 5, 0, 8)]


@pytest.mark.parametrize("b,n,s,k,width,c0,c1", SHAPES)
def test_order_emulation_is_the_fold_bit_for_bit(rng, b, n, s, k, width, c0, c1):
    idx = ball_like(rng, b, n, s, k)
    g = rng.normal(size=(b, s, k, width)).astype(np.float32)
    got = grouping.group_backward_order(_t(g), _t(idx), n, c0, c1).numpy()
    np.testing.assert_array_equal(got, fold_in_slot_order(g, idx, n, c0, c1))
    # every row written, zeros where no slot points
    hit = np.zeros((b, n), bool)
    for bi in range(b):
        hit[bi, np.clip(idx[bi].ravel(), 0, n - 1)] = True
    assert (got[~hit] == 0).all() and not hit.all()


@pytest.mark.parametrize("b,n,s,k,width,c0,c1", SHAPES)
def test_order_emulation_against_the_plain_scatter_and_jax(rng, b, n, s, k, width, c0, c1):
    idx = ball_like(rng, b, n, s, k)
    g = rng.normal(size=(b, s, k, width)).astype(np.float32)
    got = grouping.group_backward_order(_t(g), _t(idx), n, c0, c1)
    plain = grouping.group_backward_plain(_t(g), _t(idx), n, c0, c1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
    # JAX's scatter: the gradient of its group_points to xyz and features
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    feats = rng.normal(size=(b, n, width - 3)).astype(np.float32)

    def f(x, fe):
        out = jgrouping.group_points(x, jnp.asarray(xyz[:, :s]), jnp.asarray(idx), fe)
        return jnp.sum(out * g)

    dx, df = jax.grad(f, argnums=(0, 1))(jnp.asarray(xyz), jnp.asarray(feats))
    want = np.concatenate([np.asarray(dx), np.asarray(df)], axis=-1)[..., c0:c1]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,c", [(20, 16), (16, 12)])
def test_index_points_backward_order_against_jax(rng, k, c):
    """IndexPoints' backward is the kernel at c0 = 0, c1 = C over idx viewed
    as [B, S, K]: DGCNN's edge features (k = 20) and BoundaryAwareModule's
    (k = 16) gather with repeats, held to the gradient of the JAX
    index_points."""
    b, n = 2, 48
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    g = rng.normal(size=(b, n, k, c)).astype(np.float32)
    got = grouping.group_backward_order(_t(g), _t(idx), n, 0, c).numpy()
    np.testing.assert_array_equal(got, fold_in_slot_order(g, idx, n, 0, c))
    want = jax.grad(lambda p: jnp.sum(j_index_points(p, jnp.asarray(idx)) * g))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def rank_bucket(ids: np.ndarray) -> np.ndarray:
    """csrc/group_bwd.cu's ranking of one bucket by a warp: 32 ids at a
    time (the tail padded with INT_MAX), each ranked by the ids below it
    over every tile, then written to its rank."""
    ln = len(ids)
    pad = np.full(-(-ln // 32) * 32, INT_MAX, np.int64)
    pad[:ln] = ids
    out = np.empty(ln, np.int64)
    for base in range(0, ln, 32):
        e = pad[base:base + 32]
        rank = np.zeros(32, np.int64)
        for ob in range(0, ln, 32):
            rank += (pad[ob:ob + 32][None, :] < e[:, None]).sum(1)
        live = base + np.arange(32) < ln
        out[rank[live]] = e[live]
    return out


@pytest.mark.parametrize("length", [0, 1, 7, 32, 33, 100, 257])
def test_bucket_ranking_sorts_any_fill_order(rng, length):
    """The fill writes a bucket's ids in whatever order its integer atomics
    run; the ranking puts them in ascending order whatever that was."""
    ids = rng.choice(10 * length + 1, size=length, replace=False)
    for _ in range(3):
        np.testing.assert_array_equal(rank_bucket(rng.permutation(ids)), np.sort(ids))


def test_index_points_routes_by_device_and_grad(monkeypatch, rng):
    x = _t(rng.normal(size=(1, 10, 4)).astype(np.float32)).requires_grad_(True)
    idx = _t(rng.integers(0, 10, size=(1, 10, 3)).astype(np.int32))
    out = core.index_points(x, idx)
    assert type(out.grad_fn).__name__ != "IndexPointsBackward"
    with torch.no_grad():
        assert core.index_points(x, idx).grad_fn is None
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = core.index_points(x, idx)
    assert type(out.grad_fn).__name__ == "IndexPointsBackward"
    np.testing.assert_array_equal(out.detach().numpy(), core._gather(x, idx).detach().numpy())
    assert type(core.index_points(x.detach(), idx).grad_fn).__name__ == "NoneType"
    assert core.index_points(x.double(), idx).grad_fn is None or type(
        core.index_points(x.double(), idx).grad_fn).__name__ != "IndexPointsBackward"


def test_probe_variants_edit_the_kernel_source():
    """probes/k3b_probe.py times textual variants of csrc/group_bwd.cu on
    the card: every text it edits is in the source as it stands (with the
    counting sort it includes from csrc/group_sort.cuh written in place),
    and the source it builds includes nothing by a relative path."""
    from pointcloud_bridge_tpu_torch.probes import k3b_probe

    text = k3b_probe.source_text()
    assert '#include "group_sort.cuh"' not in text and '#include "common.cuh"' not in text
    for name, _, edits in k3b_probe.VARIANTS:
        for old, _new in edits:
            assert old in text, name
