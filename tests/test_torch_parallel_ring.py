"""The port's ring attention (parallel/ring.py) on two gloo ranks against
the JAX package's ``ring_attention`` under ``shard_map`` and against
attention over the whole gathered N, on the CPU (tests/torch_ranks.py's
``ring`` job).

Each rank holds its half of the N axis. On the CPU each ring step is the
plain attention over one K/V block with its log-sum-exp, and the backward
the plain formulas with the whole row's output and log-sum-exp: the
schedule that the card runs on the flash-attention kernels (chip_smoke.py
phase 44a holds it there). ``ring_attention_plain`` is the JAX algorithm,
an online softmax over einsums. Outputs within 2e-5 of max(1, max|ref|)
(K6's band), gradients within 2e-4 of the reference's max (the attention
backward's band, tests/test_torch_attention_bwd.py).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pointcloud_bridge_tpu.parallel import make_mesh, ring_attention
from pointcloud_bridge_tpu_torch.ops.attention import attention_plain

from torch_ranks import Ranks, ring_inputs


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    ranks = Ranks("ring", 2, tmp_path_factory.mktemp("ring")).start()
    q, k, v, g = ring_inputs()
    jax_ring = shard_map(lambda q, k, v: ring_attention(q, k, v, "sp"), mesh=make_mesh(2, "sp"),
                         in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"), check_vma=False)
    want_jax = np.asarray(jax.jit(jax_ring)(*map(jnp.asarray, (q, k, v))))
    qkv = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    full = attention_plain(*qkv)
    (full * torch.from_numpy(g).double()).sum().backward()
    return ranks.join(), want_jax, full.detach().numpy(), [t.grad.numpy() for t in qkv]


def gathered(ranks, name, *index):
    parts = []
    for r in ranks:
        t = r[name]
        for i in index:
            t = t[i]
        parts.append(t.numpy())
    return np.concatenate(parts, axis=1)


def out_band(ref):
    return 2e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", ["ring", "plain"])
def test_ring_output_matches_jax_ring_and_whole_attention(ring, name):
    ranks, want_jax, full, _ = ring
    got = gathered(ranks, name, "out")
    assert np.abs(got - want_jax).max() <= out_band(want_jax)
    assert np.abs(got - full).max() <= out_band(full)


@pytest.mark.parametrize("name", ["ring", "plain"])
@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_ring_gradients_match_autograd_of_whole_attention(ring, name, which):
    """dq from each block's share; dk and dv travelled home round the
    ring. Held to float64 autograd of the plain attention over all N."""
    ranks, _, _, grads = ring
    got = gathered(ranks, name, "grads", which)
    ref = grads[which]
    assert np.abs(got - ref).max() <= 2e-4 * np.abs(ref).max() + 1e-6


def test_ring_runs_in_float32_and_returns_the_input_type(ring):
    """bf16 inputs: the ring computes in float32 (ring.py:42-62) and hands
    back bf16, within bf16 rounding of the float32 ring."""
    ranks = ring[0]
    for r in ranks:
        assert r["bf16"] is not None
    got = gathered(ranks, "bf16")
    want = gathered(ranks, "ring", "out")
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max() + 2e-2
