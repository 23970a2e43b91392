"""The launch path and the summation order of K4b (the interpolation
backward, csrc/interp_bwd.cu), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against
``interpolate_backward_plain``. Here, without a card: its C entry point
against the argument types the wrapper binds, the plan the wrapper lays
out and the constants the C source shares with it; the rows a block the
wrapper picks; its refusals; and a numpy emulation of what the kernel
computes in its own order. A block owns `rows` df rows of one batch element
and scans that element's kept selection window by window, each warp
compacting its slice of the window by ballot, so that the window's list
keeps ascending (query, slot) order; the warp that owns a row adds w * g of
its entries into the row in that order, each product and each sum rounded
to float32, from 0. The emulation is held bit for bit against a numpy left
fold in ascending (query, slot) order, and within 1e-6 * max|df| of the
port's plain version (``scatter_add_``) and of the JAX package's VJP
through the Pallas kernel in interpret mode (a one-hot product, summed in
another order), on the same numpy inputs.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.ops.pallas_kernels.interp3 import interpolate_pallas
from pointcloud_bridge_tpu_torch.ops import _kernels, interpolate

F32 = np.float32
SRC = (_kernels.CSRC / "interp_bwd.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1).split()[0])


WARPS = constant("kWarps")
STEPS = constant("kSteps")  # 32-entry steps a warp scans a window
SLICE = 32 * STEPS
WINDOW = WARPS * SLICE
BAND = 1e-6  # of max|df|: the plain version and the Pallas VJP sum in another order


def c_parameters(symbol: str) -> list:
    m = re.search(r"PCB_API\s+int\s+" + symbol + r"\s*\(([^)]*)\)", SRC)
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_argtypes_match_the_c_entry_point():
    params = c_parameters(_kernels.INTERP_BWD.symbol)
    assert list(_kernels.INTERP_BWD.argtypes) == [
        _kernels._P if "*" in p else _kernels._I for p in params]
    assert params == ["const float* g", "const int* idx", "const float* w", "float* df",
                      "const int* plan", "int device", "void* stream"]


def test_plan_fields_in_the_order_c_reads_them():
    body = SRC[SRC.index("PCB_API int pcb_interpolate_backward("):]
    read = {int(m.group(2)): m.group(1)
            for m in re.finditer(r"const int (\w+) = plan\[(\d+)\];", body)}
    assert read == dict(enumerate(interpolate.INTERP_BWD_PLAN))


def test_the_c_constants_are_the_wrappers():
    """A block owns at most kMaxRows rows of kChunk channels; its shared
    memory (the accumulators, each warp's slice list of (query << 6 | row,
    weight) pairs, the warps' counts) fits the 227 KB a block may opt in to,
    three blocks to an SM; a row fits the 6 bits the list gives it."""
    assert constant("kChunk") == interpolate._BWD_CHUNK
    assert constant("kMaxRows") == max(interpolate._BWD_ROWS) == 64
    assert all(r % WARPS == 0 for r in interpolate._BWD_ROWS)
    assert "constexpr int kSmem = kMaxRows * kChunk * 4 + kWarps * kSlice * 8 + kWarps * 4;" in SRC
    smem = max(interpolate._BWD_ROWS) * interpolate._BWD_CHUNK * 4 + WARPS * SLICE * 8 + WARPS * 4
    assert 48 * 1024 < smem and 3 * smem <= 232_448


def test_the_division_by_k_is_exact():
    """div_k (the query of an entry, e / k, without a division): a shift for
    k = 1, 2, 4 and (e * 0xAAAAAAAB) >> 33 for k = 3, for every e < 2^31
    (held here at its ends and on a random sample)."""
    assert "__umulhi(e, 0xAAAAAAABu) >> 1 : e >> (k >> 1)" in SRC
    rng = np.random.default_rng(1)
    e = np.concatenate([np.arange(4096), 2**31 - 1 - np.arange(4096),
                        rng.integers(0, 2**31, 200_000)]).astype(np.uint64)
    for k in (1, 2, 3, 4):
        got = (e * 0xAAAAAAAB) >> 33 if k == 3 else e >> (k >> 1)
        np.testing.assert_array_equal(got, e // k)


# --------------------------------------------------------------- launch choices


@pytest.mark.parametrize("b,s,d,rows", [
    (4, 64, 512, 8), (4, 256, 256, 8), (4, 1024, 128, 16), (16, 64, 512, 16),
    (16, 256, 256, 32), (16, 1024, 128, 64), (4, 128, 1024, 16), (4, 512, 256, 16),
    (4, 1024, 256, 32), (16, 128, 1024, 64), (16, 512, 256, 64), (16, 1024, 256, 64),
    (1, 2, 64, 8), (4, 16384, 64, 64), (1, 64, 1, 8)])
def test_rows_a_block_by_the_shape(b, s, d, rows):
    assert interpolate.bwd_rows(b, s, d, 132) == rows


def test_rows_a_block_keep_the_card_busy():
    """The most rows (64, 32, 16, 8) whose blocks still number the SMs, else
    8; over B, S and D around every threshold."""
    for b in (1, 2, 4, 16):
        for s in range(1, 3000, 37):
            for d in (1, 64, 128, 129, 256, 1024):
                rows = interpolate.bwd_rows(b, s, d, 132)
                blocks = lambda r: b * -(-s // r) * -(-d // 128)  # noqa: E731
                assert rows in interpolate._BWD_ROWS
                assert rows == 8 or blocks(rows) >= 132
                assert rows == 64 or blocks(2 * rows) < 132


def test_plans_hold_the_launch():
    assert list(interpolate._interp_bwd_plan(4, 4096, 1024, 128, 3, True, 132)) == [
        4, 4096, 1024, 128, 3, 16, 1]
    assert list(interpolate._interp_bwd_plan(4, 512, 128, 1024, 4, False, 132, 16)) == [
        4, 512, 128, 1024, 4, 16, 0]


@pytest.mark.parametrize("args", [
    (65536, 4, 4, 4, 3, True, 132), (4, 2**29, 8, 4, 4, True, 132), (1, 2**25, 8, 4, 1, True, 132),
    (4, 64, 8, 4, 0, True, 132),
    (4, 64, 8, 4, 5, True, 132), (4, 64, 0, 4, 3, True, 132), (4, 64, 8, 0, 3, True, 132),
    (4, 64, 8, 4, 3, True, 132, 12), (4, 64, 8, 4, 3, True, 132, 128)])
def test_plan_refuses(args):
    with pytest.raises(ValueError):
        interpolate._interp_bwd_plan(*args)


# ------------------------------------------------ what the wrapper hands over


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors that pass the device check; every launch is recorded
    instead of made (there is no nvcc here)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_kernels, "stream_args", lambda t: (0, None))
    monkeypatch.setattr(_kernels, "sm_count", lambda device: 132)
    launched = []
    monkeypatch.setattr(_kernels.INTERP_BWD, "launch", lambda *args: launched.append(args))
    return launched


def selection(b, n, s, k, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, s, (b, n, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(size=(b, n, k)).astype(F32))
    return idx, w


def test_the_wrapper_hands_over_its_plan(as_if_on_the_card):
    idx, w = selection(2, 300, 40, 4)
    g = torch.zeros(2, 300, 256)
    df = interpolate.interpolate_backward_cuda(g, idx, w, 40)
    assert df.shape == (2, 40, 256) and df.dtype == torch.float32
    (args,) = as_if_on_the_card
    assert len(args) == len(_kernels.INTERP_BWD.argtypes)
    assert args[:4] == (g.data_ptr(), idx.data_ptr(), w.data_ptr(), df.data_ptr())
    plan = dict(zip(interpolate.INTERP_BWD_PLAN, args[4]))
    assert plan == dict(b=2, n=300, s=40, d=256, k=4, rows=8, vec=1)


def test_a_misaligned_g_takes_the_scalar_path(as_if_on_the_card):
    idx, w = selection(2, 64, 16, 3)
    flat = torch.zeros(2 * 64 * 128 + 1)
    g = flat[1:].view(2, 64, 128)  # contiguous, 4 bytes past 16-byte alignment
    interpolate.interpolate_backward_cuda(g, idx, w, 16)
    interpolate.interpolate_backward_cuda(torch.zeros(2, 64, 131), idx, w, 16)
    assert [dict(zip(interpolate.INTERP_BWD_PLAN, a[4]))["vec"] for a in as_if_on_the_card] == [
        0, 0]


def test_an_empty_df_launches_nothing(as_if_on_the_card):
    idx, w = selection(2, 64, 16, 3)
    assert interpolate.interpolate_backward_cuda(torch.zeros(2, 64, 0), idx, w, 16).shape == (
        2, 16, 0)
    assert not as_if_on_the_card


def test_the_wrapper_refuses_cpu_tensors():
    idx, w = selection(1, 32, 8, 3)
    before = _kernels.INTERP_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        interpolate.interpolate_backward_cuda(torch.zeros(1, 32, 5), idx, w, 8)
    assert _kernels.INTERP_BWD.launches == before


def bad_inputs(case: str):
    g = torch.zeros(2, 64, 32)
    idx, w = selection(2, 64, 16, 3)
    if case == "g float64":
        g = g.double()
    elif case == "idx int64":
        idx = idx.long()
    elif case == "w float64":
        w = w.double()
    elif case == "g not contiguous":
        g = torch.zeros(2, 32, 64).transpose(1, 2)
    elif case == "idx not contiguous":
        idx = idx.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "g rank 2":
        g = g[0]
    elif case == "idx of another N":
        idx, w = selection(2, 63, 16, 3)
    elif case == "w of another shape":
        w = w[..., :2].contiguous()
    elif case == "k = 5":
        idx, w = selection(2, 64, 16, 5)
    elif case == "k = 0":
        idx, w = idx[..., :0].contiguous(), w[..., :0].contiguous()
    elif case == "B over 65535":
        g = torch.zeros(65536, 1, 1)
        idx, w = selection(65536, 1, 16, 1)
    return g, idx, w


CASES = ["g float64", "idx int64", "w float64", "g not contiguous", "idx not contiguous",
         "g rank 2", "idx of another N", "w of another shape", "k = 5", "k = 0", "B over 65535"]


@pytest.mark.parametrize("case", CASES)
def test_the_wrapper_refuses(as_if_on_the_card, case):
    g, idx, w = bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        interpolate.interpolate_backward_cuda(g, idx, w, 16)
    assert not as_if_on_the_card


@pytest.mark.parametrize("shape,s", [((1, 2**16, 2**15), 8), ((1, 8, 4), 2**29)],
                         ids=["g of 2^31 elements", "df of 2^31 elements"])
def test_the_wrapper_refuses_2_31_elements(as_if_on_the_card, shape, s):
    """On the meta device: the tensors have shapes and no storage."""
    g = torch.empty(shape, device="meta")
    idx = torch.empty(shape[:2] + (3,), dtype=torch.int32, device="meta")
    w = torch.empty(shape[:2] + (3,), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        interpolate.interpolate_backward_cuda(g, idx, w, s)
    assert not as_if_on_the_card


# ------------------------------------------- K4b's summation, as the card runs it


def emulate_kernel(g, idx, w, s, rows):
    """csrc/interp_bwd.cu in numpy: for each batch element and each group of
    `rows` df rows, the windows of WINDOW entries; in each, the warps'
    slices in warp order, each compacted in lane order (the ballot); then
    each row's entries added in that list order into a float32 accumulator
    from 0, kept between windows. The 128-channel chunks and the owner warps
    change which thread adds, not the order of any row's sum, so they are
    left out."""
    b_, n, d = g.shape
    k = idx.shape[2]
    m = n * k
    df = np.full((b_, s, d), np.nan, F32)
    for b in range(b_):
        keys, wts = idx[b].reshape(-1), w[b].reshape(-1)
        for s0 in range(0, s, rows):
            here = min(rows, s - s0)
            acc = np.zeros((here, d), F32)
            for base in range(0, m, WINDOW):
                window = []
                for warp in range(WARPS):
                    for u in range(STEPS):
                        e = base + warp * SLICE + u * 32 + np.arange(32)
                        e = e[e < m]
                        r = keys[e].astype(np.int64) - s0
                        hit = (r >= 0) & (r < here)  # the ballot: lanes in order
                        window += zip(e[hit] // k, r[hit], wts[e[hit]])
                for q, r, wt in window:
                    acc[r] = acc[r] + wt * g[b, q]
            df[b, s0:s0 + here] = acc
    return df


def left_fold(g, idx, w, s):
    """df in ascending (query, slot) order, a float32 sum from 0 a row."""
    b_, n, d = g.shape
    df = np.zeros((b_, s, d), F32)
    for b in range(b_):
        for q in range(n):
            for t in range(idx.shape[2]):
                src = idx[b, q, t]
                if 0 <= src < s:
                    df[b, src] = df[b, src] + w[b, q, t] * g[b, q]
    return df


def plain(g, idx, w, s):
    return interpolate.interpolate_backward_plain(
        torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(w), s).numpy()


def clouds(b, n, s, rng):
    dst = rng.uniform(size=(b, n, 3)).astype(F32)
    return dst, np.ascontiguousarray(dst[:, :s])


def assert_in_band(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=BAND * scale)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n,s,d,rows", [
    (256, 64, 20, 8), (600, 100, 7, 16), (29, 11, 5, 8), (300, 45, 33, 64), (1100, 40, 3, 32)],
    ids=["fp3-like", "S not a multiple of 32", "N under 32", "one block a row group",
         "two windows"])
def test_emulation_on_a_kept_selection(n, s, d, k, rows):
    """The selection the forward keeps (the port's plain selection, which
    tests/test_torch_sampling_launch.py holds to the Pallas kernel bit for
    bit) of random clouds: bit for bit against the left fold, within band of
    the plain version and of the Pallas VJP in interpret mode."""
    rng = np.random.default_rng(n + s + k)
    dst, src = clouds(2, n, s, rng)
    idx, w = interpolate.interpolate_select_plain(torch.from_numpy(dst), torch.from_numpy(src), k)
    idx, w = idx.numpy().astype(np.int32), w.numpy()
    g = rng.normal(size=(2, n, d)).astype(F32)
    got = emulate_kernel(g, idx, w, s, rows)
    np.testing.assert_array_equal(got, left_fold(g, idx, w, s))
    assert_in_band(got, plain(g, idx, w, s))
    feats = jnp.asarray(rng.normal(size=(2, s, d)).astype(F32))
    _, vjp = jax.vjp(lambda f: interpolate_pallas(jnp.asarray(dst), jnp.asarray(src), f, k, True),
                     feats)
    assert_in_band(got, np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("case", ["one source nearest to all", "two sources, both to all",
                                  "half the sources far away"])
def test_emulation_on_skewed_kept_selections(case):
    """Selections the geometry skews, so that the Pallas VJP sees them too:
    every query's nearest source is one point (k=1); S=2 with k=2 (every
    query on both); half of 40 sources far away, chosen by no query (k=4,
    their rows exactly 0)."""
    rng = np.random.default_rng(len(case))
    dst = rng.uniform(size=(2, 300, 3)).astype(F32)
    if case == "one source nearest to all":
        src, k = np.stack([np.full((2, 3), 0.5), np.full((2, 3), 9.0)], 1).astype(F32), 1
    elif case == "two sources, both to all":
        src, k = rng.uniform(size=(2, 2, 3)).astype(F32), 2
    else:
        src, k = rng.uniform(size=(2, 40, 3)).astype(F32), 4
        src[:, 20:] += 50.0
    idx, w = interpolate.interpolate_select_plain(torch.from_numpy(dst), torch.from_numpy(src), k)
    idx, w = idx.numpy().astype(np.int32), w.numpy()
    s = src.shape[1]
    g = rng.normal(size=(2, 300, 24)).astype(F32)
    got = emulate_kernel(g, idx, w, s, 8)
    np.testing.assert_array_equal(got, left_fold(g, idx, w, s))
    if case == "one source nearest to all":
        assert not got[:, 1].any()
    elif case == "half the sources far away":
        assert not got[:, 20:].any() and got[:, :20].any(-1).all()
    assert_in_band(got, plain(g, idx, w, s))
    feats = jnp.asarray(rng.normal(size=(2, s, 24)).astype(F32))
    _, vjp = jax.vjp(lambda f: interpolate_pallas(jnp.asarray(dst), jnp.asarray(src), f, k, True),
                     feats)
    assert_in_band(got, np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_emulation_with_every_query_on_one_source(k):
    """The worst contention and the longest list: every slot of every query
    names row 1 of S = 2 (row 0 is chosen by no query and stays 0)."""
    rng = np.random.default_rng(k)
    n, d = 1500, 6
    idx = np.ones((2, n, k), np.int32)
    w = rng.uniform(size=(2, n, k)).astype(F32)
    g = rng.normal(size=(2, n, d)).astype(F32)
    got = emulate_kernel(g, idx, w, 2, 8)
    np.testing.assert_array_equal(got, left_fold(g, idx, w, 2))
    assert not got[:, 0].any()
    assert_in_band(got, plain(g, idx, w, 2))


def test_emulation_leaves_unchosen_sources_at_zero():
    """Sources that no query chose: exactly 0, as the plain version."""
    rng = np.random.default_rng(5)
    n, s, d, k = 200, 64, 9, 3
    idx = rng.integers(0, s // 4, (2, n, k)).astype(np.int32) * 4  # every 4th row
    w = rng.uniform(size=(2, n, k)).astype(F32)
    g = rng.normal(size=(2, n, d)).astype(F32)
    got = emulate_kernel(g, idx, w, s, 16)
    chosen = np.zeros((2, s), bool)
    for b in range(2):
        chosen[b, np.unique(idx[b])] = True
    assert (got[~chosen] == 0).all() and got[chosen].any(-1).all()
    np.testing.assert_array_equal(got, left_fold(g, idx, w, s))
    assert_in_band(got, plain(g, idx, w, s))


def test_emulation_at_the_window_edges():
    """N * k at one entry under, at and over a window, and over two."""
    rng = np.random.default_rng(9)
    for m in (WINDOW - 1, WINDOW, WINDOW + 1, 2 * WINDOW + 3):
        k = 1 if m % 2 else 2
        n = m // k
        idx = rng.integers(0, 24, (1, n, k)).astype(np.int32)
        w = rng.uniform(size=(1, n, k)).astype(F32)
        g = rng.normal(size=(1, n, 4)).astype(F32)
        np.testing.assert_array_equal(emulate_kernel(g, idx, w, 24, 8), left_fold(g, idx, w, 24))


def test_indices_out_of_range_are_never_written_through():
    """An index below 0 or at S and above matches no block's rows."""
    rng = np.random.default_rng(3)
    idx = rng.integers(-3, 19, (2, 50, 3)).astype(np.int32)
    w = rng.uniform(size=(2, 50, 3)).astype(F32)
    g = rng.normal(size=(2, 50, 4)).astype(F32)
    got = emulate_kernel(g, idx, w, 16, 8)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, left_fold(g, idx, w, 16))


@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_the_rows_a_block_change_no_bit(rows):
    rng = np.random.default_rng(rows)
    dst, src = clouds(2, 400, 100, rng)
    idx, w = interpolate.interpolate_select_plain(torch.from_numpy(dst), torch.from_numpy(src), 4)
    idx, w = idx.numpy().astype(np.int32), w.numpy()
    g = rng.normal(size=(2, 400, 12)).astype(F32)
    np.testing.assert_array_equal(emulate_kernel(g, idx, w, 100, rows), left_fold(g, idx, w, 100))
