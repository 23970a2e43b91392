"""The launch path of the port's CUDA kernels, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there). What a launch hands them is decided
here, in Python, and is checked without a card: every ``Kernel.argtypes``
against its C entry point's parameters, read from the sources; the fast
divisor that K3 (csrc/group.cu) uses for row // K, against Python's ``//``
over the shapes the models give it and near the wrappers' limits; the lanes
and the tile the group wrappers pick, and the row mapping of a warp's
tile; and the checks that keep a bad tensor from reaching a kernel.
"""

import re

import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu_torch.ops import _kernels, grouping

# the (S, K, C) of every grouping call of SSG and BriStruNet (chip_smoke.py's
# SSG_LEVELS and BRISTRUNET_LEVELS), at B = 4 and 16
MODEL_GROUPS = ((1024, 32, 3), (256, 32, 128), (64, 32, 256),
                (1024, 16, 3), (1024, 32, 3), (512, 16, 256), (512, 32, 256),
                (128, 16, 512), (128, 32, 512))


def c_parameters(symbol: str) -> list:
    """The parameter list of the PCB_API function ``symbol`` in csrc/*.cu."""
    for path in sorted(_kernels.CSRC.glob("*.cu")):
        m = re.search(r"PCB_API\s+int\s+" + symbol + r"\s*\(([^)]*)\)", path.read_text())
        if m:
            return [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"{symbol}: no PCB_API definition in csrc/")


def ctypes_of(param: str):
    """The ctypes type a C parameter must be passed as."""
    if "*" in param:
        return _kernels._P
    kind = param.rsplit(" ", 1)[0].replace("const ", "").strip()
    return {"int": _kernels._I, "float": _kernels._F, "long long": _kernels._L}[kind]


@pytest.mark.parametrize("kernel", _kernels.KERNELS, ids=lambda k: k.name)
def test_argtypes_match_the_c_entry_point(kernel):
    params = c_parameters(kernel.symbol)
    assert len(kernel.argtypes) == len(params), params
    assert list(kernel.argtypes) == [ctypes_of(p) for p in params]
    assert params[-2:] == ["int device", "void* stream"]


@pytest.mark.parametrize("source,symbol,fields", [
    ("group.cu", "pcb_group", grouping.GROUP_PLAN),
    ("group_bwd.cu", "pcb_group_backward", grouping.GROUP_BWD_PLAN),
])
def test_plan_fields_in_the_order_c_reads_them(source, symbol, fields):
    """K3 and K3b take their integers as one `plan` array: the C entry point
    reads slot i into the variable that GROUP_PLAN / GROUP_BWD_PLAN names."""
    text = (_kernels.CSRC / source).read_text()
    body = text[text.index(f"PCB_API int {symbol}("):]
    read = {}
    for m in re.finditer(r"const int (\w+) = (?:\(int\))?plan\[(\d+)\];", body):
        read[int(m.group(2))] = m.group(1)
    m = re.search(r"FastDiv by_k\{plan\[(\d+)\], plan\[(\d+)\]\}", body)
    if m:
        read[int(m.group(1))], read[int(m.group(2))] = "k_mul", "k_shift"
    assert read == dict(enumerate(fields))


def test_plans_hold_the_launch():
    plan = grouping._group_plan(4, 1024, 512, 32, 256)
    assert list(plan) == [4, 1024, 512, 32, 256, *grouping.group_launch(259),
                          *grouping.fast_divisor(32)]
    assert list(grouping._group_plan(4, 512, 128, 32, 512, False))[5:8] == [32, 4, 0]
    assert list(grouping._group_backward_plan(4, 1024, 256, 32, 131, 3, 131)) == [
        4, 1024, 256, 32, 131, 3, 131, 32, 4]
    assert list(grouping._group_backward_plan(4, 4096, 1024, 16, 6, 3, 6))[7:] == [4, 1]


def test_kernels_are_bound_lazily():
    """No build or load at import: nothing is bound until the first launch."""
    for k in _kernels.KERNELS:
        assert k.fn is None
    assert "fn=" not in repr(_kernels.GROUP)


def fast_quotient(n: np.ndarray, d: int) -> np.ndarray:
    """What FastDiv::div computes on the card, in 64-bit numpy integers."""
    mul, shift = grouping.fast_divisor(d)
    n = n.astype(np.uint64)
    if mul == 0:
        return n
    return ((n * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shift)


@pytest.mark.parametrize("s,k,c", MODEL_GROUPS)
def test_fast_divisor_over_the_model_rows(s, k, c):
    """Every row of a batch element, row // K as the kernel finds s."""
    rows = np.arange(s * k, dtype=np.int64)
    np.testing.assert_array_equal(fast_quotient(rows, k), rows // k)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 16, 31, 32, 33, 64, 100, 127, 128, 1000,
                               4096, 65535, 65536, 2**20 + 1, 2**30 - 1, 2**30, 2**30 + 1,
                               2**31 - 1])
def test_fast_divisor_near_the_limit(d):
    """Dividends at both ends of [0, 2^31), around every multiple of d near
    2^30 and 2^31, and random ones."""
    rng = np.random.default_rng(d)
    top = 2**31
    picks = [np.arange(0, 4097), np.arange(top - 4096, top), np.arange(2**30 - 2048, 2**30 + 2048),
             rng.integers(0, top, 200_000)]
    for base in (2**30 // d * d, (top - 1) // d * d, d * 1000, d):
        if base < top:
            picks.append(np.clip(np.arange(base - 3, base + 4), 0, top - 1))
    n = np.concatenate(picks).astype(np.int64)
    np.testing.assert_array_equal(fast_quotient(n, d), n // d)


def test_fast_divisor_constants_fit_32_bits():
    for d in list(range(1, 5000)) + [2**m + e for m in range(12, 31) for e in (-1, 0, 1)]:
        mul, shift = grouping.fast_divisor(d)
        assert 0 <= mul < 2**32 and 0 <= shift < 32, d
    with pytest.raises(ValueError):
        grouping.fast_divisor(0)
    with pytest.raises(ValueError):
        grouping.fast_divisor(2**31)


@pytest.mark.parametrize("c,launch", [
    (3, (8, 8, True)),       # sa1: width 6, 8 lanes a row, a tile of 32 rows
    (128, (32, 8, True)),    # widths from 17 up: a warp a row
    (256, (32, 8, True)),    # width 259: 8 rows are 2,072 floats of the warp's 3,072
    (380, (32, 8, True)),    # width 383: the widest 8-row tile
    (381, (32, 4, True)),
    (512, (32, 4, True)),    # width 515: 4 rows staged
    (0, (4, 4, True)),       # xyz alone: width 3, 8 groups of 4 rows
    (1, (4, 4, True)),
    (13, (16, 8, True)),
    (764, (32, 4, True)),    # width 767: the widest tile that fits
    (765, (32, 4, False)),   # width 768: 4-byte stores
    (2045, (32, 4, False)),
])
def test_group_launch_by_width(c, launch):
    assert grouping.group_launch(3 + c) == launch


@pytest.mark.parametrize("lanes,per_group", [(4, 4), (8, 4), (8, 8), (16, 4), (16, 8),
                                              (32, 4), (32, 8)])
@pytest.mark.parametrize("rows", [1, 5, 35, 16 * 1024, 32 * 1024 + 3])
def test_warp_tiles_cover_every_row_once(lanes, per_group, rows):
    """The row mapping of csrc/group.cu: warp w's step r writes row
    w * tile + r * (32 / lanes) + group of its batch element, for the warps
    that the grid launches (ceil(rows / (tile * 4)) blocks of 4 warps)."""
    groups = 32 // lanes
    tile = groups * per_group
    assert tile <= 32
    blocks = -(-rows // (tile * 4))
    warp = np.arange(blocks * 4)[:, None, None]
    step = np.arange(per_group)[None, :, None]
    group = np.arange(groups)[None, None, :]
    row = warp * tile + step * groups + group
    written = np.sort(row[row < rows])
    np.testing.assert_array_equal(written, np.arange(rows))


@pytest.mark.parametrize("wout,lanes,vec", [
    (3, 4, 1), (128, 32, 4), (256, 32, 4), (512, 32, 4), (131, 32, 1), (4, 4, 4),
    (16, 4, 4), (13, 16, 1), (1, 4, 1), (19, 32, 1)])
def test_group_backward_lanes_by_width(wout, lanes, vec):
    """K3b: four channels a lane where c1 - c0 is a multiple of 4, and the
    lanes of a slot cover a chunk of lanes * vec channels."""
    got_vec = 4 if wout % 4 == 0 else 1
    assert (grouping.group_lanes(wout // got_vec), got_vec) == (lanes, vec)


# ------------------------------------------- what keeps a bad tensor out


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors that pass the device check, so that the checks behind it
    are reached; a launch would fail (no nvcc here), so every case must be
    refused before one."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def group_inputs(b=2, n=32, s=4, k=8, c=5):
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32))
    return (xyz, xyz[:, :s].contiguous(), torch.zeros((b, s, k), dtype=torch.int32),
            torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)))


def test_group_wrappers_refuse_cpu_tensors():
    xyz, centers, idx, feats = group_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        grouping.group_cuda(xyz, centers, idx, feats)
    with pytest.raises(ValueError, match="CUDA"):
        grouping.group_cuda(xyz, centers, idx, None)
    with pytest.raises(ValueError, match="CUDA"):
        grouping.group_backward_cuda(torch.zeros((2, 4, 8, 8)), idx, 32, 3, 8)


@pytest.mark.parametrize("case", ["idx int64", "xyz float64", "features float16",
                                  "xyz not contiguous", "features not contiguous",
                                  "idx rank 2", "centers of another S", "features of another N",
                                  "xyz of 4 channels", "idx of another B", "B over 65535",
                                  "staged tile too large"])
def test_group_cuda_refuses(as_if_on_the_card, case):
    xyz, centers, idx, feats = group_inputs()
    kwargs = {}
    if case == "idx int64":
        idx = idx.long()
    elif case == "xyz float64":
        xyz = xyz.double()
    elif case == "features float16":
        feats = feats.half()
    elif case == "xyz not contiguous":
        xyz = xyz.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "features not contiguous":
        feats = torch.zeros((2, 5, 32)).transpose(1, 2)
    elif case == "idx rank 2":
        idx = idx[0]
    elif case == "centers of another S":
        centers = xyz[:, :5].contiguous()
    elif case == "features of another N":
        feats = feats[:, :31].contiguous()
    elif case == "xyz of 4 channels":
        xyz = torch.zeros((2, 32, 4))
    elif case == "idx of another B":
        idx = torch.zeros((3, 4, 8), dtype=torch.int32)
    elif case == "B over 65535":
        xyz = torch.zeros((65536, 1, 3))
        centers, idx, feats = xyz, torch.zeros((65536, 1, 1), dtype=torch.int32), None
    elif case == "staged tile too large":
        feats = torch.zeros((2, 32, 800))
        kwargs["staged"] = True
    with pytest.raises((TypeError, ValueError)):
        grouping.group_cuda(xyz, centers, idx, feats, **kwargs)


@pytest.mark.parametrize("case", ["g float64", "idx int64", "g not contiguous", "g rank 3",
                                  "idx of another K", "c0 == c1", "c1 past the width",
                                  "c0 negative", "N = 0", "B over 65535"])
def test_group_backward_cuda_refuses(as_if_on_the_card, case):
    g = torch.zeros((2, 4, 8, 8))
    idx = torch.zeros((2, 4, 8), dtype=torch.int32)
    n, c0, c1 = 32, 3, 8
    if case == "g float64":
        g = g.double()
    elif case == "idx int64":
        idx = idx.long()
    elif case == "g not contiguous":
        g = torch.zeros((2, 4, 8, 16))[..., ::2]
    elif case == "g rank 3":
        g = g[0]
    elif case == "idx of another K":
        idx = idx[..., :7].contiguous()
    elif case == "c0 == c1":
        c0 = c1 = 3
    elif case == "c1 past the width":
        c1 = 9
    elif case == "c0 negative":
        c0 = -1
    elif case == "N = 0":
        n = 0
    elif case == "B over 65535":
        g = torch.zeros((65536, 1, 1, 8))
        idx = torch.zeros((65536, 1, 1), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        grouping.group_backward_cuda(g, idx, n, c0, c1)


def test_check_tensor_messages(as_if_on_the_card):
    t = torch.zeros((2, 3))
    _kernels.check_tensor("t", t, torch.float32, 2)
    with pytest.raises(TypeError, match="float64"):
        _kernels.check_tensor("t", t.double(), torch.float32, 2)
    with pytest.raises(ValueError, match="3 dims"):
        _kernels.check_tensor("t", t, torch.float32, 3)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.check_tensor("t", t.t(), torch.float32, 2)
