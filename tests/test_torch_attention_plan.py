"""The tile plan of the bf16 attention kernels (csrc/flash_attn_bf16.cuh),
on the CPU: the Python mirror ``ops/attention.py::BF16_PLAN`` against the C
table, every head width's blocks within the shared memory a block may have,
the TMA boxes and the wgmma shapes against every D, the grid limit that
``_check_cuda`` enforces, and the product lines that
probes/bf16_fault_probe.py plants its faults in. Nothing here needs nvcc or
a card: the kernels themselves are held to their plain versions on the card
(chip_smoke.py phase 3e)."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import re

import pytest
import torch

from pointcloud_bridge_tpu_torch.ops import attention as attn_ops

HEADER = attn_ops._kernels.CSRC / "flash_attn_bf16.cuh"
MAX_SHARED = 232448  # bytes of shared memory a block may have on sm_90


def c_plan() -> dict:
    """The rows of PCB_BF16_PLAN in csrc/flash_attn_bf16.cuh."""
    rows = re.findall(r"^\s*X\(([\d, ]+)\)", HEADER.read_text(), re.M)
    plan = {}
    for row in rows:
        d, fbn, fst, qbn, qst, kbq, kst, split = (int(x) for x in row.split(","))
        plan[d] = (fbn, fst, qbn, qst, kbq, kst, bool(split))
    return plan


def test_python_plan_is_the_c_plan():
    assert c_plan() == attn_ops.BF16_PLAN
    assert tuple(attn_ops.BF16_PLAN) == attn_ops.FLASH_HEAD_DIMS


def test_c_constants_the_plan_assumes():
    text = HEADER.read_text()
    assert re.search(r"constexpr int kRows = (\d+);", text).group(1) == str(attn_ops.BF16_ROWS)
    assert re.search(r"constexpr int kBox = (\d+);", text).group(1) == str(attn_ops.BF16_BOX)
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in text  # a box row of 32 bf16 is 64 bytes
    assert "(2ull << 62)" in text  # the wgmma descriptors' 64-byte swizzle


@pytest.mark.parametrize("d", attn_ops.FLASH_HEAD_DIMS)
def test_plan_fits_every_head_width(d):
    fbn, fst, qbn, qst, kbq, kst, split = attn_ops.BF16_PLAN[d]
    # shared memory: forward, dq, dk/dv
    assert all(b <= MAX_SHARED for b in attn_ops.bf16_smem_bytes(d)), attn_ops.bf16_smem_bytes(d)
    # a TMA box and a column block are 32 channels (64 bytes): they tile D
    assert d % attn_ops.BF16_BOX == 0
    # the first products are wgmma m64nNk16 with N the step's rows (32, 64
    # or 128 are instantiated); the second ones run over the step's rows in
    # k-steps of 16 and over D in pieces of 64 and 32 channels
    for rows in (fbn, qbn, kbq):
        assert rows in (32, 64, 128) and rows % 16 == 0
    assert d % 64 in (0, 32)
    # each loop runs a step behind on its second products and holds two
    # stages: a third lets the producer load ahead
    assert min(fst, qst, kst) >= 3
    # dk/dv: without the split a consumer thread holds dK and dV (D floats)
    # beside S^T and dP^T (kbq floats); with it, D/2 beside them
    held = (d / 2 if split else d) + kbq
    assert held <= 192, held
    assert split == (d >= 160)


@pytest.mark.parametrize("d", attn_ops.FLASH_HEAD_DIMS)
def test_the_smem_of_a_block_counts_every_tile(d):
    """bf16_smem_bytes against the tiles written out: 1024 bytes of slack,
    the resident 64-row tiles (q twice; q and do twice; k and v, twice each
    without the split), the ring, dk/dv's statistics a stage (lse and delta
    of its queries), the barriers."""
    fbn, fst, qbn, qst, kbq, kst, split = attn_ops.BF16_PLAN[d]
    tile = lambda rows: rows * d * 2  # noqa: E731
    fwd = 1024 + 2 * tile(64) + fst * 2 * tile(fbn) + 8 * (2 * fst + 1)
    dq = 1024 + 4 * tile(64) + qst * 2 * tile(qbn) + 8 * (2 * qst + 1)
    dkv = (1024 + (2 if split else 4) * tile(64) + kst * 2 * tile(kbq) + 4 * kst * 2 * kbq
           + 8 * (2 * kst + 1))
    assert attn_ops.bf16_smem_bytes(d) == (fwd, dq, dkv)


def _cuda_meta(b, n, h, d):
    return torch.empty((b, n, h, d), dtype=torch.bfloat16, device="meta")


def test_check_cuda_takes_the_grid_up_to_its_limit(monkeypatch):
    """The most blocks a launch takes is one per 64 rows a (batch, head)
    (a block of one consumer warpgroup; dk/dv with its split): _check_cuda
    refuses a shape at 2^31 of them and takes one just under."""
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    b, d = 2**15, 32
    under = _cuda_meta(b, 64 * 2**16 - 64, 1, d)
    attn_ops._check_cuda(under, under, under)
    at = _cuda_meta(b, 64 * 2**16, 1, d)
    with pytest.raises(ValueError, match="2\\^31 blocks"):
        attn_ops._check_cuda(at, at, at)
    ragged = _cuda_meta(b, 64 * 2**16 - 63, 1, d)  # ceil(n / 64) = 2^16
    with pytest.raises(ValueError, match="2\\^31 blocks"):
        attn_ops._check_cuda(ragged, ragged, ragged)


@pytest.mark.parametrize("fault", ["fwd", "dq", "dv", "dk"])
def test_fault_lines_are_products_of_the_step(fault):
    """Each planted fault skips a second product (weighted_rows) at one step
    of its kernel's loop over the streamed tiles."""
    from pointcloud_bridge_tpu_torch.probes import bf16_fault_probe as probe

    source_name, line = probe.FAULTS[fault]
    assert line.startswith("flash_bf16::weighted_rows<")
    text = (attn_ops._kernels.CSRC / source_name).read_text()
    assert text.count(line) == 1
    # the line sits in the body of the loop from step 1 on (step 0 is peeled)
    loop = text.rindex("for (int step = 1; step <", 0, text.index(line))
    body = text[loop:text.index(line)]
    assert body.count("{") > body.count("}")
