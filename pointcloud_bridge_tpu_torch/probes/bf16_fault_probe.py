#!/usr/bin/env python3
"""Check that phase 3e of chip_smoke.py fails a subtly wrong bf16 attention
kernel, on the card.

    python3 pointcloud_bridge_tpu_torch/probes/bf16_fault_probe.py [fault ...]

Nothing here is on the port's main path. For each fault (all four by
default) it copies the checkout into a temporary directory, plants the
fault in the copy's kernel source, runs ``chip_smoke.py --attention-bf16``
there (which builds the copy's kernels) and reads its exit code and its
first failed band. A fault skips one second product (a wgmma from
registers, ``weighted_rows``) at step 1 of its kernel's loop; each loop runs
a step behind on its second products, so that is step 0's tile, 1/32 to
1/64 of each sum at N = 4096:

- ``fwd``: K6-bf16's P . V (the softmax's sums keep the tile);
- ``dq``: the dq kernel's dS . K;
- ``dv``: the dk/dv kernel's P^T . dO;
- ``dk``: the dk/dv kernel's dS^T . Q.

It exits 1 if phase 3e passes with any fault planted. The checkout itself
is never changed.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = Path("pointcloud_bridge_tpu_torch") / "csrc"
# fault -> (kernel source, the product's line that the fault makes skip step 1)
FAULTS = {
    "fwd": ("flash_attn_bf16.cu", "flash_bf16::weighted_rows<D, BN>(acc, p, sv_prev, BN);"),
    "dq": ("flash_attn_bwd_bf16.cu", "flash_bf16::weighted_rows<D, BN>(acc, ds, sk_prev, BN);"),
    "dv": ("flash_attn_bwd_bf16.cu", "flash_bf16::weighted_rows<D, BQ>(accv, pt, sdo, BQ);"),
    "dk": ("flash_attn_bwd_bf16.cu", "flash_bf16::weighted_rows<D, BQ>(acck, dst, sq, BQ);"),
}
IGNORED = shutil.ignore_patterns(".git", "build", "chiprun_out", "experiments", "__pycache__")


def plant(source: str, fault: str) -> str:
    """The kernel source with ``fault`` planted: its product skipped at
    step 1. Raises unless the product's line is there exactly once."""
    line = FAULTS[fault][1]
    if source.count(line) != 1:
        raise ValueError(f"{fault}: the line is there {source.count(line)} times, not once")
    return source.replace(line, "if (step != 1) " + line)


def run(fault: str) -> tuple:
    """-> (exit code of phase 3e with ``fault`` planted, its failed band)."""
    with tempfile.TemporaryDirectory(prefix="pcb_fault_") as tmp:
        copy = Path(tmp) / "repo"
        shutil.copytree(ROOT, copy, ignore=IGNORED)
        path = copy / CSRC / FAULTS[fault][0]
        path.write_text(plant(path.read_text(), fault))
        done = subprocess.run([sys.executable, "chip_smoke.py", "--attention-bf16"], cwd=copy,
                              capture_output=True, text=True, timeout=600)
    failed = [ln for ln in done.stderr.splitlines() if ln.startswith("AssertionError")]
    return done.returncode, failed[-1] if failed else ""


def main() -> None:
    faults = sys.argv[1:] or list(FAULTS)
    caught = True
    for fault in faults:
        code, failed = run(fault)
        print(f"planted {fault}: phase 3e exit {code}; {failed or 'no band failed'}", flush=True)
        caught &= code != 0 and bool(failed)
    if not caught:
        raise SystemExit("bf16_fault_probe: phase 3e did not fail a planted fault on a band")


if __name__ == "__main__":
    main()
