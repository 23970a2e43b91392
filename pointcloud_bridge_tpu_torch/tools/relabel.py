"""LAS classification remapping (tools/change_label_8c-5c.py:7-40,
tools/tranlabel.py:7-66, utils/BriPCDMulti_4class.py:126-130)."""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from ..data.lasio import read_las, write_las

# 8-class YBC steel -> 5-class road mapping (change_label_8c-5c.py)
MAP_8C_TO_5C: Dict[int, int] = {0: 0, 1: 2, 2: 2, 3: 2, 4: 2, 5: 1, 6: 3, 7: 4}

# 5-class -> 4-class merge (BriPCDMulti_4class.py:126-130):
# >4 -> 0; merge 3 -> 2; 4 -> 3
def map_5c_to_4c(labels: np.ndarray) -> np.ndarray:
    out = labels.copy()
    out[out > 4] = 0
    out[out == 3] = 2
    out[out == 4] = 3
    return out


def remap_labels(labels: np.ndarray, mapping: Dict[int, int], default: int = 0) -> np.ndarray:
    lut = np.full(256, default, np.uint8)
    for src, dst in mapping.items():
        lut[src] = dst
    return lut[labels.astype(np.uint8)]


def relabel_las(src: str, dst: str, mapping: Dict[int, int]) -> None:
    las = read_las(src)
    new_labels = remap_labels(las.classification, mapping)
    write_las(dst, las.xyz, las.colors01, new_labels)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LAS label remapper")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument(
        "--map",
        default="8c5c",
        help="'8c5c', '5c4c', or comma list like '0:0,1:2,...'",
    )
    args = ap.parse_args(argv)
    if args.map == "8c5c":
        relabel_las(args.src, args.dst, MAP_8C_TO_5C)
    elif args.map == "5c4c":
        las = read_las(args.src)
        write_las(args.dst, las.xyz, las.colors01, map_5c_to_4c(las.classification))
    else:
        mapping = {
            int(a): int(b)
            for a, b in (pair.split(":") for pair in args.map.split(","))
        }
        relabel_las(args.src, args.dst, mapping)


if __name__ == "__main__":
    main()
