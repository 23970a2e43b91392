"""Model export through ``torch.export`` (counterpart of
pointcloud_bridge_tpu/utils/export.py, which serializes StableHLO).

  - ``export_program``: ``torch.export.export`` of the eval-mode forward at
    fixed shapes (``batch_size``, ``num_points``, ``feat_ch``) on the
    model's device, written with ``torch.export.save`` (a ``.pt2`` file).
  - ``load_program``: ``torch.export.load``, returning a callable module.
  - ``dump_program_text``: the exported graph in its readable form.

Each forward kernel enters the graph as its custom op (``pcb::fps``,
``pcb::ball_query``, ``pcb::ball_query_radii``, ``pcb::group``,
``pcb::knn``, ``pcb::knn_c``, ``pcb::interpolate``, ``pcb::attention``,
``pcb::segment_sum``; ops/_kernels.py ``custom_op``), not as its plain
version: a program exported on either device runs the kernels where its
inputs lie on the card and the plain versions where they lie on the CPU.
Loading imports the port's ops, which registers them. The program is an
inference program: its ops have no backward.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _exported(model: torch.nn.Module, variables: Optional[Any], batch_size: int,
              num_points: int, feat_ch: int) -> torch.export.ExportedProgram:
    if variables is not None:
        model.load_state_dict(variables, strict=True)
    model.eval()
    dev = next(model.parameters()).device
    xyz = torch.zeros(batch_size, num_points, 3, device=dev)
    feats = torch.zeros(batch_size, num_points, feat_ch, device=dev)
    with torch.no_grad():
        return torch.export.export(model, (xyz, feats))


def _write_dir(out_path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)


def export_program(
    model: torch.nn.Module, variables: Optional[Any], out_path: str, batch_size: int = 1,
    num_points: int = 4096, feat_ch: int = 3,
) -> str:
    """Export the inference forward ``model(xyz, feats)`` at [batch_size,
    num_points, 3] and [batch_size, num_points, feat_ch] float32 on the
    model's device and save it to ``out_path``. ``variables``, a state_dict
    or None (the model's own weights), is loaded strictly first."""
    program = _exported(model, variables, batch_size, num_points, feat_ch)
    _write_dir(out_path)
    torch.export.save(program, out_path)
    return out_path


def load_program(path: str) -> torch.nn.Module:
    """Load a program that ``export_program`` saved; call it as the model:
    ``load_program(path)(xyz, feats)``."""
    from .. import ops  # noqa: F401  (registers the pcb:: ops)

    return torch.export.load(path).module()


def dump_program_text(
    model: torch.nn.Module, variables: Optional[Any], out_path: str, batch_size: int = 1,
    num_points: int = 4096, feat_ch: int = 3,
) -> str:
    """Write the exported graph of ``export_program``'s forward, each node
    with its shapes, as text."""
    program = _exported(model, variables, batch_size, num_points, feat_ch)
    _write_dir(out_path)
    with open(out_path, "w") as f:
        f.write(program.graph_module.print_readable(print_output=False))
    return out_path
