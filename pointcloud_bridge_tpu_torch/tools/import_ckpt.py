"""One-command import of a reference torch checkpoint into the port's format
(counterpart of pointcloud_bridge_tpu/tools/import_ckpt.py).

A reference training run's checkpoint (a ``train_MulSca_PN2.py:290-313``
wrapped save, ``{"model_state_dict": ..., "epoch": ..., "class_avg_iou":
...}``, or a raw state_dict) becomes an experiment directory that the port's
CLIs serve as it stands:

  python -m pointcloud_bridge_tpu_torch.tools.import_ckpt \\
      --model pointnet2_ssg --torch-ckpt /path/best_model.pth --out exp_dir
  python -m pointcloud_bridge_tpu_torch.infer_cli blocks \\
      --checkpoint exp_dir --model pointnet2_ssg --data-dir ... --device cuda

The conversion is the two steps of ``utils/weights.py::
reference_state_dict``: the JAX package's rules (``utils/torch_import.py``,
copied) to the flax layout, then the port's rule table to its state_dict. By default the converted variables
are also checked leaf for leaf against ``state_dict_to_flax`` of a fresh port
model built with ``--num-classes`` and ``--feature-dim``, so a wrong value
fails here and not at serve time, and the state_dict then loads into that
model with ``strict=True``. The command runs on the host; it needs no card.

The checkpoint is one ``torch.save`` dict at ``<out>/<tag>`` (the port's
format, ``utils/checkpoint.py``): ``model`` holds the state_dict,
``source_torch`` the absolute path of the .pth, and the wrapper's int, float
and str entries (``epoch``, ``class_avg_iou``, ...) sit beside them as they
were saved; the JAX tool writes those into a ``.meta.json``, the port keeps
them in the checkpoint itself. Partsize MSG checkpoints use the 9-channel
S3DIS column contract: pass ``--feature-dim 9``. The JAX tool's
``--num-points`` (the shape of its flax init) has no counterpart: the port's
template needs no points.
"""

from __future__ import annotations

import argparse
import inspect
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="import a reference torch .pth checkpoint"
    )
    ap.add_argument("--model", required=True,
                    help="registry name with import rules (pointnet2_ssg, "
                         "pointnet, dgcnn, dgcnn_global, randlanet, ptv3, "
                         "pointnet2_sem_seg, pointnet2_msg, pointnet_sem_seg)")
    ap.add_argument("--torch-ckpt", required=True, help="path to the .pth")
    ap.add_argument("--out", required=True,
                    help="experiment dir to write (checkpoint lands in "
                         "<out>/best_model, where infer_cli looks first)")
    ap.add_argument("--tag", default="best_model",
                    choices=["best_model", "latest_checkpoint"])
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--feature-dim", type=int, default=3,
                    help="input feature channels of the trained model "
                         "(9 for Partsize S3DIS-column checkpoints)")
    ap.add_argument("--no-strict", action="store_true",
                    help="tolerate unconsumed torch keys (extra heads etc.)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the leaf/shape validation against a fresh "
                         "port model")
    args = ap.parse_args(argv)

    import torch

    from ..utils.checkpoint import save_checkpoint
    from ..utils.torch_import import convert_state_dict, load_raw_state_dict
    from ..utils.weights import flax_to_state_dict, reference_rules

    sd, meta = load_raw_state_dict(args.torch_ckpt)
    variables = convert_state_dict(args.model, sd, strict=not args.no_strict)
    rules = reference_rules(args.model, variables)
    state_dict = flax_to_state_dict(variables, rules)
    n_params = sum(int(np.prod(v.shape)) for v in _leaves(variables.get("params", {})))

    if not args.no_validate:
        from ..models import get_model
        from ..models.registry import MODEL_REGISTRY
        from ..utils.torch_import import validate_variables
        from ..utils.weights import state_dict_to_flax

        if args.model not in MODEL_REGISTRY:
            raise ValueError(f"cannot validate '{args.model}': not a registry model "
                             "(pass --no-validate)")
        kwargs = {"num_classes": args.num_classes}
        if "in_features" in inspect.signature(MODEL_REGISTRY[args.model]).parameters:
            kwargs["in_features"] = args.feature_dim
        if args.model == "ptv3":  # the checkpoint's depth
            kwargs["depth"] = sum(1 for k in variables["params"] if k.startswith("block"))
        model = get_model(args.model, generator=torch.Generator().manual_seed(0), **kwargs)
        validate_variables(variables, state_dict_to_flax(model.state_dict(), rules))
        model.load_state_dict(state_dict, strict=True)
        print(f"validated: tree matches a fresh {args.model} "
              f"(num_classes={args.num_classes}, "
              f"feature_dim={args.feature_dim})")

    os.makedirs(args.out, exist_ok=True)
    state = {"model": state_dict, "source_torch": os.path.abspath(args.torch_ckpt)}
    state.update({k: v for k, v in meta.items() if k not in state})
    save_checkpoint(os.path.join(args.out, args.tag), state)
    print(f"imported {args.torch_ckpt} -> {os.path.join(args.out, args.tag)} "
          f"({n_params:,} params"
          + (f", epoch={meta['epoch']}" if "epoch" in meta else "") + ")")


def _leaves(tree):
    if hasattr(tree, "items"):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


if __name__ == "__main__":
    main()
