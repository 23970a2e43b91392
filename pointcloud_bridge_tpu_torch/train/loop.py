"""Training engine of the port, single device (counterpart of
pointcloud_bridge_tpu/train/loop.py on its single-device branch).

Mirrors the reference trainer: timestamped experiment dir, logger and
scalar writer, code snapshot, Adam(wd=1e-4) with L2 in the gradient,
lr schedulers with warmup, optional EMA of the weights, class weights from
the label histogram, per-epoch validation with the metric suite, and
best/latest checkpoints. Metrics stay on the device during an epoch and are
fetched once at its end. The model computes in full float32: TF32 is turned
off on CUDA.

Not ported yet (ROADMAP.md): a device mesh (``parallel``), gradient
accumulation (``accum_steps``) and multi-step dispatch
(``steps_per_dispatch``); each raises NotImplementedError.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import losses as L
from ..config import Config
from ..models import Dropout, get_model
from ..utils import metrics as M
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import ScalarWriter, initialize_logger, snapshot_code
from .schedules import ReduceLROnPlateau, cosine_lr, step_decay_lr


def make_optimizer(params, weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam(betas=(0.9, 0.999), eps=1e-8) with the weight decay added to the
    gradient before the moments (L2, not AdamW): the JAX package's
    ``optax.chain(add_decayed_weights(wd), scale_by_adam())``. The lr is set
    by each train step."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def loss_fn_for(loss_cfg) -> Callable:
    """loss(logits, labels, xyz, class_weights) -> scalar, as the config
    names it (loop.py:131-153)."""
    name = loss_cfg.name

    def fn(logits, labels, xyz, class_weights):
        if name in ("ce", "weighted_ce"):
            cw = class_weights if loss_cfg.use_class_weights else None
            return L.weighted_cross_entropy(logits, labels, cw, loss_cfg.label_smoothing)
        if name == "bridge_structure":
            return L.bridge_structure_loss(
                logits, labels, xyz, alpha=loss_cfg.alpha, rel_margin=loss_cfg.rel_margin
            )
        if name == "sol":
            return L.sol_loss(logits, labels, xyz)
        raise ValueError(f"unknown loss '{name}'")

    return fn


def make_train_step(model: torch.nn.Module, loss_cfg, optimizer) -> Callable:
    """step(batch, lr, class_weights) -> {"loss", "acc"} as device tensors.

    One forward in train mode (BatchNorm batch statistics, running stats
    updated, dropout on), one backward, one optimizer step at ``lr``. The
    gradients stay in each parameter's ``.grad`` until the next step.
    """
    loss_fn = loss_fn_for(loss_cfg)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = lr
        xyz, labels = batch["points"], batch["labels"]
        logits = model(xyz, batch["colors"])
        loss = loss_fn(logits, labels, xyz, class_weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return step


def make_eval_step(model: torch.nn.Module, num_classes: int) -> Callable:
    """step(batch, class_weights, params=None) -> (confusion [C, C], loss).

    Eval mode; only the rows that ``batch["mask"]`` marks count in the
    confusion matrix. ``params`` (name -> tensor) replaces the model's
    parameters for this call, as the EMA weights do in validation."""

    def step(batch, class_weights, params: Optional[Dict[str, torch.Tensor]] = None):
        model.eval()
        xyz, labels = batch["points"], batch["labels"]
        with torch.inference_mode():
            if params is None:
                logits = model(xyz, batch["colors"])
            else:
                logits = torch.func.functional_call(model, params, (xyz, batch["colors"]))
            loss = L.weighted_cross_entropy(logits, labels, class_weights)
            mask = batch["mask"][:, None].expand(labels.shape)
            cm = M.masked_confusion_matrix(logits.argmax(-1), labels, mask, num_classes)
        return cm, loss

    return step


def prefetch_to_device(batch_iter, put: Callable, size: int = 2):
    """Double-buffered input feed: a daemon thread converts and copies
    batches N+1..N+size while step N runs (loop.py:74-109). size <= 1
    feeds synchronously. An exception in the thread re-raises here."""
    if size <= 1:
        for b in batch_iter:
            yield put(b)
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()

    def worker():
        try:
            for b in batch_iter:
                q.put(put(b))
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            q.put(("__prefetch_error__", e))
        q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
            raise item[1]
        yield item


def resolve_device(name: str) -> torch.device:
    """"auto" and "cuda" mean the first CUDA device, which must exist;
    "cpu" is for tests. A missing card is an error, never a silent CPU run."""
    if name == "auto":
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{name}': no CUDA device (torch.cuda.is_available() is False)"
        )
    return dev


def _check_single_device(config: Config) -> None:
    tcfg, ndev = config.train, config.parallel.num_devices
    n_avail = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if ndev > 1 or (ndev == -1 and n_avail > 1):
        raise NotImplementedError(
            f"parallel.mode '{config.parallel.mode}' over {ndev} devices is not "
            "ported yet; ROADMAP.md Queue 1, \"Parallel layer\""
        )
    # the ROADMAP.md Queue 1 item that holds each knob, by its title
    for knob, item in (("accum_steps", "ptv3_moe and the PTv3 options"),
                       ("steps_per_dispatch", "Engine options")):
        if int(getattr(tcfg, knob, 1)) > 1:
            raise NotImplementedError(
                f"train.{knob} > 1 is not ported yet; ROADMAP.md Queue 1, \"{item}\""
            )


def train(
    config: Config,
    train_ds,
    val_ds=None,
    exp_dir: Optional[str] = None,
    model: Optional[torch.nn.Module] = None,
    resume: bool = False,
) -> Dict[str, Any]:
    """Full training run on ``config.device`` ("auto" = CUDA). Returns
    {history, state, best_val_acc, exp_dir, model, class_weights};
    ``state`` holds the model's and the optimizer's state_dicts and the
    last epoch.

    resume=True continues from ``exp_dir/latest_checkpoint``, or else warm
    starts from ``exp_dir/best_model``; the epoch counter continues from the
    stored epoch. A weights-only checkpoint (no ``optimizer``) is a warm
    start with a fresh optimizer from epoch 1 (loop.py:476-526).
    """
    tcfg, mcfg = config.train, config.model
    _check_single_device(config)
    device = resolve_device(config.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if exp_dir is None:
        ts = time.strftime("%m%d%H%M")
        exp_dir = os.path.join(config.exp_dir_root, f"exp_{ts}_{config.case}")
    os.makedirs(exp_dir, exist_ok=True)
    logger = initialize_logger(exp_dir)
    writer = ScalarWriter(exp_dir)
    snapshot_code(exp_dir)

    if model is None:
        gen = torch.Generator().manual_seed(tcfg.seed)
        model = get_model(mcfg.name, mcfg.num_classes, generator=gen, **mcfg.extra)
    model.to(device)
    dropout_gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = dropout_gen
    optimizer = make_optimizer(model.parameters(), tcfg.weight_decay)

    start_epoch = 1
    if resume:
        ckpt_path = os.path.join(exp_dir, "latest_checkpoint")
        if not os.path.exists(ckpt_path):
            ckpt_path = os.path.join(exp_dir, "best_model")
        if os.path.exists(ckpt_path):
            # decided by the stored keys, never by a failed restore: a real
            # mismatch raises (strict load, optimizer groups)
            ckpt = restore_checkpoint(ckpt_path, map_location=device)
            model.load_state_dict(ckpt["model"], strict=True)
            if "optimizer" in ckpt:
                optimizer.load_state_dict(ckpt["optimizer"])
                start_epoch = int(ckpt.get("epoch", 0)) + 1
                logger.info(f"resumed from {ckpt_path} at epoch {start_epoch}")
            else:
                logger.info(
                    f"warm start from {ckpt_path} (weights only; fresh optimizer state)"
                )

    params = dict(model.named_parameters())
    ema = None
    if getattr(tcfg, "ema_decay", 0.0) > 0.0:
        d = float(tcfg.ema_decay)
        ema = {k: p.detach().clone() for k, p in params.items()}
        ema_path = os.path.join(exp_dir, "latest_ema")
        if start_epoch > 1 and os.path.exists(ema_path):
            stored = restore_checkpoint(ema_path, map_location=device)["model"]
            ema = {k: stored[k].clone() for k in ema}
            logger.info("resumed EMA params")
    n_params = sum(p.numel() for p in params.values())
    logger.info(
        f"model={mcfg.name} params={n_params:,} classes={mcfg.num_classes} "
        f"blocks={len(train_ds)} batch={tcfg.batch_size} device={device}"
    )

    counts = train_ds.label_counts(mcfg.num_classes)
    class_weights = L.class_weights_from_counts(counts).to(device)
    logger.info(f"class weights: {class_weights.cpu().numpy()}")

    train_step = make_train_step(model, config.loss, optimizer)
    eval_step = make_eval_step(model, mcfg.num_classes)

    def put_batch(b):
        out = {
            "points": torch.from_numpy(np.ascontiguousarray(b["points"], np.float32)),
            "colors": torch.from_numpy(np.ascontiguousarray(b["colors"], np.float32)),
            "labels": torch.from_numpy(np.asarray(b["labels"], np.int64)),
            "mask": torch.from_numpy(np.asarray(b["mask"], bool)),
        }
        return {k: v.to(device) for k, v in out.items()}

    plateau = ReduceLROnPlateau(
        lr=tcfg.learning_rate, factor=tcfg.plateau_factor,
        patience=tcfg.plateau_patience, min_lr=tcfg.min_lr,
    )
    lr = tcfg.learning_rate
    best_val_acc = -1.0
    history = []
    epoch = start_epoch - 1

    for epoch in range(start_epoch, tcfg.num_epochs + 1):
        if tcfg.scheduler == "cosine":
            lr = cosine_lr(tcfg.learning_rate, epoch - 1, tcfg.num_epochs)
        elif tcfg.scheduler == "step":
            lr = step_decay_lr(
                tcfg.learning_rate, epoch - 1, tcfg.step_decay, tcfg.step_every, tcfg.min_lr
            )
        # warmup scales whatever the scheduler chose; lr itself stays, so the
        # plateau state does not compound the factor across epochs
        eff_lr = lr
        wu = getattr(tcfg, "warmup_epochs", 0)
        if wu > 0 and epoch <= wu:
            eff_lr = lr * epoch / wu

        t0 = time.time()
        step_metrics = []
        batch_iter = train_ds.batches(tcfg.batch_size, shuffle=True, seed=tcfg.seed, epoch=epoch)
        for batch in prefetch_to_device(batch_iter, put_batch, tcfg.prefetch):
            step_metrics.append(train_step(batch, eff_lr, class_weights))
            if ema is not None:
                with torch.no_grad():
                    keys = list(ema)
                    torch._foreach_mul_([ema[k] for k in keys], d)
                    torch._foreach_add_([ema[k] for k in keys],
                                        [params[k].detach() for k in keys], alpha=1.0 - d)
        if step_metrics:
            fetched = torch.stack(
                [torch.stack([m["loss"], m["acc"]]) for m in step_metrics]
            ).cpu().numpy()  # one fetch per epoch
            tr_loss, tr_acc = (float(v) for v in fetched.mean(0))
        else:
            tr_loss = tr_acc = 0.0
        row = {
            "epoch": epoch,
            "lr": eff_lr,
            "train_loss": tr_loss,
            "train_acc": tr_acc,
            "epoch_time_s": time.time() - t0,
        }

        # validate (and keep the best) with the deployed weights: the EMA
        # weights when enabled
        if val_ds is not None and len(val_ds) > 0:
            cms, losses = [], []
            val_iter = val_ds.batches(tcfg.batch_size, shuffle=False, drop_last=False)
            for batch in prefetch_to_device(val_iter, put_batch, tcfg.prefetch):
                cm, loss = eval_step(batch, class_weights, ema)
                cms.append(cm)
                losses.append(loss)
            vb = len(losses)
            if vb:
                cm_total = torch.stack(cms).sum(0).cpu().numpy()
                val_loss = float(torch.stack(losses).sum().cpu())
            else:
                cm_total = np.zeros((mcfg.num_classes, mcfg.num_classes))
                val_loss = 0.0
            mets = M.metrics_from_confusion(cm_total)
            val_acc = mets["OA"]
            row.update(val_loss=val_loss / max(vb, 1), val_acc=val_acc,
                       val_miou=mets["mIoU"], val_macc=mets["mAcc"])
            for c, a in enumerate(mets["Acc_per_class"]):
                row[f"class_{c}_acc"] = float(a)
            if tcfg.scheduler == "plateau":
                lr = plateau.step(val_acc)
            if val_acc > best_val_acc:
                best_val_acc = val_acc
                best = model.state_dict()
                if ema is not None:
                    best = {**best, **ema}
                save_checkpoint(
                    os.path.join(exp_dir, "best_model"),
                    {"model": best, "optimizer": optimizer.state_dict(),
                     "epoch": epoch, "val_acc": float(val_acc)},
                )

        save_checkpoint(
            os.path.join(exp_dir, "latest_checkpoint"),
            {"model": model.state_dict(), "optimizer": optimizer.state_dict(), "epoch": epoch},
        )
        if ema is not None:  # raw weights above, EMA beside: exact resume
            save_checkpoint(os.path.join(exp_dir, "latest_ema"), {"model": ema})
        history.append(row)
        writer.write(epoch, {k: v for k, v in row.items() if k != "epoch"})
        logger.info(" ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()
        ))

    writer.close()
    return {
        "history": history,
        "state": {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                  "epoch": epoch},
        "best_val_acc": best_val_acc,
        "exp_dir": exp_dir,
        "model": model,
        "class_weights": class_weights,
    }
