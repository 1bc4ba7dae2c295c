"""Training CLI: the epoch / phase loop around `SmirkSystem.train_step`
(port of smirk_tpu/cli/train.py).

Usage (mirrors the reference train.py):
  python -m smirk_tpu_torch.cli.train configs/config_train.yaml train.lr=1e-4 ...
Extra flags: --synthetic (the procedural zero-data pipeline), --device cpu
(the plain PyTorch versions on the CPU; without it the run is on the card).

One process drives one device: loader -> train_step -> log / viz /
checkpoint. The optimizer state persists across epochs (the cosine restarts
are in the schedules), unlike the reference's per-epoch reconfigure.

Files (`train.log_path`): config.json, metrics.jsonl, the full training
state `last_state.pt` (every `train.ckpt_every_steps` steps and at every
epoch end; `resume_state=` continues from it exactly), the model export
`model_{epoch}.pt` every `train.save_every` epochs (`resume=` and
`Predictor(checkpoint=)` read it), and `{train,val}_images/*.jpg` every
`train.visualize_every` batches (0 disables them).

Recovery: SMIRK_FAULT_INJECT_STEP=N raises after the N-th step (negative:
before the first step of this run). On any crash the last completed step's
state is saved to last_state.pt, atomically; when no step completed in this
run, or the crash hit inside a step (whose modules and optimizers may be
half updated; the JAX package's functional state has no such case), the
previous checkpoint is left as it was.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

import numpy as np

_TEMPLATE_CLASSES = {
    "lips_back", "rolling_lips", "mouth_side", "kissing", "high_smile",
    "mouth_up", "mouth_middle", "mouth_down", "blow_cheeks", "cheeks_in",
    "jaw", "lips_up",
}


def _parse(argv):
    """-> (config path or None, overrides, synthetic, device or None)."""
    argv = list(argv)
    synthetic = "--synthetic" in argv
    if synthetic:
        argv.remove("--synthetic")
    device = None
    for i, a in enumerate(argv):
        if a == "--device":
            if i + 1 == len(argv):
                raise SystemExit("--device needs a value (cpu, cuda, cuda:N)")
            device = argv[i + 1]
            del argv[i:i + 2]
            break
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            del argv[i]
            break
    cfg_path = argv[0] if argv and "=" not in argv[0] else None
    overrides = tuple(a for a in argv[1 if cfg_path else 0:] if "=" in a)
    return cfg_path, overrides, synthetic, device


def _refuse_teacher(name: str, weight: float, path) -> None:
    """A teacher whose file is absent is None, its loss 0, as in the JAX
    package; the teachers' architectures are not ported yet, so a present
    file raises rather than being ignored."""
    if weight > 0 and path and os.path.isfile(path):
        raise NotImplementedError(
            f"the {name} teacher ({path}) is not ported; move the file away or set "
            f"its loss weight to 0")


def main(argv=None):
    cfg_path, overrides, synthetic, device = _parse(sys.argv[1:] if argv is None else argv)

    from smirk_tpu_torch import assets
    from smirk_tpu_torch.config import load_config
    from smirk_tpu_torch.data.pipeline import load_dataloaders
    from smirk_tpu_torch.device import resolve_device
    from smirk_tpu_torch.train.trainer import SmirkSystem
    from smirk_tpu_torch.utils import checkpoint as ckpt
    from smirk_tpu_torch.utils import weights
    from smirk_tpu_torch.utils.metrics import MetricLogger

    config = load_config(cfg_path, overrides)
    device = resolve_device(device)
    log_path = config.train.log_path
    os.makedirs(os.path.join(log_path, "train_images"), exist_ok=True)
    os.makedirs(os.path.join(log_path, "val_images"), exist_ok=True)
    _save_config_snapshot(config, log_path)  # reference train.py:31

    train_loader, val_loader = load_dataloaders(
        config, synthetic=synthetic, pin_memory=device.type == "cuda")
    steps_per_epoch = len(train_loader)

    w = config.train.loss_weights
    _refuse_teacher("VGG", w.perceptual_vgg_loss, os.environ.get("SMIRK_VGG16"))
    _refuse_teacher("EMOCA emotion", w.emotion_loss, os.environ.get(
        "SMIRK_EMOTION", "assets/ResNet50/emotion_checkpoint.ckpt"))
    _refuse_teacher("MICA", w.mica_loss, os.environ.get("SMIRK_MICA", "assets/mica.tar"))
    system = SmirkSystem(config, assets.load_all(), device=device,
                         steps_per_epoch=steps_per_epoch,
                         templates=_load_templates(config))
    a = config.arch
    if a.backbone_init_small or a.backbone_init_large:
        # ImageNet-pretrained backbones from raw timm state dicts (reference
        # smirk_encoder.py:7-12 pretrained=True); resume below overrides
        weights.init_backbones_from_state_dicts(
            system.encoder,
            weights.load_raw_state_dict(a.backbone_init_small) if a.backbone_init_small else None,
            weights.load_raw_state_dict(a.backbone_init_large) if a.backbone_init_large else None)
        system.base_encoder.load_state_dict(system.encoder.state_dict())
        print("[init] backbones initialized from timm state dicts")
    if config.resume:
        ckpt.load_model(system, config.resume)
        # refresh the frozen base copy after loading (reference train.py:43)
        system.base_encoder.load_state_dict(system.encoder.state_dict())
    start_epoch = config.train.resume_epoch
    if config.resume_state:
        # exact restart-based recovery: modules, BN statistics, optimizer
        # moments and the step; the interrupted epoch's steps past the
        # checkpoint replay (data is sampled with replacement, the
        # schedules and the step's draws key off the step)
        ckpt.restore_state(system, config.resume_state)
        start_epoch = system.step // max(1, steps_per_epoch)
        print(f"[resume] {config.resume_state} step={system.step} -> epoch {start_epoch}")

    logger = MetricLogger(log_path, config.train.log_losses_every)
    last_state_path = os.path.join(log_path, "last_state.pt")
    # fault injection for the restart-recovery tests: raise after the
    # cumulative step counter reaches N (fires once: a resumed run starts
    # past it); negative: raise before the first step of this run
    fault_at = int(os.environ.get("SMIRK_FAULT_INJECT_STEP", "0"))
    run = {"steps": 0, "in_step": False}
    try:
        _run_epochs(config, system, train_loader, val_loader, logger, log_path,
                    start_epoch, fault_at, last_state_path, run)
    except Exception:
        try:
            if run["steps"] == 0:
                # an empty save would clobber the previous checkpoint
                print("[crash] no completed step to salvage", file=sys.stderr)
            elif run["in_step"]:
                print("[crash] the fault hit inside a step: its state is torn; the "
                      "previous checkpoint stands", file=sys.stderr)
            else:
                ckpt.save_state(system, last_state_path)
                print(f"[crash] salvaged {last_state_path} at step {system.step}",
                      file=sys.stderr)
        except Exception as salvage_err:  # noqa: BLE001 -- report, then re-raise the crash
            print(f"[crash] state not salvageable: {salvage_err}", file=sys.stderr)
        print("[crash] recovery: relaunch with "
              f"resume_state={last_state_path} (tools/train_supervisor.py)",
              file=sys.stderr)
        raise
    finally:
        logger.close()


def _run_epochs(config, system, train_loader, val_loader, logger, log_path,
                start_epoch, fault_at, last_state_path, run):
    import torch

    from smirk_tpu_torch.utils import checkpoint as ckpt
    from smirk_tpu_torch.utils import viz

    ckpt_every = config.train.ckpt_every_steps
    for epoch in range(start_epoch, config.train.num_epochs):
        for phase, loader in (("train", train_loader), ("val", val_loader)):
            if loader is None:
                continue
            for batch_idx, batch in enumerate(loader):
                if phase == "train":
                    if fault_at < 0:
                        raise RuntimeError("SMIRK_FAULT_INJECT_STEP<0: pre-step fault")
                    run["in_step"] = True
                    metrics, aux = system.train_step(batch, parity=batch_idx)
                    run["in_step"] = False
                    run["steps"] += 1
                    if ckpt_every and system.step % ckpt_every == 0:
                        ckpt.save_state(system, last_state_path)
                    if fault_at and system.step == fault_at:
                        raise RuntimeError(f"SMIRK_FAULT_INJECT_STEP={fault_at}")
                else:
                    # a generator per batch: the step counter is frozen in
                    # validation, and one seed would evaluate every batch
                    # under one mask-sampling draw
                    gen = torch.Generator(device=system.device).manual_seed(batch_idx)
                    metrics, aux = system.eval_step(batch, gen)
                logger.log(batch_idx, metrics, phase, epoch=epoch, global_step=system.step)
                if (config.train.visualize_every > 0
                        and batch_idx % config.train.visualize_every == 0):
                    extra = system.make_visualizations(batch, aux)
                    grid = viz.training_grid(
                        {k: np.asarray(v) for k, v in batch.items()},
                        {k: None if v is None else v.detach().cpu().numpy()
                         for k, v in extra.items()},
                        show_landmarks=True)
                    viz.save_image(grid, os.path.join(
                        log_path, f"{phase}_images/{epoch}_{batch_idx}.jpg"))
        # the resumable full state at EVERY epoch end (a recovery must never
        # resume from a stale epoch); save_every gates only the model exports
        ckpt.save_state(system, last_state_path)
        if epoch % config.train.save_every == 0:
            ckpt.save_model(system, os.path.join(log_path, f"model_{epoch}.pt"))


def _save_config_snapshot(config, log_path):
    with open(os.path.join(log_path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)


def _load_templates(config):
    """FaMoS expression templates (utils/utils.py:5-25); None if absent."""
    root = os.environ.get("SMIRK_TEMPLATES", "assets/expression_templates_famos")
    if not os.path.isdir(root):
        return None
    rows = []
    for npy in glob.glob(os.path.join(root, "*", "*", "*.npy")):
        if os.path.basename(os.path.dirname(npy)) not in _TEMPLATE_CLASSES:
            continue
        params = np.load(npy, allow_pickle=True).item()
        rows.append(np.asarray(params["expression"]).squeeze())
    return np.stack(rows) if rows else None


if __name__ == "__main__":
    main()
