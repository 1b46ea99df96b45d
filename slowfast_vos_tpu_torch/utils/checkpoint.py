"""Checkpoint save/restore with `torch.save`.

Covers the reference's checkpointing surface (`code/train.py:112-121`): best
model, last model, and a resumable {epoch, optimizer} checkpoint. The JAX
package writes orbax pytrees; the port writes one `torch.save` file of plain
tensors and dicts that `torch.load(..., weights_only=True)` reads:

  model:      the model's state dict (torchvision key names)
  optimizer:  the optimizer's state dict (SGD momentum buffers), when saved
              from a `Trainer`
  scheduler:  the learning-rate scheduler's state dict, when it has one
  calls:      the trainer's call counter (the `accumulate` phase)
  meta:       a JSON-able dict (epoch, J&F, ...)

Loading maps every tensor to the CPU; restoring puts each back bit for bit,
on the devices of the target.
"""
from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, target, meta: dict | None = None) -> None:
    """Save a `Trainer` (model, optimizer, scheduler, call counter) or an
    `nn.Module` (its state dict) with `meta` to `path`. The file is written
    beside `path` and renamed over it, so a reader never sees half of it."""
    if isinstance(target, torch.nn.Module):
        payload = {"model": target.state_dict()}
    else:
        payload = {
            "model": target.model.state_dict(),
            "optimizer": target.optimizer.state_dict(),
            "calls": int(target.calls),
        }
        if target.scheduler is not None:
            payload["scheduler"] = target.scheduler.state_dict()
    payload["meta"] = dict(meta or {})
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """The saved payload, tensors on the CPU (`weights_only=True`)."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, target) -> dict:
    """Load `path` into `target` in place (a `Trainer`: model, optimizer,
    scheduler and call counter; an `nn.Module`: its weights) and return the
    saved `meta`. A Trainer restores only from a Trainer's checkpoint."""
    payload = load_checkpoint(path)
    model = target if isinstance(target, torch.nn.Module) else target.model
    model.load_state_dict(payload["model"], strict=True)
    if not isinstance(target, torch.nn.Module):
        if "optimizer" not in payload:
            raise ValueError(f"{path} holds model weights only; a Trainer needs a Trainer checkpoint")
        target.optimizer.load_state_dict(payload["optimizer"])
        target.calls = int(payload["calls"])
        if target.scheduler is not None:
            target.scheduler.load_state_dict(payload["scheduler"])
    return payload["meta"]
