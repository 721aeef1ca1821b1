"""Train step with micro-batch gradient accumulation and remat, and the
fault-tolerant outer loop (checkpoint/restart, failure injection, straggler
monitor) — ``repro/training/train_loop.py``. With ``TrainConfig.shard_axes``
the step is one rank's of the partitioned train step (the reference jits
it under ``ShardingRules``' shardings in ``launch/dryrun.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import partition
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)


@dataclass
class TrainConfig:
    steps: int = 100
    micro_batches: int = 1
    remat: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    impl: str = "kernel"        # flash and WKV ops, or "ref" (plain twins)
    # the partitioned train step: the reference's {"dp", "tp", "mesh", "sp"}
    # plus "ctx", the rank's RankContext; None on one device
    shard_axes: Optional[dict] = None


def trainable_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, set to require gradients (the port
    builds them frozen for serving)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def make_train_step(mcfg: ModelConfig, ocfg: AdamWConfig, tcfg: TrainConfig):
    """Returns train_step(model, opt_state, batch) -> (model, opt, stats).
    With micro_batches > 1 the batch's leading dim is split and gradients
    are accumulated in float32, one micro-batch's graph alive at a time.
    The batch's tensors (tokens, a VLM's prefix embeddings) move to the
    model's device first. The model's parameters and the optimizer state
    are updated in place.

    With ``tcfg.shard_axes`` the model, optimizer state and batch are one
    rank's shards and rows (``partition.shard_model(requires_grad=True)``,
    ``adamw_init`` of its parameters, ``partition.shard_batch`` with
    ``micro_batches``: its block of each of the reference's micro-batches,
    in order, so its micro-batch m is its rows of the global one), each
    rank's gradients of its own loss are reduced to the shards of the
    mean loss's over the dp axes (``partition.reduce_gradients``), the
    clipping norm is the global one, and the reported loss and
    ``grad_norm`` are global: the loss the mean of the ranks' (a MoE's aux
    term averaged over the dp ranks' rows, as its gradient is)."""
    axes = tcfg.shard_axes
    rank = axes["ctx"] if axes else None

    def grads_of(model, params, mb):
        loss = api.loss_fn(model, mcfg, mb, remat=tcfg.remat, impl=tcfg.impl,
                           shard_axes=axes)
        gs = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, gs))

    def train_step(model, opt_state: AdamWState, batch):
        params = trainable_params(model)
        device = next(iter(params.values())).device
        batch = {k: v.to(device) for k, v in batch.items()}
        n = tcfg.micro_batches
        if n > 1:
            mbs = [{k: v.reshape(n, -1, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
            lsum = 0.0
            for mb in mbs:
                l, g = grads_of(model, params, mb)
                for k in gsum:
                    gsum[k] += g[k]
                lsum = lsum + l
            grads = {k: g.div_(n) for k, g in gsum.items()}
            loss = lsum / n
        else:
            loss, grads = grads_of(model, params, batch)
        specs = None
        if rank is not None:
            specs = partition.param_specs(model)
            grads = partition.reduce_gradients(grads, specs, rank, axes["dp"])
            loss = partition.dp_mean(loss, rank, axes["dp"])
        _, opt_state, stats = adamw_update(grads, opt_state, params, ocfg,
                                           specs=specs, rank=rank)
        return model, opt_state, dict(stats, loss=loss)

    return train_step


@dataclass
class StragglerMonitor:
    """Tracks per-step times; flags steps slower than k x the running
    median."""
    factor: float = 3.0
    window: int = 32
    times: list = field(default_factory=list)
    flags: int = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 8 and dt > self.factor * med
        self.flags += int(slow)
        return slow


def state_tree(model, opt: AdamWState) -> dict:
    """What a checkpoint holds: the params by ``state_dict`` name and the
    optimizer's step, moments and master."""
    return {"params": model.state_dict(),
            "opt": {"step": torch.tensor(opt.step), "mu": opt.mu,
                    "nu": opt.nu, "master": opt.master or {}}}


@torch.no_grad()
def load_state_tree(model, opt: AdamWState, tree: dict) -> AdamWState:
    """Copy a restored ``state_tree`` into the model and the optimizer's
    tensors, in place."""
    params = model.state_dict()
    for name, t in tree["params"].items():
        params[name].copy_(t)
    o = tree["opt"]
    for part, dst in (("mu", opt.mu), ("nu", opt.nu),
                      ("master", opt.master or {})):
        for name, t in o[part].items():
            dst[name].copy_(t)
    return AdamWState(int(o["step"]), opt.mu, opt.nu, opt.master)


def train(mcfg: ModelConfig, dcfg: DataConfig, ocfg: AdamWConfig,
          tcfg: TrainConfig, *, seed: int = 0, device=None,
          generator: Optional[torch.Generator] = None, model=None,
          fail_at: Optional[int] = None,
          hooks: Optional[Dict[str, Callable]] = None) -> Dict[str, Any]:
    """Fault-tolerant training driver.

    The model is ``init_params`` from ``generator`` (default: seeded with
    ``seed`` on ``device``, which is CUDA unless the caller asks for
    another), or ``model`` when given (trained in place). Restart semantics:
    on entry, if ckpt_dir holds a COMMITTED checkpoint we resume from it
    (params + opt + step); the deterministic data pipeline replays from the
    restored step. ``fail_at`` injects a crash for the restart tests.
    """
    hooks = hooks or {}
    if model is None:
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        model = api.init_params(mcfg, generator, device)
    opt_state = adamw_init(trainable_params(model), ocfg)
    start = 0
    saver = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir, tcfg.keep)
             if tcfg.ckpt_dir else None)

    if tcfg.ckpt_dir and (last := ckpt.latest_step(tcfg.ckpt_dir)) is not None:
        state = ckpt.restore(state_tree(model, opt_state), tcfg.ckpt_dir, last)
        opt_state = load_state_tree(model, opt_state, state)
        start = last

    step_fn = make_train_step(mcfg, ocfg, tcfg)
    monitor = StragglerMonitor()
    losses = []
    for step in range(start, tcfg.steps):
        if fail_at is not None and step == fail_at:
            if saver:
                saver.wait()
            raise RuntimeError(f"injected node failure at step {step}")
        batch = make_batch(dcfg, mcfg, step)
        t0 = time.monotonic()
        model, opt_state, stats = step_fn(model, opt_state, batch)
        loss = float(stats["loss"])          # waits for the step's work
        monitor.observe(time.monotonic() - t0)
        losses.append(loss)
        if "on_step" in hooks:
            hooks["on_step"](step, stats)
        if saver and (step + 1) % tcfg.ckpt_every == 0:
            saver.save(state_tree(model, opt_state), step + 1)
    if saver:
        saver.wait()
    return {"params": model, "opt": opt_state, "losses": losses,
            "straggler_flags": monitor.flags, "step_times": monitor.times}
