"""Training driver of the PyTorch port, on a CUDA card (or, with
``--device cpu``, the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --device cpu --steps 5

Without ``--smoke`` it trains the published width. Every attention runs
through the flash op (``--impl kernel``: the CUDA kernels on a card, their
plain versions on the CPU) or its plain version under autograd (``--impl
ref``). Restart-safe: re-invoking with the same ``--ckpt-dir`` resumes from
the newest COMMITTED checkpoint.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="training device (default cuda; raises without one)")
    ap.add_argument("--impl", choices=["kernel", "ref"], default="kernel")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.device import resolve_device
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import (AdamWConfig, cosine_schedule,
                                                wsd_schedule)
    from repro_torch.training.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    sched = (wsd_schedule if args.schedule == "wsd" else cosine_schedule)(
        args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    dcfg = DataConfig(seed=args.seed, batch=args.batch, seq_len=args.seq)
    ocfg = AdamWConfig(lr=sched)
    tcfg = TrainConfig(steps=args.steps, micro_batches=args.micro_batches,
                       remat=args.remat, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, impl=args.impl)

    def on_step(step, stats):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(stats['loss']):.4f}  "
                  f"gnorm {float(stats['grad_norm']):.3f}  "
                  f"lr {float(stats['lr']):.2e}", flush=True)

    out = train(cfg, dcfg, ocfg, tcfg, seed=args.seed, device=device,
                hooks={"on_step": on_step})
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f}); "
          f"straggler flags: {out['straggler_flags']}")
    return out


if __name__ == "__main__":
    main()
