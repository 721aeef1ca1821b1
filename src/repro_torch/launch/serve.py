"""Serving driver of the PyTorch port: host a model with FCFS or CFS+AQUA
scheduling on a CUDA card (or, with ``--device cpu``, the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke --scheduler cfs --offload fabric --requests 8 --device cpu

``--arch`` is ``qwen1.5-0.5b`` (the ``kv`` token plane) or ``rwkv6-3b``
(the ``wkv`` and ``shift`` state planes).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheduler", choices=["fcfs", "cfs"], default="cfs")
    ap.add_argument("--offload", choices=["fabric", "host"], default="fabric")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-running", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--slice-tokens", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="serving device (default cuda; raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.aqua_tensor import HOST, REMOTE
    from repro_torch.core.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device)
    eng = ServingEngine(cfg, params, max_running=args.max_running,
                        max_seq=96, scheduler=args.scheduler,
                        slice_tokens=args.slice_tokens,
                        offload_tier=REMOTE if args.offload == "fabric"
                        else HOST, device=device)
    eng.pager.add_remote_lease("donor0", 512 * 2048 * 4)
    print(f"runtime: unified paged state on {device} "
          f"(planes: {', '.join(eng.kv.planes)})")
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(list(map(int, rng.integers(0, cfg.vocab_size, 8))),
                   args.max_new_tokens, arrival=0.1 * i)
    m = eng.run(2000)
    print(f"served {len(eng.finished)} requests in {m.steps} engine steps "
          f"({m.sim_time:.2f} simulated s)")
    print(f"prefills={m.prefills} preemptions={m.preemptions} "
          f"restores={m.restores}")
    print("AQUA pager:", eng.pager.stats())


if __name__ == "__main__":
    main()
