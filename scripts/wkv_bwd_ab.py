"""A/B of the WKV backward (``wkv6_bwd``, ``csrc/wkv6_bwd.cu``) between
checkouts, on one NVIDIA GPU: for each ROOT in turn, in a process of its
own, that checkout's ``src/repro_torch`` builds its kernels, then

- one ``wkv6_bwd`` call at rwkv6-3b's training shape (4, 2048, 40, 64),
  bf16, strong decay, is timed by CUDA events behind a device-side wait
  (``chip_smoke.device_ms``, 10 calls), beside its bound;
- ``chip_smoke.py``'s phase 64 runs: rwkv6-3b at full depth, 4 x 2048,
  remat, 10 steps (step p50, tokens/s, peak memory, launches per step),
  then one profiled step.

The timing and the phases are this checkout's ``chip_smoke.py``; only the
package they drive comes from ROOT.

    python3 scripts/wkv_bwd_ab.py PARENT CHANGE CHANGE PARENT

Give the roots in turns (parent, change, change, parent) to compare on one
card. Exits non-zero without a GPU or if any run fails.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def one(root: Path) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        return chip_smoke.fail("wkv backward A/B needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"== {root}")
    card = chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    cfg = get_config("rwkv6-3b").replace(
        n_layers=chip_smoke.RWKV_TRAIN_LAYERS)
    dev = torch.device("cuda")
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    B, T = chip_smoke.WKV_TRAIN_SHAPES["train"]
    g = torch.Generator(device=dev).manual_seed(12)
    args = chip_smoke.wkv_bwd_inputs(torch, g, B, T, H, hd,
                                     max(chip_smoke.WKV_DECAYS),
                                     torch.bfloat16, dev)
    ms = chip_smoke.device_ms(lambda: wkv_ops.wkv6_bwd(*args), 10)
    bound, by, _ = chip_smoke.wkv_bwd_bound(B, T, H, hd, 2)
    del args
    label = "rwkv6-3b train"
    chip_smoke.phase_train_run(torch, np, cfg, dev, remat=True, label=label,
                               seed=6)
    print("wkv backward A/B: " + json.dumps(dict(
        root=str(root), card=card,
        shape=f"B={B} T={T} H={H} hd={hd} bfloat16", ms=ms, bound_ms=bound,
        bound_by=by, share_of_bound=bound / ms,
        train=chip_smoke.TRAIN_RUNS[label])))
    return 0


def main() -> int:
    from engine_ab import in_turns
    return in_turns(__file__, one, __doc__)


if __name__ == "__main__":
    sys.exit(main())
