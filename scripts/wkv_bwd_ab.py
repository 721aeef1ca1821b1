"""A/B of the WKV backward between checkouts, on one NVIDIA GPU: for each
ROOT in turn, in a process of its own, that checkout's ``src/repro_torch``
builds its kernels, then, for the square WKV (``wkv6_bwd``,
``csrc/wkv6_bwd.cu``),

- one ``wkv6_bwd`` call at rwkv6-3b's training shape (4, 2048, 40, 64),
  bf16, strong decay, is timed by CUDA events behind a device-side wait
  (``chip_smoke.device_ms``, 10 calls), beside its bound;
- ``chip_smoke.py``'s phase 64 runs: rwkv6-3b at full depth, 4 x 2048,
  remat, 10 steps (step p50, tokens/s, peak memory, launches per step),
  then one profiled step;

or, with ``--keyslice``, for the key-slice WKV (``wkv6_keyslice`` and
``wkv6_keyslice_bwd``, ``csrc/wkv6_keyslice*.cu``),

- the backward and the forward at the ``pod256`` rank's rwkv6-3b
  ``train_4k`` micro-batch (4, 4,096, 40 heads, K 4 of V 64) and the
  forward at its ``prefill_32k`` rows (2, 32,768, ...), bf16, strong
  decay, are timed the same way (5 calls);
- ``chip_smoke.py``'s rwkv6-3b ``train_4k`` cell runs (phase 84(b): rank 0
  of ``pod256`` at 8 layers under a fake group), one warm-up and three
  timed runs: its p50 and each run.

The timing and the phases are this checkout's ``chip_smoke.py``; only the
package they drive comes from ROOT.

    python3 scripts/wkv_bwd_ab.py [--keyslice] PARENT CHANGE CHANGE PARENT

Give the roots in turns (parent, change, change, parent) to compare on one
card. Exits non-zero without a GPU or if any run fails.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def square(torch, np, cs, card, dev, root):
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    cfg = get_config("rwkv6-3b").replace(n_layers=cs.RWKV_TRAIN_LAYERS)
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    B, T = cs.WKV_TRAIN_SHAPES["train"]
    g = torch.Generator(device=dev).manual_seed(12)
    args = cs.wkv_bwd_inputs(torch, g, B, T, H, hd, max(cs.WKV_DECAYS),
                             torch.bfloat16, dev)
    ms = cs.device_ms(lambda: wkv_ops.wkv6_bwd(*args), 10)
    bound, by, _ = cs.wkv_bwd_bound(B, T, H, hd, 2)
    del args
    label = "rwkv6-3b train"
    cs.phase_train_run(torch, np, cfg, dev, remat=True, label=label, seed=6)
    print("wkv backward A/B: " + json.dumps(dict(
        root=str(root), card=card,
        shape=f"B={B} T={T} H={H} hd={hd} bfloat16", ms=ms, bound_ms=bound,
        bound_by=by, share_of_bound=bound / ms,
        train=cs.TRAIN_RUNS[label])))


def keyslice(torch, np, cs, card, dev, root):
    from repro_torch.distributed import partition
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.launch.mesh import make_placeholder_mesh
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(12)
    ms = {}
    for name, shape in (("train", cs.TRAIN_PARTITION_WKV["train"][0]),
                        ("prefill", cs.PARTITION_WKV["prefill"])):
        B, T, H, K, V = shape
        fwd = cs.keyslice_inputs(torch, g, shape, max(cs.WKV_DECAYS), dev)
        ms[f"forward {name}"] = cs.device_ms(
            lambda: wkv_ops.wkv6_keyslice(*fwd), 5)
        if name == "train":
            dy = torch.randn((B, T, H, V), generator=g,
                             device=dev).to(fwd[0].dtype)
            ds = torch.randn((B, H, K, V), generator=g, device=dev)
            ms["backward train"] = cs.device_ms(
                lambda: wkv_ops.wkv6_keyslice_bwd(*fwd, dy, ds), 5)
            del dy, ds
        del fwd
        cs.release(torch)
    with partition.fake_world(int(make_placeholder_mesh(
            cs.PARTITION_MESH).devices.size)):
        row, _ = cs.partition_cell(torch, np, "rwkv6-3b", "train_4k",
                                   cs.RWKV_CELL_LAYERS, card, 1, 3)
    print("wkv key-slice A/B: " + json.dumps(dict(
        root=str(root), card=card, ms=ms, cell_p50_ms=row["p50_ms"],
        cell_runs_ms=row["ms"])))


def one(root: Path) -> int:
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("wkv backward A/B needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"== {root}")
    card = cs.phase_device(torch)
    cs.phase_build()
    run = keyslice if "--keyslice" in sys.argv else square
    run(torch, np, cs, card, torch.device("cuda"), root)
    return 0


def main() -> int:
    from engine_ab import in_turns
    return in_turns(__file__, one, __doc__)


if __name__ == "__main__":
    sys.exit(main())
