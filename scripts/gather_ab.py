"""A/B of the page gather (row 6, ``gather_pages``) between checkouts, on one
NVIDIA GPU: for each ROOT in turn, in a process of its own, that checkout's
``src/repro_torch`` builds its kernels and ``chip_smoke.py``'s row-6 timing
runs on it: the engine's three leg shapes (a qwen1.5-0.5b park of 1200
64 KiB kv pages; one rwkv6-3b request's 32 wkv pages of 655,360 B and 32
shift pages of 10,240 B), cold, each beside ``index_select``. The timing is
this checkout's ``chip_smoke.py``; only the package it drives comes from
ROOT.

    python3 scripts/gather_ab.py PARENT CHANGE CHANGE PARENT

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
        return chip_smoke.fail("gather A/B needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_gather import ops as kv_ops
    from repro_torch.kernels.kv_gather import ref as kv_ref
    print(f"== {root}")
    chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    legs = chip_smoke.gather_legs(
        torch, np, kv_ops, kv_ref, get_config("qwen1.5-0.5b"),
        get_config("rwkv6-3b"), torch.device("cuda"))
    for leg, case in legs.items():
        v = case["vs_library"]
        print(f"gather A/B {leg}: " + json.dumps(dict(
            root=str(root), shape=case["shape"], ms=case["ms"],
            bound_ms=case["bound_ms"], kernel_min_ms=v["kernel_min_ms"],
            kernel_median_ms=v["kernel_median_ms"],
            library_min_ms=v["library_min_ms"],
            library_median_ms=v["library_median_ms"],
            rotation=case["rotation"])))
    return 0


def main() -> int:
    from engine_ab import in_turns
    return in_turns(__file__, one, __doc__)


if __name__ == "__main__":
    sys.exit(main())
