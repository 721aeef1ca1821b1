"""A/B of the qwen1.5-0.5b serving engine between checkouts, on one NVIDIA
GPU: for each ROOT in turn, in a process of its own, that checkout's
``src/repro_torch`` builds its kernels and serves ``chip_smoke.py``'s phase
6 (12 seeded CFS requests at full width, step walls by kind, launches),
then one chunk step and one decode-only step of the same requests under
``torch.profiler``. The phases are this checkout's ``chip_smoke.py``; only
the package they drive comes from ROOT.

    python3 scripts/engine_ab.py PARENT CHANGE CHANGE PARENT

Give the roots in turns (parent, change, change, parent) to compare on one
card. Exits non-zero without a GPU or if any run fails.
"""
from __future__ import annotations

import subprocess
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
        return chip_smoke.fail("engine A/B needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"== {root}")
    chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    cfg = get_config("qwen1.5-0.5b")
    model = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    chip_smoke.phase_engine(torch, np, cfg, model, torch.device("cuda"),
                            profile=True)
    return 0


def in_turns(script: str, one_root, doc: str) -> int:
    """``script --one ROOT`` runs ``one_root(ROOT)``; ``script ROOT...``
    runs that for each ROOT in turn, each in a process of its own. Any
    other ``--`` option is passed on to every run, where ``one_root`` reads
    it from ``sys.argv``."""
    opts = [a for a in sys.argv[1:] if a.startswith("--") and a != "--one"]
    args = [a for a in sys.argv[1:] if a not in opts]
    if len(args) == 2 and args[0] == "--one":
        return one_root(Path(args[1]).resolve())
    if not args:
        print(doc, file=sys.stderr)
        return 2
    rc = 0
    for root in args:
        rc |= subprocess.run([sys.executable, script, *opts, "--one",
                              root]).returncode
    return rc


def main() -> int:
    return in_turns(__file__, one, __doc__)


if __name__ == "__main__":
    sys.exit(main())
