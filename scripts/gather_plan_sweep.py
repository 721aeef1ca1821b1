"""Sweep the bulk-copy gather's work plan on one NVIDIA GPU.

At each of ``chip_smoke.py``'s row-6 leg shapes (cold: the id sets taken in
turn, ``chip_smoke.gather_leg_inputs``), times the gather under plans other
than ``kv_gather.ops.gather_plan``'s (chunk, ring stages, blocks per SM),
beside the default plan, the vector kernel at the same shape,
``index_select`` and one contiguous copy of as many bytes (``clone`` of n
consecutive pool rows: what the card's memory gives a copy without the
gather's scattered rows); each the median of 3 device timings, the plans
checked bit-exact first. Prints one JSON line per leg, the fastest plans
first.

    python3 scripts/gather_plan_sweep.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (4096, 8192, 16384, 32768)
STAGES = (2, 4, 6, 8)
BLOCKS_PER_SM = (1, 2, 3, 4)
SM_SHARED = 228 * 1024          # an SM's shared memory, 1 KiB a block kept


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        return chip_smoke.fail("the plan sweep needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_gather import ops as kv_ops
    dev = torch.device("cuda")
    chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    sms = kv_ops.sm_count(0)
    default_plan = kv_ops.gather_plan

    def timed(pool, id_sets, plan):
        kv_ops.gather_plan = lambda *a: plan
        try:
            for ids in id_sets[:2]:
                if not torch.equal(kv_ops.gather_pages(pool, ids),
                                   pool[ids.long()]):
                    raise AssertionError(f"plan {plan} gathers wrong rows")
            call = chip_smoke.rotation(
                lambda ids: kv_ops.gather_pages(pool, ids), id_sets)
            return float(np.median([chip_smoke.device_ms(call, 20)
                                    for _ in range(3)]))
        finally:
            kv_ops.gather_plan = default_plan

    for leg, pool, id_sets, call_bytes in chip_smoke.gather_leg_inputs(
            torch, get_config("qwen1.5-0.5b"), get_config("rwkv6-3b"), dev):
        n, row = len(id_sets[0]), pool[0].nbytes
        base = default_plan(n, row, 16, sms)
        rows = [("default", base, timed(pool, id_sets, base)),
                ("vector kernel", kv_ops.GatherPlan("vector", 0, 0, 0),
                 timed(pool, id_sets, kv_ops.GatherPlan("vector", 0, 0, 0)))]
        for chunk in sorted({min(c, row) for c in CHUNKS}):
            items = n * -(-row // chunk)
            for stages in STAGES:
                for bps in BLOCKS_PER_SM:
                    if bps * (chunk * stages + 1024) > SM_SHARED:
                        continue
                    plan = kv_ops.GatherPlan("bulk", chunk, stages,
                                             min(items, bps * sms))
                    rows.append((f"bps {bps}", plan,
                                 timed(pool, id_sets, plan)))
        lib = chip_smoke.rotation(lambda ids: torch.index_select(pool, 0, ids),
                                  [ids.long() for ids in id_sets])
        lib_ms = float(np.median([chip_smoke.device_ms(lib, 20)
                                  for _ in range(3)]))
        copy = chip_smoke.rotation(
            lambda k: pool[1 + k * n:1 + (k + 1) * n].clone(),
            range(len(id_sets)))
        copy_ms = float(np.median([chip_smoke.device_ms(copy, 20)
                                   for _ in range(3)]))
        bound = chip_smoke.bound_ms(call_bytes)[0]
        rows.sort(key=lambda r: r[2])
        print(f"gather sweep {leg}: " + json.dumps(dict(
            shape=f"{n} pages of {row} B", bound_ms=bound,
            index_select_ms=lib_ms, contiguous_copy_ms=copy_ms,
            plans=[dict(label=label, ms=ms, **plan._asdict())
                   for label, plan, ms in rows])))
        del pool, id_sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
