"""One worker of ``test_torch_distributed_training.py``: joins a gloo group
through a ``FileStore``, runs ``compressed_psum`` on seeded inputs for two
rounds (the second fed the first's error buffers) and saves the sums and
error buffers. Imports only torch, numpy and repro_torch.

    python tests/_torch_dist_worker.py RANK WORLD STORE_FILE OUT_NPZ
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.training.compression import compressed_psum

SHAPES = ((64,), (8, 33), (2, 3, 5))
SEED = 30


def inputs(rank: int, rounds: int = 2):
    """Each rank's gradients: round k, tensor i from one numpy seed; the
    last tensor of rank 0 is 100x larger, so the shared scale is not the
    local one on every rank."""
    rng = np.random.default_rng(SEED + rank)
    out = []
    for _ in range(rounds):
        gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        if rank == 0:
            gs[-1] = gs[-1] * np.float32(100.0)
        out.append(gs)
    return out


def main(rank: int, world: int, store_file: str, out: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    errs = [torch.zeros(s) for s in SHAPES]
    saved = {}
    for k, gs in enumerate(inputs(rank)):
        for i, g in enumerate(gs):
            mean, errs[i] = compressed_psum(torch.from_numpy(g), errs[i])
            saved[f"mean_{k}_{i}"] = mean.numpy()
            saved[f"err_{k}_{i}"] = errs[i].numpy()
    dist.destroy_process_group()
    np.savez(out, **saved)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
