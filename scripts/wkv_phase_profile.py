"""Where the time of the WKV kernel (``src/repro_torch/csrc/wkv6.cu``) goes,
on an NVIDIA GPU: builds three copies of the kernel into the git-ignored
``build/wkv_profile/`` and times them at the rwkv6-3b engine's launch
shapes (bf16, H 40, hd 64):

- ``base``: the kernel as it is;
- ``noA``: the same with the causal-pair loop of A skipped (wrong results;
  the difference to ``base`` is what that loop costs);
- ``stamped``: ``clock64()`` read by lane 0 of every warp at each phase
  border of every chunk, for the mean SM cycles a chunk spends per phase.

    PYTHONPATH=src python3 scripts/wkv_phase_profile.py

Exits non-zero without a GPU. The copies are made by replacing text of the
source, so a phase border whose text changed is reported, not guessed.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "wkv_profile"
PHASES = ("wait for the stage", "cumsum", "barrier", "A and y_cross",
          "barrier", "A @ v and y", "state")
SLOTS = 8                              # stamps per chunk: PHASES + 1
CHUNKS = 16                            # chunks stamped per block
BLOCKS = 400


def stamp(n: int) -> str:
    return (f"if (lane == 0 && c < {CHUNKS}) g_stamp[((blockIdx.x * 8 + "
            f"warp) * {CHUNKS} + c) * {SLOTS} + {n}] = clock64();\n")


def variants() -> dict:
    """{name: {text of wkv6.cu: its replacement}}."""
    stamped = {
        "    tc::cp_wait<0>();\n    __syncthreads();":
            "    " + stamp(0) + "    tc::cp_wait<0>();\n    __syncthreads();"
            "\n    " + stamp(1),
        "    __syncthreads();\n\n    // -- A over the causal pairs":
            "    " + stamp(2) + "    __syncthreads();\n    " + stamp(3)
            + "\n    // -- A over the causal pairs",
        "    __syncthreads();\n    if (c + 1 < n_chunks)\n      load_w":
            "    " + stamp(4) + "    __syncthreads();\n    " + stamp(5)
            + "    if (c + 1 < n_chunks)\n      load_w",
        "    // -- S = 2^{lw_last}": "    " + stamp(6)
            + "    // -- S = 2^{lw_last}",
        "  }\n  __syncthreads();\n  {\n    float* s = s_out":
            "    " + stamp(7) + "  }\n  __syncthreads();\n  {\n"
            "    float* s = s_out",
        "namespace {\n\nusing tc::bf16;":
            f"__device__ long long g_stamp[{BLOCKS * 8 * CHUNKS * SLOTS}];\n"
            'extern "C" int read_stamps(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_stamp, "
            "sizeof(g_stamp));\n}\nnamespace {\n\nusing tc::bf16;",
    }
    return {"base": {}, "noA": {"      if (live) {\n        const T* k0":
                                "      if (false) {\n        const T* k0"},
            "stamped": stamped}


def build_all(build) -> dict:
    """Compile every variant (one nvcc each, in parallel) -> {name: CDLL}."""
    src = (build.CSRC / "wkv6.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "tc_common.cuh").write_text(
        (build.CSRC / "tc_common.cuh").read_text())
    procs = {}
    for name, subs in variants().items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name}: wkv6.cu no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             str(OUT / f"{name}.cu"), "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.aqua_wkv6.argtypes = build._SIGNATURES["aqua_wkv6"]
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    libs = build_all(build)
    g = torch.Generator(device="cuda").manual_seed(5)
    H, hd = 40, 64

    def launcher(lib, B, T):
        a = cs.wkv_inputs(torch, g, B, T, H, hd, 5.0, torch.device("cuda"))
        y, s = torch.empty_like(a[0]), torch.empty_like(a[5])
        stream = torch.cuda.current_stream().cuda_stream
        return lambda: build.check("wkv6", lib.aqua_wkv6(
            *[t.data_ptr() for t in a], y.data_ptr(), s.data_ptr(), B, T, H,
            hd, 1, stream))

    for rnd in range(2):
        for name in ("base", "noA"):
            ms = {f"{B}x{T}": cs.device_ms(launcher(libs[name], B, T),
                                           20 if T > 1 else 100)
                  for B, T in cs.WKV_SHAPES.values()}
            print(f"round {rnd} {name}: ms per call at (B x T) " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()))
    lib = libs["stamped"]
    B, T = cs.WKV_SHAPES["chunk"]
    launcher(lib, B, T)()
    torch.cuda.synchronize()
    buf = np.zeros(BLOCKS * 8 * CHUNKS * SLOTS, np.int64)
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    build.check("read_stamps", lib.read_stamps(buf.ctypes.data))
    n_chunks = T // 32
    d = buf.reshape(BLOCKS, 8, CHUNKS, SLOTS)[:B * H, :, :n_chunks]
    d = d.astype(np.float64)
    per = np.diff(d, axis=-1)
    for group, ws in (("warps 0-3", slice(0, 4)), ("warps 4-7", slice(4, 8))):
        mean = per[:, ws].mean(axis=(0, 1, 2))
        chunk = (d[:, ws, 1:, 0] - d[:, ws, :-1, 0]).mean()
        print(f"stamped, {group}: SM cycles a chunk, " + ", ".join(
            f"{p} {m:.0f}" for p, m in zip(PHASES, mean))
            + f"; chunk to chunk {chunk:.0f}")
    span = d[:, 0, -1, -1] - d[:, 0, 0, 0]
    print(f"stamped: block span in SM cycles mean {span.mean():.0f} min "
          f"{span.min():.0f} max {span.max():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
