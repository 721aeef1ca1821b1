"""Where the time of the WKV backward (``src/repro_torch/csrc/wkv6_bwd.cu``)
goes, on an NVIDIA GPU: builds copies of the source into the git-ignored
``build/wkv_bwd_profile/`` and times each pass of every copy at rwkv6-3b's
training shape (4, 2048, 40, 64), bf16, strong decay:

- ``base``: the kernels as they are;
- ``no_loads``: the chunk pass without its global loads (the rows, states
  and state gradients it reads);
- ``no_products``: the chunk pass without its register-tile products (S dy,
  dS v, (k b)^T dS, vdy);
- ``no_pairs``: the chunk pass without its two loops over the causal pairs.

A skipped phase leaves wrong results; its copy's time against ``base`` is
what that phase costs. Each copy is timed twice per pass (CUDA events behind
a device-side wait, ``chip_smoke.device_ms``): pass 1 (states), pass 2
(dstates), pass 3 (chunk) and the whole call.

    PYTHONPATH=src python3 scripts/wkv_bwd_phase_profile.py

Exits non-zero without a GPU. The copies are made by replacing text of the
source, so a phase whose text changed is reported, not guessed.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "wkv_bwd_profile"
PASSES = {"states": 1, "dstates": 2, "chunk": 4, "call": 7}


def variants() -> dict:
    """{name: [(text of wkv6_bwd.cu, its replacement)]}."""
    def skip(head):                    # a loop headed ``head`` runs no time
        return (head, head.replace(" < HD;", " < 0;").replace(" < 31;",
                                                              " < 0;"))
    return {
        "base": [],
        "no_loads": [
            ("const bool live = e < kChunk * PR && t < cn;",
             "const bool live = false;"),
            ("xw[q] = e < kChunk * PW && t < cn", "xw[q] = false"),
            ("xs[q] = reinterpret_cast<const float4*>(states + sq)"
             "[tid + q * kChunkThreads];",
             "xs[q] = make_float4(0.f, 0.f, 0.f, 0.f);"),
            ("xd[q] = reinterpret_cast<const float4*>(dstates + sq)"
             "[tid + q * kChunkThreads];",
             "xd[q] = make_float4(0.f, 0.f, 0.f, 0.f);")],
        "no_products": [
            skip("for (int j = 0; j < HD; j += 4) {\n"
                 "      float yr[4][4], vr[4][4]"),
            skip("for (int i = 0; i < HD; i += 4) {\n"
                 "      float kb[4][4]"),
            skip("for (int j = 0; j < HD; j += 4) {\n"
                 "      float yr[4][4], vr[2][4];")],
        "no_pairs": [
            skip("for (int s = 0; s < 31; ++s) {\n"
                 "        const bool up = s < nhi;"),
            skip("for (int s = 0; s < 31; ++s) {\n"
                 "        const bool lo = s < nhi;")],
    }


def build_all(src: str) -> dict:
    """{name: loaded library} of every copy whose texts were all found."""
    from repro_torch.kernels import build
    procs = {}
    for name, reps in variants().items():
        text = src
        missing = [a for a, _ in reps if a not in text]
        if missing:
            print(f"{name}: text not found, skipped: {missing[0][:60]!r}")
            continue
        for a, b in reps:
            text = text.replace(a, b)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wkv6_bwd.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(d / "lib.so"), str(d / "wkv6_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.aqua_wkv6_bwd.argtypes = build._SIGNATURES["aqua_wkv6_bwd"]
        libs[name] = lib
    return libs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        return chip_smoke.fail("the WKV backward profile needs an NVIDIA GPU")
    from repro_torch.configs import get_config
    card = chip_smoke.phase_device(torch)
    libs = build_all((CSRC / "wkv6_bwd.cu").read_text())
    cfg = get_config("rwkv6-3b")
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    B, T = chip_smoke.WKV_TRAIN_SHAPES["train"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    args = chip_smoke.wkv_bwd_inputs(torch, g, B, T, H, hd,
                                     max(chip_smoke.WKV_DECAYS),
                                     torch.bfloat16, dev)
    nt = -(-T // 32)
    r, w, s0 = args[0], args[3], args[5]
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty_like(w), torch.empty((B, H, nt, hd), device=dev),
        torch.empty_like(s0)] + [
        torch.empty((B, H, nt, hd, hd), device=dev) for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, passes):
        rc = lib.aqua_wkv6_bwd(*(t.data_ptr() for t in args + outs), B, T,
                               H, hd, 1, passes, stream)
        if rc:
            raise RuntimeError(f"aqua_wkv6_bwd failed with CUDA error {rc}")
    for name, lib in libs.items():
        ms = {p: [chip_smoke.device_ms(lambda: call(lib, bits), 10)
                  for _ in range(2)] for p, bits in PASSES.items()}
        print("wkv backward phase profile: " + json.dumps(dict(
            variant=name, card=card, shape=f"B={B} T={T} H={H} hd={hd} "
            "bfloat16", ms=ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
