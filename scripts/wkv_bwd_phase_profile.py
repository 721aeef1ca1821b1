"""Where the time of a WKV backward goes, on an NVIDIA GPU: builds copies
of its source into the git-ignored ``build/wkv_bwd_profile/`` and times
each pass of every copy, bf16, strong decay. Two targets:

- the square backward (``src/repro_torch/csrc/wkv6_bwd.cu``) at rwkv6-3b's
  training shape (4, 2048, 40, 64); its passes are 1 (states), 2
  (dstates) and 3 (chunk). Copies: ``base`` (the kernels as they are),
  ``no_loads`` (the chunk pass without its global loads: the rows, states
  and state gradients it reads), ``no_products`` (without its
  register-tile products S dy, dS v, (k b)^T dS, vdy), ``no_pairs``
  (without its two loops over the causal pairs);
- with ``--keyslice``, the key-slice backward
  (``src/repro_torch/csrc/wkv6_keyslice_bwd.cu``) at the ``pod256``
  rank's rwkv6-3b ``train_4k`` micro-batch (4, 4,096, 40 heads, K 4 of V
  64); its passes are 1 (chunk sums), 2 (the scan both ways) and 3 (the
  chunk pass). Copies: ``base``, ``no_loads`` (the chunk pass without its
  global loads: the chunk's rows, its entry states and exit-state
  gradients), ``no_walks`` (without its two walks: the states and their
  gradients into shared memory), ``no_sums`` (without its sums over value
  columns: dr, dk, dw), ``no_dv`` (without its sums over key rows: dv).

A skipped phase leaves wrong results; its copy's time against ``base`` is
what that phase costs. Each copy is timed twice per pass and for the whole
call (CUDA events behind a device-side wait, ``chip_smoke.device_ms``).

    PYTHONPATH=src python3 scripts/wkv_bwd_phase_profile.py [--keyslice]

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


def square_variants() -> dict:
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


def keyslice_variants() -> dict:
    """{name: [(text of wkv6_keyslice_bwd.cu, its replacement)]}."""
    return {
        "base": [],
        "no_loads": [
            ("    rr.load(r, ch, H, tid);\n    kk.load(k, ch, H, tid);\n"
             "    ww.load(w, ch, H, tid);\n    vv.load(v, ch, H, tid);\n"
             "    yy.load(dy, ch, H, tid);\n", ""),
            ("          init[g][q] = from[(g * KG + q0 + q) * V];",
             "          init[g][q] = 0.f;")],
        "no_walks": [("    if (walks && !reverse) {", "    if (false) {"),
                     ("    } else if (walks) {", "    } else if (false) {")],
        "no_sums": [("for (int p0 = 0; p0 < ch.n * KG; p0 += NT / TPP) {",
                     "for (int p0 = 0; p0 < 0; p0 += NT / TPP) {")],
        "no_dv": [("    for (int m = 0; m < C::kDvItems; ++m) {",
                   "    for (int m = 0; m < 0; ++m) {")],
    }


# per target: its source, its C entry, its copies, {pass: pass mask}
TARGETS = {
    "square": ("wkv6_bwd.cu", "aqua_wkv6_bwd", square_variants,
               {"states": 1, "dstates": 2, "chunk": 4, "call": 7}),
    "keyslice": ("wkv6_keyslice_bwd.cu", "aqua_wkv6_keyslice_bwd",
                 keyslice_variants,
                 {"sums": 1, "scan": 2, "chunk": 4, "call": 7}),
}


def build_all(target: str) -> dict:
    """{name: loaded library} of every copy of ``target``'s source whose
    texts were all found, built side by side."""
    from repro_torch.kernels import build
    source, export, variants, _ = TARGETS[target]
    src = (CSRC / source).read_text()
    procs = {}
    for name, reps in variants().items():
        text = src
        missing = [a for a, _ in reps if a not in text]
        if missing:
            print(f"{name}: text not found, skipped: {missing[0][:60]!r}")
            continue
        for a, b in reps:
            text = text.replace(a, b)
        d = OUT / target / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / target / name / "lib.so"))
        getattr(lib, export).argtypes = build._SIGNATURES[export]
        libs[name] = getattr(lib, export)
    return libs


def square_operands(torch, cs, dev):
    """(pointers, dims, label) of one ``aqua_wkv6_bwd`` call."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-3b")
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    B, T = cs.WKV_TRAIN_SHAPES["train"]
    g = torch.Generator(device=dev).manual_seed(12)
    args = cs.wkv_bwd_inputs(torch, g, B, T, H, hd, max(cs.WKV_DECAYS),
                             torch.bfloat16, dev)
    nt = -(-T // 32)
    r, w, s0 = args[0], args[3], args[5]
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty_like(w), torch.empty((B, H, nt, hd), device=dev),
        torch.empty_like(s0)] + [
        torch.empty((B, H, nt, hd, hd), device=dev) for _ in range(2)]
    return (list(args) + outs, (B, T, H, hd),
            f"B={B} T={T} H={H} hd={hd} bfloat16")


def keyslice_operands(torch, cs, dev):
    """(pointers, dims, label) of one ``aqua_wkv6_keyslice_bwd`` call."""
    shape, _ = cs.TRAIN_PARTITION_WKV["train"]
    B, T, H, K, V = shape
    g = torch.Generator(device=dev).manual_seed(12)
    r, k, v, w, u, s0 = cs.keyslice_inputs(torch, g, shape,
                                           max(cs.WKV_DECAYS), dev)
    dy = torch.randn((B, T, H, V), generator=g, device=dev).to(r.dtype)
    ds = torch.randn((B, H, K, V), generator=g, device=dev)
    nt = -(-T // 32)
    outs = [torch.empty_like(r), torch.empty_like(r), torch.empty_like(v),
            torch.empty_like(w), torch.empty((B, H, nt, K), device=dev),
            torch.empty_like(s0), torch.empty((B, H, nt, K), device=dev)] + [
        torch.empty((B, H, nt, K, V), device=dev) for _ in range(2)]
    return ([r, k, v, w, u, s0, dy, ds] + outs, (B, T, H, K, V),
            f"B={B} T={T} H={H} K={K} V={V} bfloat16")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("the WKV backward profile needs an NVIDIA GPU")
    target = "keyslice" if "--keyslice" in sys.argv else "square"
    card = cs.phase_device(torch)
    libs = build_all(target)
    operands = keyslice_operands if target == "keyslice" else square_operands
    tensors, dims, label = operands(torch, cs, torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, passes):
        rc = fn(*(t.data_ptr() for t in tensors), *dims, 1, passes, stream)
        if rc:
            raise RuntimeError(f"{target} backward failed with CUDA error "
                               f"{rc}")
    for name, fn in libs.items():
        ms = {p: [cs.device_ms(lambda: call(fn, bits), 10)
                  for _ in range(2)]
              for p, bits in TARGETS[target][3].items()}
        print(f"wkv {target} backward phase profile: " + json.dumps(dict(
            variant=name, card=card, shape=label, ms=ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
