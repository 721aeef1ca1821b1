#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile the port's CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each kernel of the fused serving step against its plain
   PyTorch version on the card, at the shapes of qwen1.5-0.5b serving
   (bf16, 16-token pages, 4 decode lanes + 8 chunk rows of 256 tokens):
   paged mixed attention within 3e-2 absolute (bf16 rounding of the
   probabilities, as the reference's own kernel test), page append, gather
   and scatter bit-exact. Each is timed interleaved plain, kernel, kernel,
   plain with CUDA events, beside the one PyTorch call that computes the
   same function where there is one, and beside its bound: the larger of
   the bytes it must move over 3.35 TB/s and its operations over 989
   TFLOP/s (H100 SXM datasheet). Attention is checked and timed at both
   shapes the engine packs: the mixed step above and the decode-only step
   (4 lanes, Tc = 1), reported under ``decode_only``.
4. layer step — one full-width packed step (24 layers, random seeded
   weights: decode lanes, a mid-page chunk row and pad rows). Per layer, on
   the same input and pool, the attention through the kernels and through
   the plain versions writes bit-equal pages and differs by at most 2% per
   real token, relative to that token's output; a control reading one page
   too few must differ by more. Whole step, against the same step in
   float32: the kernel path's logits no further than twice the plain bf16
   path's, and the control further.
5. engine  — ``ServingEngine`` (CFS, REMOTE donor lease) serves 12 seeded
   requests at full width; every request finishes, CFS preempts and
   restores, each park/restore is one fabric message, and every kernel of
   the path was launched (counts reset just before the run, read after).

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or run outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM datasheet
BF16_FLOPS = 989e12                # H100 SXM datasheet, dense
LAYER_REL_LIMIT = 2e-2             # kernel vs plain, per row, per layer


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def ms_timer(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def interleaved(plain, kernel, iters: int):
    """plain, kernel, kernel, plain: the mean of each side."""
    p1 = ms_timer(plain, iters)
    k1 = ms_timer(kernel, iters)
    k2 = ms_timer(kernel, iters)
    p2 = ms_timer(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import build
    t = time.perf_counter()
    path = build.lib()
    print(f"build: {Path(path._name).name} in "
          f"{time.perf_counter() - t:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")


def main_path_plan():
    """Per-row metadata of a full-width packed step: 4 decode lanes and 8
    chunk rows of Tc = 256 (two real chunks, one starting mid-page, and six
    bucket-pad rows), as the engine packs them with max_running = 4 and
    step_tokens = 256."""
    import numpy as np
    q_starts = np.asarray([700, 431, 255, 40, 136, 0, 0, 0, 0, 0, 0, 0],
                          np.int32)
    n_reals = np.asarray([1, 1, 1, 1, 200, 56, 0, 0, 0, 0, 0, 0], np.int32)
    return q_starts, n_reals, 4, 256


def decode_only_plan():
    """A decode-only step of the same lanes: R = max_running = 4, Tc = 1,
    as the engine packs every step that schedules no prompt chunk (most
    steps of the engine run)."""
    q_starts, n_reals, n_dec, _ = main_path_plan()
    return q_starts[:n_dec], n_reals[:n_dec], n_dec, 1


def attention_case(torch, np, pool, rng, g, plan, H, read_pps):
    """Run paged mixed attention and its plain version on one plan; return
    the record of the comparison, the times and the bound."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    dev = pool.device
    P, _, _, page, hd = pool.shape
    page_bytes = pool[0].numel() * pool.element_size()
    q_starts, n_reals, n_dec, Tc = plan
    R = len(q_starts)
    bt_np = rng.integers(1, P, (R, read_pps)).astype(np.int32)
    q = torch.randn((R, Tc, H, hd), generator=g, device=dev,
                    dtype=pool.dtype)
    args = (q, pool, torch.as_tensor(bt_np).to(dev),
            torch.as_tensor(q_starts).to(dev),
            torch.as_tensor(n_reals).to(dev),
            (torch.arange(R, device=dev) < n_dec).to(torch.int32))
    out = pa_ops.paged_mixed_attention_pool(*args)
    ref = pa_ref.paged_mixed_attention_pool_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not (err <= 3e-2 and torch.isfinite(out).all()):
        raise AssertionError(f"paged_mixed_attention_pool (R={R}, Tc={Tc}): "
                             f"max abs err {err}")
    ms, plain_ms = interleaved(
        lambda: pa_ref.paged_mixed_attention_pool_ref(*args),
        lambda: pa_ops.paged_mixed_attention_pool(*args), 10)
    # what this plan needs: every unmasked (query row, key) pair, and the
    # pages those keys live on
    pairs, pages_needed = 0, set()
    for r in range(R):
        rows = 1 if r < n_dec else int(n_reals[r])
        for t in range(rows):
            q_pos = int(q_starts[r]) + (0 if r < n_dec else t)
            pairs += (q_pos + 1) * H
            pages_needed.update(bt_np[r, :q_pos // page + 1].tolist())
    nbytes = (2 * q.numel() * q.element_size() + len(pages_needed) * page_bytes
              + bt_np.size * 4 + 3 * R * 4)
    b, by = bound_ms(nbytes, 4.0 * pairs * hd)
    return dict(shape=f"R={R} Tc={Tc} read_pps={read_pps}", max_abs_err=err,
                tolerance=3e-2, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


def phase_kernels(torch, np, cfg, report):
    from repro_torch.kernels.kv_gather import ops as kv_ops
    from repro_torch.kernels.kv_gather import ref as kv_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    K, hd, H, page = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads, 16
    read_pps = 1024 // page
    P = 4 * cfg.n_layers * read_pps + 1          # the engine's LOCAL pool
    pool = torch.randn((P, 2, K, page, hd), generator=g, device=dev,
                       dtype=torch.bfloat16)
    page_bytes = pool[0].numel() * pool.element_size()

    # -- paged mixed attention: the mixed step (decode lanes whose tail
    # rows are fully masked, chunk rows, pad rows) and the decode-only step
    # (Tc = 1: every tile all live, so the page loop is cut) -------------
    q_starts, _, n_dec, _ = main_path_plan()
    mixed = attention_case(torch, np, pool, rng, g, main_path_plan(), H,
                           read_pps)
    decode = attention_case(torch, np, pool, rng, g, decode_only_plan(), H,
                            read_pps)
    report.append(dict(
        name="paged_mixed_attention_pool", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:356",
        **{**mixed, "max_abs_err": max(mixed["max_abs_err"],
                                       decode["max_abs_err"])},
        decode_only=decode))

    # -- page append -----------------------------------------------------
    bt_np = rng.integers(1, P, (n_dec, read_pps)).astype(np.int32)
    k_new = torch.randn((n_dec, K, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    slots = torch.as_tensor(bt_np[np.arange(n_dec),
                                  q_starts[:n_dec] // page]).to(dev)
    offs = torch.as_tensor(q_starts[:n_dec] % page).to(dev)
    want = pa_ref.append_kv_ref(pool.clone(), k_new, v_new, slots, offs)
    got = pa_ops.append_kv(pool.clone(), k_new, v_new, slots, offs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"append_kv differs from its plain version "
                             f"(max abs err {err})")
    del got, want
    ms, plain_ms = interleaved(
        lambda: pa_ref.append_kv_ref(pool, k_new, v_new, slots, offs),
        lambda: pa_ops.append_kv(pool, k_new, v_new, slots, offs), 50)
    b, by = bound_ms(4 * k_new.numel() * k_new.element_size() + 2 * n_dec * 4)
    report.append(dict(
        name="append_kv", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:423",
        max_abs_err=err, tolerance=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None))

    # -- gather / scatter: one park of a request at ~800 tokens of context
    n = cfg.n_layers * 50
    ids = torch.as_tensor(rng.choice(np.arange(1, P), n, replace=False)
                          .astype(np.int32)).to(dev)
    ids64 = ids.long()
    staging = kv_ops.gather_pages(pool, ids)
    want = kv_ref.gather_pages_ref(pool, ids)
    torch.cuda.synchronize()
    if not torch.equal(staging, want):
        raise AssertionError("gather_pages differs from its plain version")
    ms, plain_ms = interleaved(lambda: kv_ref.gather_pages_ref(pool, ids),
                               lambda: kv_ops.gather_pages(pool, ids), 20)
    lib1 = ms_timer(lambda: torch.index_select(pool, 0, ids64), 20)
    b, by = bound_ms(2 * n * page_bytes + n * 4)
    report.append(dict(
        name="gather_pages", route="cuda",
        source="src/repro_torch/csrc/kv_gather.cu",
        replaces="src/repro/kernels/kv_gather/kernel.py:31",
        max_abs_err=0.0, tolerance=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=lib1))

    remote = torch.zeros((2 * n, 2, K, page, hd), device=dev,
                         dtype=torch.bfloat16)
    dst = torch.as_tensor(rng.choice(2 * n, n, replace=False)
                          .astype(np.int32)).to(dev)
    dst64 = dst.long()
    want = kv_ref.scatter_pages_ref(remote.clone(), staging, dst)
    got = kv_ops.scatter_pages(remote.clone(), staging, dst)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("scatter_pages differs from its plain version")
    del got, want
    ms, plain_ms = interleaved(
        lambda: kv_ref.scatter_pages_ref(remote, staging, dst),
        lambda: kv_ops.scatter_pages(remote, staging, dst), 20)
    lib2 = ms_timer(lambda: remote.index_copy_(0, dst64, staging), 20)
    report.append(dict(
        name="scatter_pages", route="cuda",
        source="src/repro_torch/csrc/kv_gather.cu",
        replaces="src/repro/kernels/kv_gather/kernel.py:49",
        max_abs_err=0.0, tolerance=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=lib2))
    for k in report:
        for case in [k] + ([k["decode_only"]] if "decode_only" in k else []):
            print(f"kernel {k['name']} {case.get('shape', '')}: err "
                  f"{case['max_abs_err']:.3g} kernel {case['ms']:.4f} ms "
                  f"plain {case['plain_ms']:.4f} ms bound "
                  f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}) "
                  f"library {case['library_ms']}")
    del pool, remote, staging


def phase_layer_step(torch, np, cfg, model, dev):
    """One full-width packed step, checked two ways.

    Per layer: on the same layer input and the same pool, the layer's
    attention (``attention_mixed_paged``) through the kernels and through
    the plain versions must write bit-equal pages (all but the scratch
    page) and give outputs whose per-row relative distance stays within
    ``LAYER_REL_LIMIT``. A control — the plain version reading one page too
    few, which drops the furthest decode lane's own page — must land beyond
    that limit, so the limit can see a page lost by a kernel.

    Whole step: the logits of the kernel path, the plain bf16 path and the
    control are each compared with the same step in float32; the kernel
    path must be no further than twice the plain bf16 path, and the control
    further."""
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, mlp, rms_norm
    from repro_torch.models import api
    rng = np.random.default_rng(1)
    g = torch.Generator(device=dev).manual_seed(1)
    page, max_seq = 16, 1024
    read_pps = max_seq // page
    pps_pad = read_pps + 256 // page + 1
    q_starts, n_reals, n_dec, Tc = main_path_plan()
    R, L = len(q_starts), cfg.n_layers
    short_pps = int(q_starts[:n_dec].max()) // page    # the control's sweep
    need = [-(-(int(s) + max(int(n), 1)) // page) if n else 0
            for s, n in zip(q_starts, n_reals)]
    P = 1 + L * sum(need)
    pool = torch.randn((P, 2, cfg.n_kv_heads, page, cfg.resolved_head_dim),
                       generator=g, device=dev, dtype=cfg.torch_compute_dtype())
    bt = np.zeros((L, 1, R, pps_pad), np.int32)        # 0 = scratch
    free = rng.permutation(np.arange(1, P)).astype(np.int32)
    for l in range(L):
        for r in range(R):
            bt[l, 0, r, :need[r]], free = free[:need[r]], free[need[r]:]
    tokens = rng.integers(0, cfg.vocab_size, (R, Tc)).astype(np.int32)

    # -- per layer: kernel vs plain on the same input and pool -------------
    bt_dev = torch.as_tensor(bt).to(dev)
    meta = attn.step_meta(q_starts, n_reals, n_dec, Tc, dev)
    # the real tokens: they read only real pages (a pad position may read
    # the scratch page, whose content depends on the order of duplicate
    # writes)
    compared = torch.as_tensor(np.arange(Tc)[None] < n_reals[:, None]).to(dev)
    x = embed(model.embed, cfg, torch.as_tensor(tokens).to(dev))
    p_ref = pool.clone()
    rel = {"kernel": [], "control": []}
    pages_equal = True
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)

        def run(p, impl, pps):
            return attn.attention_mixed_paged(
                blk.mix, cfg, h, p, bt_dev[layer, 0], q_starts, n_reals,
                n_decode=n_dec, read_pps=pps, impl=impl, meta=meta)
        out_k, p_k = run(p_ref.clone(), "kernel", read_pps)
        out_c, _ = run(p_ref.clone(), "ref", short_pps)
        out_r, p_ref = run(p_ref, "ref", read_pps)
        scale = out_r.float().abs().amax(-1).clamp_min(1e-6)
        for name, o in (("kernel", out_k), ("control", out_c)):
            d = (o.float() - out_r.float()).abs().amax(-1) / scale
            rel[name].append(d[compared].max().item())
        pages_equal &= torch.equal(p_k[1:], p_ref[1:])
        x = x + out_r
        x = x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))
    del p_k, p_ref, out_k, out_c, out_r
    lk, lc = max(rel["kernel"]), min(rel["control"])
    print(f"layer step, per layer ({L} layers, R={R} Tc={Tc}): attention "
          f"output max per-row relative diff to plain: kernel {lk:.4g} "
          f"(layers {', '.join(f'{v:.3g}' for v in rel['kernel'])}); "
          f"control reading {short_pps} of {read_pps} pages, least "
          f"{lc:.4g} (layers {', '.join(f'{v:.3g}' for v in rel['control'])})"
          f"; written pages equal: {pages_equal}")

    # -- whole step against float32 ----------------------------------------
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    runs = {"ref": (model, cfg, "ref", read_pps),
            "kernel": (model, cfg, "kernel", read_pps),
            "control": (model, cfg, "ref", short_pps),
            "f32": (copy.deepcopy(model).float(), cfg32, "ref", read_pps)}
    real = np.nonzero(n_reals > 0)[0]
    outs = {}
    for name, (mdl, c, impl, pps) in runs.items():
        p = pool.clone().to(c.torch_compute_dtype())
        logits, _ = api.serve_step_paged(
            mdl, c, tokens, {"kv": p}, {"kv": bt}, q_starts, n_reals,
            n_decode=n_dec, read_pps=pps, impl=impl)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        outs[name] = logits.float()
        del p
    del runs
    if tuple(outs["kernel"].shape) != (R, cfg.vocab_size) \
            or not torch.isfinite(outs["kernel"]).all():
        raise AssertionError("layer step: logits of the wrong shape or "
                             "not finite")

    def rows(name):
        d = (outs[name] - outs["f32"]).abs().amax(-1)[real]
        return [round(v, 4) for v in d.tolist()]
    dist = {name: rows(name) for name in ("kernel", "ref", "control")}
    agree = (outs["kernel"][real].argmax(-1)
             == outs["f32"][real].argmax(-1)).float().mean().item()
    print(f"layer step, whole: logits |f32| max "
          f"{outs['f32'][real].abs().max().item():.3g}; per real row max abs "
          f"diff to f32: {json.dumps(dist)}; argmax agreement of the kernel "
          f"path with f32 {agree:.3f}")
    if not pages_equal:
        raise AssertionError("layer step: pages written by the kernel path "
                             "differ from the plain path's")
    if not lk <= LAYER_REL_LIMIT < lc:
        raise AssertionError(
            f"layer step: kernel vs plain {lk} must be within "
            f"{LAYER_REL_LIMIT}, and the one-page-short control ({lc}) "
            f"beyond it")
    limit = 2 * max(dist["ref"])
    if not max(dist["kernel"]) <= limit < max(dist["control"]):
        raise AssertionError(
            f"layer step: the kernel path's logits ({max(dist['kernel'])} "
            f"from float32) must be within twice the plain bf16 path's "
            f"({limit}), and the one-page-short control "
            f"({max(dist['control'])}) beyond it")


def phase_engine(torch, np, cfg, model, dev):
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedStateRuntime

    n_req, new_tokens = 12, 32
    # logical ids must cover the LOCAL pool and every parked page: 24
    # layers x up to 50 pages x 12 requests, plus the pool itself
    kv = PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=4,
                           host_pages=1024, n_logical=32768,
                           prefix_cache=False, device=dev)
    eng = ServingEngine(cfg, model, max_running=4, max_seq=1024,
                        scheduler="cfs", slice_tokens=8, step_tokens=256,
                        offload_tier=REMOTE, kv=kv, spec_chunk_ahead=False,
                        device=dev)
    eng.pager.add_remote_lease("donor0", 2 * 1024 ** 3)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(128, 769))
        reqs.append(eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                                          n))),
                               new_tokens, arrival=0.01 * i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    # ServingEngine.run, with each step timed to its end on the device
    step_s = []
    t = time.perf_counter()
    while (eng.waiting or eng.running) and len(step_s) < 5000:
        t_step = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_step)
    wall = time.perf_counter() - t
    m = eng.metrics
    launches = build.launch_counts()
    meter = eng.pager.meter
    gen = sum(len(r.generated) for r in reqs)
    prompt = sum(len(r.prompt_tokens) for r in reqs)
    print(f"engine: {n_req} requests, {prompt} prompt + {gen} generated "
          f"tokens in {m.steps} steps, {wall:.3f} s wall, "
          f"{(prompt + gen) / wall:.1f} tokens/s, {gen / wall:.1f} "
          f"generated tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    mixed = np.asarray(m.prefill_tokens_trace) > 0
    for kind, sel in (("all", np.ones_like(mixed)), ("with prompt chunks",
                                                     mixed),
                      ("decode only", ~mixed)):
        x = np.asarray(step_s)[sel] * 1e3
        if len(x):
            print(f"engine: step wall ms, {kind} ({len(x)} steps): p50 "
                  f"{np.percentile(x, 50):.2f} p99 {np.percentile(x, 99):.2f}"
                  f" max {x.max():.2f} mean {x.mean():.2f}")
    print(f"engine: preemptions {m.preemptions} restores {m.restores} "
          f"(prefetched {m.prefetched_restores}) messages_fabric "
          f"{meter.messages_fabric} bytes_fabric {meter.bytes_fabric:.0f}")
    print(f"engine: kernel launches {json.dumps(launches, sort_keys=True)}")
    print(f"pager: {json.dumps(eng.pager.stats(), sort_keys=True)}")
    if len(eng.finished) != n_req or not all(
            len(r.generated) == new_tokens for r in reqs):
        raise AssertionError("engine: not every request finished")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated):
        raise AssertionError("engine: generated token outside the vocab")
    if not (m.preemptions > 0 and m.restores > 0):
        raise AssertionError("engine: CFS never preempted/restored")
    if meter.messages_fabric != m.preemptions + m.restores:
        raise AssertionError(
            f"engine: {meter.messages_fabric} fabric messages != "
            f"{m.preemptions} preemptions + {m.restores} restores")
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"needs torch and numpy ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run "
                    "needs an NVIDIA GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout "
                    "of the repository")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 yardstick
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    cfg = get_config("qwen1.5-0.5b")
    report: list = []
    phase_kernels(torch, np, cfg, report)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = lm.init_params(cfg, gen, "cuda")
    dev = torch.device("cuda")
    phase_layer_step(torch, np, cfg, model, dev)
    launches = phase_engine(torch, np, cfg, model, dev)
    for k in report:
        k["launches"] = int(launches.get(k["name"], 0))
    missing = [k["name"] for k in report if k["launches"] == 0]
    if missing:
        raise AssertionError(f"engine run never launched {missing}")
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
