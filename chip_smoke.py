#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failed check:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compile the port's CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each kernel of the serving paths against its plain PyTorch
   version on the card, at the shapes of qwen1.5-0.5b serving (bf16,
   16-token pages, 64 pages per request): paged mixed attention (4 decode
   lanes + 8 chunk rows of 256 tokens), chunked-prefill attention (one
   256-token chunk from 512 and from mid-page 200), decode attention over
   the fused pool and over its split K/V halves (4 lanes at 700/431/255/40)
   all within 3e-2 absolute (bf16 rounding of the probabilities, as the
   reference's own kernel tests); the page writer, gather and scatter
   bit-exact. Decode over the split halves must equal decode over the pool
   bit for bit, and in one mixed launch of the 4 lanes and the 256-token
   chunk each row must equal the per-request kernels' bit for bit. Each
   kernel's device time comes from CUDA events around back-to-back calls
   queued behind a device-side wait (interleaved plain, kernel, kernel,
   plain), beside the one PyTorch call that computes the same function
   where there is one, and beside its bound: the larger of the bytes it
   must move over 3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM
   datasheet). Mixed attention is checked and timed at both shapes the
   engine packs: the mixed step above and the decode-only step (4 lanes,
   Tc = 1), reported under ``decode_only``. The page writer (row 5) too:
   the packed step's form (``write_kv_rows``, 516 tokens of the 12-row
   plan in one launch; its plain version's time is host-paced, it
   synchronises) and the decode form (``append_kv``, 4 lanes, under
   ``decode_only``), each beside one ``index_put_``; at the step form also
   the old path it replaced (``append_kv`` + the per-row
   ``write_chunk_pages`` loop), equal off scratch, with its device and
   host-paced times. The gather (row 6) is checked and timed at the
   engine's three leg shapes: a qwen park (1200 kv pages of 64 KiB) and
   one rwkv6-3b request's state (32 wkv pages of 655,360 B, 32 shift pages
   of 10,240 B, under ``rwkv_wkv`` / ``rwkv_shift``), each cold (disjoint
   id sets and their staging buffers taken in turn, more than 100 MB
   between two uses of one); the scatter at the qwen park's shape. Both
   are also held against ``index_select`` / ``index_copy_`` over 5
   interleaved rounds (min and median). First it prints the bf16
   paged-attention kernels' registers and spills (``-Xptxas -v``) and
   dynamic shared memory at hd 32, 64 and 128, the page writer's
   registers and local memory, and the bulk-copy gather's plan, registers,
   local memory and ring at each leg shape.
4. layer step — one full-width packed step (24 layers, random seeded
   weights: decode lanes, a mid-page chunk row and pad rows). Per layer, on
   the same input and pool, the attention through the kernels and through
   the plain versions writes bit-equal pages and differs by at most 2% per
   real token, relative to that token's output; a control reading one page
   too few must differ by more. Whole step, against the same step in
   float32: the kernel path's logits no further than twice the plain bf16
   path's, and the control further. The same kernel step with the old
   page writes (``append_kv`` and a ``write_chunk_pages`` call per chunk
   row) must give the real rows' logits bit for bit and the same pages
   but scratch.
5. per-request — the four prompts (700, 431, 255 and 40 tokens) prefilled
   chunk by chunk, from mid-page starts, through ``api.prefill_chunk_paged``
   into a ``PagedStateRuntime``, then 32 steps of ``api.decode_step_paged``
   over the 4 lanes, at full width; its kernels must all launch (counts
   reset just before, read after). Per layer, at the 40-token prompt's
   mid-page chunk and at the first decode step, the same checks as phase 4
   (the decode control swaps the shortest lane's newest page for scratch);
   each prompt's last-token logits no further from float32 than twice the
   plain bf16 path's, a one-page-short control further. Then decode over
   the split K/V halves of that runtime's pool, driven directly for every
   layer's tables (its own count), equal bit for bit to the pool kernel.
   Walls and launch counts are printed beside the same prompts served
   through the fused step (``ServingEngine``, FCFS), with how many greedy
   tokens the two paths share (reported, not asserted: the GEMMs' tiling
   changes with the number of rows).
6. engine  — ``ServingEngine`` (CFS, REMOTE donor lease) serves 12 seeded
   requests at full width; every request finishes, CFS preempts and
   restores, each park/restore is one fabric message, every kernel of
   the path was launched (counts reset just before the run, read after),
   and the page writer once per layer per step (as many launches as mixed
   attention). A second run of the same requests profiles one chunk step
   and one decode-only step under ``torch.profiler``: kernels launched,
   device busy ms, idle share, top-5 device kernels.
6b. lease lifecycle — the same 12 requests four more times on a lease
   granted by a ``Coordinator`` (donor0 offers 2 GiB, reclaims polled
   every step) and a 10,240-page host tier: a baseline; a coordinator
   reclaim after the first step that leaves pages on donor0 (evacuated to
   HOST at the next boundary: one fabric leg of the pages' live bytes,
   one gather; ``reclaim_status`` true, the remote tier 0); a lease
   shrink of donor0 at that step beside a second donor (the pages move
   donor to donor, one gather and one scatter; ``migrated_pages`` > 0, no
   recompute); a donor loss at that step with ``audit=True`` (recomputes,
   an audit per step, no LOST page left, every request's 32 tokens in the
   vocab). The reclaim and the shrink must give the baseline's tokens.
   Each move's span is timed by CUDA events and printed with the card.
6c. admission and the request lifecycle — the same 12 requests on a
   16,384-page host tier. First with ``admission=True``, ``audit=True``
   and ``watchdog_steps=16``: the occupancy trace stays <= 1, every
   request finishes, an audit per step; printed: deferrals, the largest
   queue depth, watchdog trips, TTFT p50/p99 on the analytic clock and how
   many tokens agree with phase 6's run (reported, not asserted: admission
   changes the schedule). Then without admission: after the first step
   that leaves a request parked on donor0, a waiting, a prefilling, a
   decoding and that parked request are cancelled (each leaves no page in
   any plane and no slot, ``output`` raises ``CancelledError``, the auditor
   is clean); a few steps later ``drain`` (no slot, no pin, only scratch
   LOCAL) and ``resume``; later a ``snapshot`` (pages, bytes), then the
   original runs to its end and the snapshot is restored into a fresh
   runtime of the phase's geometry and run to its end: every request in
   flight at the snapshot must get the original's tokens, or part only at
   a token whose two steps packed other shapes, the logits of every token
   made at steps packed alike within 2% (reported: the agreement and how
   many of those rows are bit-identical). Drain, snapshot and restore are
   each timed by CUDA events with their gather/scatter launches (the
   snapshot also split into its read and its copy to the host, and
   ``restore_state`` alone) and printed with the card.

Then rwkv6-3b at its published width (32 layers, d 2560, 40 heads of 64,
d_ff 8960, vocab 65536, bf16; random seeded weights), whose context is two
state planes, ``wkv`` (40, 64, 64) float32 and ``shift`` (2, 2560), one
page each per layer:

7. wkv kernel — ``wkv6`` against the float32 scan and the plain dispatch
   (the chunked form at T 256) at the engine's three launch shapes: the
   chunk region (8, 256, 40, 64), the decode region (4, 1, 40, 64) and a
   short bucket (8, 24, 40, 64), decays from weak to the strong-decay
   stress (wmax 5.0), within the reference's sweep limits (bf16 y rtol
   2e-2 / atol 5e-2, float32 state rtol 1e-3 / atol 5e-4); a control with
   one lane's incoming state zeroed must land beyond them. Device times
   beside the plain version's and the bound (bytes, float32 operations and
   exponentials; no PyTorch call computes the recurrence, so no library
   time); the kernel's registers and spills (``-Xptxas -v``), local
   memory, shared memory and resident blocks per SM at hd 32 and 64.
8. rwkv layer step — one full-width packed step: per layer, on the same
   input and pools, the time-mix of both row regions through the kernel
   and the plain versions (outputs within 2% per real token, new wkv
   states within the WKV limits; a control with a lane's state zeroed
   beyond both) and the sub-layer's shift pages (within 2%); the whole
   step's logits against float32 (within twice the plain bf16 path's
   distance, the control further).
9. rwkv per-request — phase 5's prompts and decode steps through
   ``api.prefill_chunk_paged`` / ``api.decode_step_paged`` (``wkv6`` must
   launch), prefill logits against float32 with a control that drops the
   state between chunks, and beside them the fused engine: walls, launches
   and agreeing greedy tokens.
10. rwkv engine — phase 6 for rwkv6-3b; besides its checks, every park and
   restore moves exactly one request's whole state (21,299,200 bytes), and
   ``wkv6`` launched on the path.

Then qwen1.5-0.5b's training path at its published width (bf16 params,
float32 AdamW master and moments):

11. flash kernels — the forward (``flash_attention``) and the backward
   (``flash_attention_bwd``: its dQ and dK/dV kernels) against their plain
   versions, over the reference's sweep (GQA, window, Sq < Sk,
   bidirectional, MQA at hd 256) and the training shape (4, 2048, 16, 64)
   causal, in float32 and bfloat16: forward within the reference's TOL
   (3e-5 / 3e-2 absolute), dq/dk/dv within 1e-4 / 2e-2 of the plain
   formula's norm; a control that masks every row's diagonal key as well
   must land beyond both. Device times at the training shape in bf16
   beside the plain versions', the bound (FLOP of the visible pairs over
   989 TFLOP/s, bytes over 3.35 TB/s) and the library call (PyTorch's
   fused attention, forward and forward + backward, timed in
   ``library_attention_ms`` and nowhere else), with each kernel's achieved
   TFLOP/s and share of its bound; two bf16 backward calls at the training
   shape must agree bit for bit; the bf16 tensor-core kernels' registers
   and spills (``-Xptxas -v``) and shared memory at every head dim.
12. train step — ``init_params`` at full width, one ``make_batch`` batch of
   1 x 2048 tokens: per layer, on the same input, the attention through the
   kernel and the plain version within 2% per token (a control whose first
   layer loses its diagonal key beyond); the loss and the gradients through
   ``api.loss_fn(impl="kernel")`` against ``impl="ref"``: loss within 2e-2
   absolute, every parameter's gradient within 5e-2 of the plain one's
   norm, the control's beyond; 24 ``flash_attention`` and at least 24
   ``flash_attention_bwd`` launches in the kernel step.
13. train run — ``training/train_loop.train`` for 10 steps at batch 4 x
   2048, cosine schedule, no checkpoints: every loss finite, the last below
   the first; step time p50/p99, tokens/s, peak memory, launches per step
   and the model-FLOP share of the p50 step (6 x params x tokens plus the
   attention FLOP, over 989 TFLOP/s). Its launches are the flash rows'.
   Then one more steady step under ``torch.profiler`` (CPU and CUDA
   activities): device time by kernel name (top 10), the flash kernels'
   sum against the step and the device's idle share ("not measured" where
   the trace holds no device time).

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


def device_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls queued behind a device-side
    wait long enough for the host to enqueue all of them, so the events
    bracket back-to-back execution on the card, not the host's launch rate.
    The wait is lengthened until the enqueue fits inside it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(2_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 2_000_000 / start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    wait_ms = 3e3 * (time.perf_counter() - t) + 2.0
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * wait_ms))
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t)
        end.synchronize()
        if enqueue_ms < wait_ms:
            return start.elapsed_time(end) / iters
        wait_ms *= 2
    raise AssertionError("device_ms: the host could not enqueue the calls "
                         "inside the device-side wait")


def interleaved(plain, kernel, iters: int, plain_iters: int = 0):
    """plain, kernel, kernel, plain (device times): the mean of each side.
    ``plain_iters`` (default ``iters``) keeps a plain version of many small
    launches inside the device's launch queue while it waits."""
    p1 = device_ms(plain, plain_iters or iters)
    k1 = device_ms(kernel, iters)
    k2 = device_ms(kernel, iters)
    p2 = device_ms(plain, plain_iters or iters)
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


LANES = (700, 431, 255, 40)         # decode lanes' positions, as above
KERNEL_SRC = "src/repro_torch/csrc/paged_attention.cu"
TPU_SRC = "src/repro/kernels/paged_attention/kernel.py"


def attention_bound(np, bt_np, q_pos_rows, H, hd, page, page_bytes,
                    io_bytes):
    """Bound of an attention call from what its data needs: the bytes of q
    and the output (``io_bytes``), of the pages the unmasked keys live on
    and of the table entries read, and 4 * hd operations per unmasked
    (query head, key) pair. ``q_pos_rows``: per table row, the query
    positions (each attends to keys 0 .. q_pos)."""
    pairs, pages, entries = 0, set(), 0
    for r, q_pos in enumerate(q_pos_rows):
        for p in q_pos:
            pairs += (int(p) + 1) * H
        n = int(max(q_pos)) // page + 1
        pages.update(bt_np[r, :n].tolist())
        entries += n
    return bound_ms(io_bytes + len(pages) * page_bytes + entries * 4 + 4
                    * len(q_pos_rows), 4.0 * pairs * hd)


def per_request_kernels(torch, np, pool, rng, g, H, read_pps, report):
    """The per-request kernels at the engine's shapes, each against its
    plain version and timed; decode over the split halves against decode
    over the pool, and both per-request kernels against one mixed launch,
    bit for bit."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    dev = pool.device
    P, _, K, page, hd = pool.shape
    page_bytes = pool[0].numel() * pool.element_size()

    def check(name, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= 3e-2 and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: max abs err {err}")
        return err

    # -- chunked prefill: one request's 256-token chunk from 512 (page
    # aligned) and from 200 (mid-page)
    cases, chunk = {}, {}
    Tc = 256
    for q_start in (512, 200):
        bt_np = rng.integers(1, P, (1, read_pps)).astype(np.int32)
        q = torch.randn((1, Tc, H, hd), generator=g, device=dev,
                        dtype=pool.dtype)
        args = (q, pool, torch.as_tensor(bt_np).to(dev),
                torch.tensor([q_start], dtype=torch.int32, device=dev))
        out = pa_ops.paged_prefill_attention_pool(*args)
        err = check("paged_prefill_attention_pool", out,
                    pa_ref.paged_prefill_attention_pool_ref(*args))
        ms, plain_ms = interleaved(
            lambda: pa_ref.paged_prefill_attention_pool_ref(*args),
            lambda: pa_ops.paged_prefill_attention_pool(*args), 10)
        b, by = attention_bound(np, bt_np, [range(q_start, q_start + Tc)], H,
                                hd, page, page_bytes,
                                2 * q.numel() * q.element_size())
        cases[q_start] = dict(
            shape=f"B=1 Tc={Tc} q_start={q_start} read_pps={read_pps}",
            max_abs_err=err, tolerance=3e-2, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=None)
        chunk[q_start] = (args, out)
    report.append(dict(
        name="paged_prefill_attention_pool", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:245",
        **{**cases[512], "max_abs_err": max(c["max_abs_err"]
                                            for c in cases.values())},
        mid_page=cases[200]))

    # -- decode: 4 lanes at 700/431/255/40, lengths pos + 1, over the pool
    # and over its split halves read in place
    B = len(LANES)
    bt_np = rng.integers(1, P, (B, read_pps)).astype(np.int32)
    q = torch.randn((B, H, hd), generator=g, device=dev, dtype=pool.dtype)
    bt = torch.as_tensor(bt_np).to(dev)
    lengths = torch.tensor(LANES, dtype=torch.int32, device=dev) + 1
    k_half, v_half = pool[:, 0].movedim(1, 0), pool[:, 1].movedim(1, 0)
    b, by = attention_bound(np, bt_np, [[p] for p in LANES], H, hd, page,
                            page_bytes, 2 * q.numel() * q.element_size())
    shape = f"B={B} lanes {'/'.join(map(str, LANES))} pps={read_pps}"
    dec_pool = pa_ops.paged_attention_pool(q, pool, bt, lengths)
    err = check("paged_attention_pool", dec_pool,
                pa_ref.paged_attention_pool_ref(q, pool, bt, lengths))
    ms, plain_ms = interleaved(
        lambda: pa_ref.paged_attention_pool_ref(q, pool, bt, lengths),
        lambda: pa_ops.paged_attention_pool(q, pool, bt, lengths), 10)
    report.append(dict(
        name="paged_attention_pool", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:157", shape=shape, max_abs_err=err,
        tolerance=3e-2, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None))
    dec_split = pa_ops.paged_attention(q, k_half, v_half, bt, lengths)
    err = check("paged_attention", dec_split,
                pa_ref.paged_attention_ref(q, k_half, v_half, bt, lengths))
    ms, plain_ms = interleaved(
        lambda: pa_ref.paged_attention_ref(q, k_half, v_half, bt, lengths),
        lambda: pa_ops.paged_attention(q, k_half, v_half, bt, lengths), 10)
    report.append(dict(
        name="paged_attention", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:454", shape=shape + " (split K/V views)",
        max_abs_err=err, tolerance=3e-2, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None))

    # -- bit for bit: split == pool; one mixed launch of the 4 lanes and
    # the 256-token chunk from 512 == the per-request kernels' rows
    if not torch.equal(dec_split, dec_pool):
        raise AssertionError("paged_attention on the split halves differs "
                             "from paged_attention_pool on the pool")
    (cq, _, cbt, cqs), chunk_out = chunk[512]
    qm = torch.zeros((B + 1, Tc, H, hd), device=dev, dtype=pool.dtype)
    qm[:B, 0], qm[B] = q, cq[0]
    starts = torch.cat([lengths - 1, cqs])
    mixed = pa_ops.paged_mixed_attention_pool(
        qm, pool, torch.cat([bt, cbt]), starts,
        torch.tensor([1] * B + [Tc], dtype=torch.int32, device=dev),
        torch.tensor([1] * B + [0], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    same = (torch.equal(mixed[:B, 0], dec_pool),
            torch.equal(mixed[B:], chunk_out))
    print(f"bit-identity: split == pool True; mixed launch decode lanes == "
          f"paged_attention_pool {same[0]}; chunk row == "
          f"paged_prefill_attention_pool {same[1]}")
    if not all(same):
        raise AssertionError("a mixed launch's rows differ from the "
                             "per-request kernels' on the same q and pool")


REPEATS = 5                         # rounds of a kernel against its library call


def against_library(np, library, kernel, iters):
    """A kernel against the one PyTorch call that computes the same
    function: ``REPEATS`` rounds of library, kernel, kernel, library
    (device times), with the min and median of each side."""
    lib, ker = [], []
    for _ in range(REPEATS):
        lib.append(device_ms(library, iters))
        ker.append(device_ms(kernel, iters))
        ker.append(device_ms(kernel, iters))
        lib.append(device_ms(library, iters))
    return dict(kernel_ms=ker, library_ms=lib, kernel_min_ms=min(ker),
                kernel_median_ms=float(np.median(ker)),
                library_min_ms=min(lib),
                library_median_ms=float(np.median(lib)))


def print_writer_resources(pa_ops):
    """The page writer's registers and local memory at every head dim, for
    bfloat16 and float32 pools; it must use no local memory."""
    for hd in pa_ops.BF16_HEAD_DIMS:
        info = pa_ops.writer_kernel_info(hd)
        print(f"page writer kernel hd {hd}: " + "; ".join(
            f"{dt} {r['registers']} registers, local {r['local_bytes']} B"
            for dt, r in info.items()))
        if any(r["local_bytes"] for r in info.values()):
            raise AssertionError(f"page writer kernel at hd {hd} uses local "
                                 "memory")


def old_step_writer(q_starts, n_dec):
    """The page writes of ``attention_mixed_paged`` before the step writer,
    with ``ops.write_kv_rows``'s signature: the decode lanes through
    ``append_kv``, then each chunk row's page-window read-modify-write
    (``write_chunk_pages``, bucket-pad rows included, on scratch), a Python
    loop over the rows that reads their starts from the host array
    ``q_starts``."""
    import torch
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    def write(kv_pool, k_new, v_new, block_table, q_starts_dev, n_write):
        R, Tc = k_new.shape[:2]
        page = kv_pool.shape[3]
        if n_dec:
            pos = q_starts_dev[:n_dec]
            slot = torch.gather(block_table[:n_dec], 1,
                                (pos // page)[:, None].long())[:, 0]
            pa_ops.append_kv(kv_pool, k_new[:n_dec, 0], v_new[:n_dec, 0],
                             slot.contiguous(), pos % page)
        win = pa_ref.window_pages(Tc, page)
        for r in range(n_dec, R):
            start = int(q_starts[r]) // page
            pa_ref.write_chunk_pages(
                kv_pool, k_new[r:r + 1], v_new[r:r + 1],
                block_table[r, start:start + win].long(),
                int(q_starts[r]) % page, page_tokens=page)
        return kv_pool
    return write


def append_case(torch, np, pool, rng, g, lanes, read_pps):
    """Row 5 in its decode form: one token per lane at ``lanes`` through
    ``append_kv``, against its plain version (bit for bit) and the one
    ``index_put_`` that makes the same write; times and bound."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    dev = pool.device
    P, _, K, page, hd = pool.shape
    n_dec = len(lanes)
    bt_np = rng.integers(1, P, (n_dec, read_pps)).astype(np.int32)
    k_new = torch.randn((n_dec, K, hd), generator=g, device=dev,
                        dtype=pool.dtype)
    v_new = torch.randn_like(k_new)
    slots = torch.as_tensor(bt_np[np.arange(n_dec), lanes // page]).to(dev)
    offs = torch.as_tensor(lanes % page).to(dev)
    want = pa_ref.append_kv_ref(pool.clone(), k_new, v_new, slots, offs)
    got = pa_ops.append_kv(pool.clone(), k_new, v_new, slots, offs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"append_kv differs from its plain version "
                             f"(max abs err {err})")
    # the one PyTorch call that makes the same write: index_put_ with
    # broadcast (slot, K|V, head, offset) indices
    idx = (slots.long()[:, None, None],
           torch.arange(2, device=dev)[None, :, None],
           torch.arange(K, device=dev)[None, None, :],
           offs.long()[:, None, None])
    kv_rows = torch.stack([k_new, v_new], dim=1)        # (B, 2, K, hd)
    if not torch.equal(pool.clone().index_put_(idx, kv_rows), want):
        raise AssertionError("index_put_ differs from append_kv's plain "
                             "version")
    del got, want
    ms, plain_ms = interleaved(
        lambda: pa_ref.append_kv_ref(pool, k_new, v_new, slots, offs),
        lambda: pa_ops.append_kv(pool, k_new, v_new, slots, offs), 100)
    host_ms = ms_timer(
        lambda: pa_ops.append_kv(pool, k_new, v_new, slots, offs), 50)
    lib = device_ms(lambda: pool.index_put_(idx, kv_rows), 100)
    b, by = bound_ms(4 * k_new.numel() * k_new.element_size() + 2 * n_dec * 4)
    return dict(shape=f"B={n_dec} decode lanes", max_abs_err=err,
                tolerance=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib, host_ms=host_ms)


def step_writer_case(torch, np, pool, rng, g, read_pps):
    """Row 5 in the packed step's form: ``write_kv_rows`` at the main
    path's plan (4 decode lanes, 2 chunk rows of Tc 256, 6 bucket-pad
    rows writing nothing) against its plain version and the one
    ``index_put_`` that makes the same write, bit for bit over the whole
    pool (every table entry its own page, pad rows on scratch), and against
    the old path it replaced (``append_kv`` + the per-row
    ``write_chunk_pages`` loop), equal at every page but scratch. Device
    times in turns; the old path's device and host-paced times beside the
    kernel's. The plain version finds its (row, token) pairs with
    ``nonzero``, a host synchronisation, so its time is host-paced."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.layers import attention as attn
    dev = pool.device
    P, _, K, page, hd = pool.shape
    q_starts, n_reals, n_dec, Tc = main_path_plan()
    R = len(q_starts)
    W = read_pps + Tc // page + 1               # the engine's padded width
    bt_np = rng.permutation(np.arange(1, P))[:R * W].reshape(R, W)
    bt_np = bt_np.astype(np.int32)
    bt_np[(np.arange(R) >= n_dec) & (n_reals == 0)] = 0   # pad rows: scratch
    meta = attn.step_meta(q_starts, n_reals, n_dec, Tc, dev)
    k_new = torch.randn((R, Tc, K, hd), generator=g, device=dev,
                        dtype=pool.dtype)
    v_new = torch.randn_like(k_new)
    args = (k_new, v_new, torch.as_tensor(bt_np).to(dev), meta["q_starts"],
            meta["n_write"])
    want = pa_ref.write_kv_rows_ref(pool.clone(), *args)
    got = pa_ops.write_kv_rows(pool.clone(), *args)
    old = old_step_writer(q_starts, n_dec)
    got_old = old(pool.clone(), *args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"write_kv_rows differs from its plain version "
                             f"(max abs err {err})")
    if not torch.equal(got_old[1:], got[1:]):
        raise AssertionError("write_kv_rows differs from the old path "
                             "(append_kv + write_chunk_pages) off scratch")
    # the (row, token) pairs with work, and the one index_put_ that writes
    # their rows with broadcast (slot, K|V, head, offset) indices
    n_write = meta["n_write"].cpu().numpy()
    rows = np.repeat(np.arange(R), n_write)
    cols = np.concatenate([np.arange(n) for n in n_write])
    pos = q_starts[rows].astype(np.int64) + cols
    slots = bt_np[rows, pos // page]
    rows_d, cols_d = (torch.as_tensor(a).to(dev) for a in (rows, cols))
    idx = (torch.as_tensor(slots).long().to(dev)[:, None, None],
           torch.arange(2, device=dev)[None, :, None],
           torch.arange(K, device=dev)[None, None, :],
           torch.as_tensor(pos % page).to(dev)[:, None, None])
    kv_rows = torch.stack([k_new[rows_d, cols_d], v_new[rows_d, cols_d]],
                          dim=1)                        # (N, 2, K, hd)
    if not torch.equal(pool.clone().index_put_(idx, kv_rows), want):
        raise AssertionError("index_put_ differs from write_kv_rows' plain "
                             "version")
    del got, want, got_old

    def kernel():
        pa_ops.write_kv_rows(pool, *args)

    def plain():
        pa_ref.write_kv_rows_ref(pool, *args)

    def old_path():
        old(pool, *args)
    p1 = ms_timer(plain, 20)
    o1 = device_ms(old_path, 5)
    k1 = device_ms(kernel, 100)
    k2 = device_ms(kernel, 100)
    o2 = device_ms(old_path, 5)
    p2 = ms_timer(plain, 20)
    oh1 = ms_timer(old_path, 10)
    kh1 = ms_timer(kernel, 50)
    kh2 = ms_timer(kernel, 50)
    oh2 = ms_timer(old_path, 10)
    lib = device_ms(lambda: pool.index_put_(idx, kv_rows), 100)
    N = len(rows)
    b, by = bound_ms(2 * N * 2 * K * hd * pool.element_size() + N * 4
                     + 2 * R * 4)
    return dict(shape=f"R={R} Tc={Tc} step, {N} tokens written",
                max_abs_err=err, tolerance=0.0, ms=(k1 + k2) / 2,
                plain_ms=(p1 + p2) / 2, plain_host_paced=True, bound_ms=b,
                bound_by=by, library_ms=lib, host_ms=(kh1 + kh2) / 2,
                old_path=dict(device_ms=(o1 + o2) / 2,
                              host_ms=(oh1 + oh2) / 2,
                              equal_off_scratch=True))


ROTATION_BYTES = 100e6              # moved between two uses of one id set


def rotation(fn, args):
    """A call that runs ``fn`` on the next of ``args`` in turn and keeps its
    result alive until that turn comes round again."""
    keep = [None] * len(args)
    turn = [0]

    def call():
        i = turn[0] % len(args)
        turn[0] += 1
        keep[i] = fn(args[i])
    return call


def gather_leg_shapes(torch, qcfg, rcfg):
    """Row 6's shapes on the engine paths: leg -> (page shape, dtype, pages
    per leg, pages in the pool or 0 for just the id sets). qwen: a park of
    ~800 tokens (50 pages of 16 tokens a layer) from the engine's LOCAL
    pool; rwkv6-3b: one request's wkv and shift planes, a page a layer."""
    hd = rcfg.ssm.rwkv_head_dim
    return {
        "qwen_kv": ((2, qcfg.n_kv_heads, 16, qcfg.resolved_head_dim),
                    torch.bfloat16, qcfg.n_layers * 50,
                    4 * qcfg.n_layers * 64 + 1),
        "rwkv_wkv": ((rcfg.d_model // hd, hd, hd), torch.float32,
                     rcfg.n_layers, 0),
        "rwkv_shift": ((2, rcfg.d_model), rcfg.torch_compute_dtype(),
                       rcfg.n_layers, 0)}


def gather_leg_inputs(torch, qcfg, rcfg, dev):
    """Per leg shape: (leg, pool, id sets, bytes a call moves). The ids
    come in disjoint sets, enough that more than ``ROTATION_BYTES`` move
    between two uses of one set and of its staging buffer when they are
    taken in turn (the L2 holds 50 MB; the engine finds a parked request's
    pages cold)."""
    import math
    g = torch.Generator(device=dev).manual_seed(3)
    for leg, (page, dtype, n, P) in gather_leg_shapes(torch, qcfg,
                                                      rcfg).items():
        row = math.prod(page) * dtype.itemsize
        call_bytes = 2 * n * row + 4 * n
        sets = math.ceil(ROTATION_BYTES / call_bytes) + 1
        P = max(P, sets * n + 1)
        pool = torch.randn((P,) + page, generator=g, device=dev).to(dtype)
        perm = torch.randperm(P - 1, generator=g, device=dev) + 1
        yield (leg, pool, list(perm[:sets * n].to(torch.int32).view(sets, n)),
               call_bytes)


def gather_legs(torch, np, kv_ops, kv_ref, qcfg, rcfg, dev):
    """Row 6 at each leg shape, cold (``gather_leg_inputs``): on every id
    set bit-exact against the plain version; then device times over the
    sets in turn (plain, kernel, kernel, plain) and ``REPEATS`` rounds
    beside ``index_select``."""
    legs = {}
    for leg, pool, id_sets, call_bytes in gather_leg_inputs(torch, qcfg,
                                                            rcfg, dev):
        for ids in id_sets:
            if not torch.equal(kv_ops.gather_pages(pool, ids),
                               kv_ref.gather_pages_ref(pool, ids)):
                raise AssertionError(f"gather_pages differs from its plain "
                                     f"version at {leg}")
        kernel = rotation(lambda ids: kv_ops.gather_pages(pool, ids), id_sets)
        plain = rotation(lambda ids: kv_ref.gather_pages_ref(pool, ids),
                         id_sets)
        library = rotation(lambda ids: torch.index_select(pool, 0, ids),
                           [ids.long() for ids in id_sets])
        ms, plain_ms = interleaved(plain, kernel, 20)
        vs_lib = against_library(np, library, kernel, 20)
        b, by = bound_ms(call_bytes)
        n, sets = len(id_sets[0]), len(id_sets)
        legs[leg] = dict(
            shape=f"{leg}: {n} pages of {pool[0].nbytes} B from "
                  f"{pool.shape[0]}, {pool.dtype}",
            max_abs_err=0.0, tolerance=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=vs_lib["library_median_ms"],
            vs_library=vs_lib,
            rotation=f"{sets} id sets and staging buffers in turn, "
                     f"{(sets - 1) * call_bytes / 1e6:.1f} MB between two "
                     f"uses of one")
        del pool, id_sets, kernel, plain, library
        torch.cuda.empty_cache()
    return legs


def print_gather_resources(torch, kv_ops, qcfg, rcfg):
    """The bulk-copy gather's plan, registers, local memory and ring at each
    leg shape; it must use no local memory and fit the card's opt-in shared
    memory per block."""
    import math
    for leg, (page, dtype, n, _) in gather_leg_shapes(torch, qcfg,
                                                      rcfg).items():
        row = math.prod(page) * dtype.itemsize
        plan = kv_ops.gather_plan(n, row, 16, kv_ops.sm_count(0))
        info = kv_ops.gather_kernel_info(plan)
        print(f"gather kernel {leg}: plan {json.dumps(plan._asdict())}; "
              f"{info['registers']} registers, local {info['local_bytes']} "
              f"B, ring {info['smem_bytes']} B of {info['smem_optin_bytes']}"
              f" B a block")
        if plan.route != "bulk" or info["local_bytes"] or not (
                0 < info["smem_bytes"] <= info["smem_optin_bytes"]):
            raise AssertionError(f"gather kernel at {leg}: not the bulk "
                                 f"copy, or local memory, or its ring "
                                 f"exceeds the card's shared memory")


def phase_kernels(torch, np, cfg, report):
    from repro_torch.kernels.kv_gather import ops as kv_ops
    from repro_torch.kernels.kv_gather import ref as kv_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    print_paged_resources(pa_ops)
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
    per_request_kernels(torch, np, pool, rng, g, H, read_pps, report)

    # -- row 5, the page writer: the decode form (4 lanes through
    # append_kv) and the packed step's form (write_kv_rows at the main
    # path's plan), beside the old path the step form replaced -----------
    print_writer_resources(pa_ops)
    decode = append_case(torch, np, pool, rng, g, q_starts[:n_dec], read_pps)
    step = step_writer_case(torch, np, pool, rng, g, read_pps)
    report.append(dict(
        name="append_kv", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:423",
        **{**step, "max_abs_err": max(step["max_abs_err"],
                                      decode["max_abs_err"])},
        decode_only=decode))

    # -- row 6, gather, at the engine's three leg shapes (cold); then
    # scatter at the qwen park's shape, its staging from one gather --------
    from repro_torch.configs import get_config
    rcfg = get_config("rwkv6-3b")
    print_gather_resources(torch, kv_ops, cfg, rcfg)
    legs = gather_legs(torch, np, kv_ops, kv_ref, cfg, rcfg, dev)
    report.append(dict(
        name="gather_pages", route="cuda",
        source="src/repro_torch/csrc/kv_gather.cu",
        replaces="src/repro/kernels/kv_gather/kernel.py:31",
        **legs["qwen_kv"], rwkv_wkv=legs["rwkv_wkv"],
        rwkv_shift=legs["rwkv_shift"]))
    n = cfg.n_layers * 50
    ids = torch.as_tensor(rng.choice(np.arange(1, P), n, replace=False)
                          .astype(np.int32)).to(dev)
    staging = kv_ops.gather_pages(pool, ids)
    b, by = bound_ms(2 * n * page_bytes + n * 4)

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
    vs_lib = against_library(
        np, lambda: remote.index_copy_(0, dst64, staging),
        lambda: kv_ops.scatter_pages(remote, staging, dst), 20)
    report.append(dict(
        name="scatter_pages", route="cuda",
        source="src/repro_torch/csrc/kv_gather.cu",
        replaces="src/repro/kernels/kv_gather/kernel.py:49",
        max_abs_err=0.0, tolerance=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=vs_lib["library_median_ms"],
        vs_library=vs_lib))
    for k in report:
        for case in [k] + [k[sub] for sub in ("decode_only", "mid_page",
                                              "rwkv_wkv", "rwkv_shift")
                           if sub in k]:
            print(f"kernel {k['name']} {case.get('shape', '')}: err "
                  f"{case['max_abs_err']:.3g} kernel {case['ms']:.4f} ms "
                  f"plain {case['plain_ms']:.4f} ms bound "
                  f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}) "
                  f"library {case['library_ms']}"
                  + (f" host-paced {case['host_ms']:.4f} ms"
                     if "host_ms" in case else ""))
            if "vs_library" in case:
                print(f"kernel {k['name']} {case.get('shape', '')} vs "
                      f"library, {REPEATS} interleaved repeats"
                      + (f" ({case['rotation']})" if "rotation" in case
                         else "") + ": " + json.dumps(case["vs_library"]))
        if "old_path" in k:
            print(f"kernel {k['name']} old path at {k['shape']}: "
                  + json.dumps(k["old_path"]))
    del pool, remote, staging


def per_layer_attention(torch, cfg, model, x, pool, attend, real, keep):
    """Run the layers from input ``x`` on a copy of ``pool``; at each layer,
    on the same input and pool, the attention through the kernels, through
    the plain versions and through the plain versions' control
    (``attend(mix, h, pool, layer, impl, control) -> (out, pool)``). The
    plain output carries the layer on. Returns each layer's largest
    per-token distance to the plain output over the ``real`` tokens,
    relative to that token's largest output, for the kernel and for the
    control, and whether the pages written by the kernel and plain paths
    are equal over the ``keep`` slots."""
    from repro_torch.layers.core import mlp, rms_norm
    p_ref = pool.clone()
    rel = {"kernel": [], "control": []}
    pages_equal = True
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
        out_k, p_k = attend(blk.mix, h, p_ref.clone(), layer, "kernel", False)
        out_c, _ = attend(blk.mix, h, p_ref.clone(), layer, "ref", True)
        out_r, p_ref = attend(blk.mix, h, p_ref, layer, "ref", False)
        scale = out_r.float().abs().amax(-1).clamp_min(1e-6)
        for name, o in (("kernel", out_k), ("control", out_c)):
            d = (o.float() - out_r.float()).abs().amax(-1) / scale
            rel[name].append(d[real].max().item())
        pages_equal &= torch.equal(p_k[keep], p_ref[keep])
        del p_k
        x = x + out_r
        x = x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))
    return rel, pages_equal


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
    from repro_torch.layers.core import embed
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

    def attend(mix, h, p, layer, impl, control):
        return attn.attention_mixed_paged(
            mix, cfg, h, p, bt_dev[layer, 0], q_starts, n_reals,
            n_decode=n_dec, read_pps=short_pps if control else read_pps,
            impl=impl, meta=meta)
    rel, pages_equal = per_layer_attention(torch, cfg, model, x, pool,
                                           attend, compared, slice(1, None))
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
        if name == "kernel":
            new_logits, new_pool = logits, p
        del p
    del runs

    # -- the same kernel step with the old page writes (append_kv and the
    # per-row write_chunk_pages loop): equal bit for bit ------------------
    from repro_torch.kernels.paged_attention import ops as pa_ops
    writer = pa_ops.write_kv_rows
    pa_ops.write_kv_rows = old_step_writer(q_starts, n_dec)
    try:
        old_pool = pool.clone()
        old_logits, _ = api.serve_step_paged(
            model, cfg, tokens, {"kv": old_pool}, {"kv": bt}, q_starts,
            n_reals, n_decode=n_dec, read_pps=read_pps, impl="kernel")
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        pa_ops.write_kv_rows = writer
    same_logits = torch.equal(old_logits[real], new_logits[real])
    same_pages = torch.equal(old_pool[1:], new_pool[1:])
    print(f"layer step, page writes: the kernel step through write_kv_rows "
          f"and through the old path (append_kv + write_chunk_pages per "
          f"row): logits of the {len(real)} real rows equal bit for bit: "
          f"{same_logits}; pages equal but scratch: {same_pages}")
    if not (same_logits and same_pages):
        raise AssertionError("layer step: the step writer and the old path "
                             "give different logits or pages")
    del old_pool, new_pool, old_logits, new_logits
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


# the per-request phase's prompts: length -> chunk split; chunks start
# mid-page (200, 456, 120, 376, 24 with 16-token pages) and stay within the
# 256-token step budget the engine runs with
PROMPTS = {700: (200, 256, 244), 431: (120, 256, 55), 255: (255,),
           40: (24, 16)}
DECODE_STEPS = 32


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def per_request_run(torch, np, cfg, model, dev, prompts, impl, *,
                    decode_steps=0, read_pps=None, hook=None):
    """Serve ``prompts`` [(tokens, chunk split)] through the per-request
    entry points: each prompt chunk by chunk through
    ``api.prefill_chunk_paged`` (bucket-padded), then ``decode_steps`` steps
    of ``api.decode_step_paged`` over all lanes, greedy. Each chunk's and
    step's wall covers the runtime bookkeeping and the call, synchronised.
    ``hook(kind, kv, tokens, tables, pos, n_real)`` sees each call's
    operands just before it runs."""
    from repro_torch.models import api
    from repro_torch.serving.kv_cache import PagedStateRuntime
    from repro_torch.serving.scheduler import bucket_tokens
    kv = PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=4,
                           prefix_cache=False, device=dev)
    pad = kv.pps + 256 // kv.page_tokens + 1
    run = dict(kv=kv, logits=[], tokens=[], chunk_s=[], step_s=[])
    for rid, (prompt, split) in enumerate(prompts):
        pos = 0
        for c in split:
            tk = np.zeros((1, bucket_tokens(c)), np.int32)
            tk[0, :c] = prompt[pos:pos + c]
            t = time.perf_counter()
            kv.ensure_capacity(rid, pos + c)
            bt = kv.block_tables_prefill(rid, pad_to=pad)
            if hook:
                hook("prefill", kv, tk, bt, pos, c)
                t = time.perf_counter()
            lg, kv.pools = api.prefill_chunk_paged(
                model, cfg, tk, kv.pools, bt, pos, c - 1,
                read_pps=read_pps or kv.pps, impl=impl)
            _sync(torch, dev)
            run["chunk_s"].append(time.perf_counter() - t)
            pos += c
        run["logits"].append(lg[0].float())
        run["tokens"].append([int(lg[0].argmax())])
    lanes = list(range(len(prompts)))
    for step in range(decode_steps):
        pos = np.asarray([len(p) + step for p, _ in prompts], np.int64)
        last = np.asarray([t[-1] for t in run["tokens"]], np.int64)
        t = time.perf_counter()
        for rid in lanes:
            kv.ensure_capacity(rid, int(pos[rid]) + 1)
        bts = kv.block_tables(lanes)
        if hook:
            hook("decode", kv, last, bts, pos, len(lanes))
            t = time.perf_counter()
        lg, kv.pools = api.decode_step_paged(model, cfg, kv.pools, bts, last,
                                             pos, impl=impl)
        _sync(torch, dev)
        run["step_s"].append(time.perf_counter() - t)
        for rid, nxt in enumerate(lg.argmax(-1).tolist()):
            run["tokens"][rid].append(int(nxt))
    return run


def layer_check(torch, np, cfg, model, kind, kv, tokens, tables, pos,
                n_real):
    """Phase 4's per-layer check on one per-request call: on the same layer
    input and pool, the layer's attention through the kernels and through
    the plain versions writes bit-equal pages (all but scratch) and its
    output differs by at most ``LAYER_REL_LIMIT`` per real token, relative
    to that token's output; a control must differ by more. Prefill's
    control reads one page too few (the page of the chunk's last real
    token); decode's swaps the shortest lane's newest page for scratch.
    Each control drops 8 or 9 of a short context's ~40 keys: the layer
    step of phase 4 showed the limit sees one lost page of 701 keys, so a
    short context makes the control's margin wide."""
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed
    dev, page = kv.device, kv.page_tokens
    scratch = kv.planes["kv"].scratch_slot
    keep = torch.ones(kv.pools["kv"].shape[0], dtype=torch.bool, device=dev)
    keep[scratch] = False
    bt = torch.as_tensor(tables["kv"]).to(dev)
    tok = torch.as_tensor(tokens).to(dev)
    if kind == "prefill":
        Tc = tokens.shape[1]
        meta = attn.step_meta([pos], [Tc], 0, Tc, dev)
        short = (pos + n_real - 1) // page
        x = embed(model.embed, cfg, tok)

        def attend(mix, h, p, layer, impl, control):
            return attn.attention_prefill_chunk(
                mix, cfg, h, p, bt[layer, 0], pos,
                read_pps=short if control else kv.pps, impl=impl, meta=meta)
        real = (slice(0, 1), slice(0, n_real))
        what = f"prefill chunk from {pos} ({n_real} tokens)"
        ctrl_what = f"reading {short} of {kv.pps} pages"
    else:
        meta = attn.decode_meta(pos, dev)
        lane = int(np.argmin(pos))
        bt_c = bt.clone()
        bt_c[:, 0, lane, int(pos[lane]) // page] = scratch
        x = embed(model.embed, cfg, tok[:, None])

        def attend(mix, h, p, layer, impl, control):
            return attn.attention_decode_paged(
                mix, cfg, h, p, (bt_c if control else bt)[layer, 0], pos,
                impl=impl, meta=meta)
        real = (slice(None), slice(None))
        what = f"decode step of {len(pos)} lanes at {list(map(int, pos))}"
        ctrl_what = f"lane at {int(pos[lane])} reading scratch for its page"
    rel, pages_equal = per_layer_attention(torch, cfg, model, x,
                                           kv.pools["kv"], attend, real, keep)
    lk, lc = max(rel["kernel"]), min(rel["control"])
    print(f"per-request, per layer, {what}: attention output max per-token "
          f"relative diff to plain: kernel {lk:.4g}; control ({ctrl_what}) "
          f"least {lc:.4g}; written pages equal: {pages_equal}")
    if not pages_equal:
        raise AssertionError(f"per-request {kind}: pages written by the "
                             "kernel path differ from the plain path's")
    if not lk <= LAYER_REL_LIMIT < lc:
        raise AssertionError(
            f"per-request {kind}: kernel vs plain {lk} must be within "
            f"{LAYER_REL_LIMIT}, and the control ({lc}) beyond it")


def _walls(np, label, secs):
    x = np.asarray(secs) * 1e3
    return (f"{label} ({len(x)}): p50 {np.percentile(x, 50):.2f} p99 "
            f"{np.percentile(x, 99):.2f} mean {x.mean():.2f} ms")


def phase_per_request(torch, np, cfg, model, dev):
    """The per-request serving path at full width (module docstring, phase
    5). Returns {kernel: launches} of its run and of the split-pool
    drive."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedStateRuntime
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), split)
               for n, split in PROMPTS.items()]

    # -- the kernel path, counted and timed --------------------------------
    _sync(torch, dev)
    build.reset_launch_counts()
    run = per_request_run(torch, np, cfg, model, dev, prompts, "kernel",
                          decode_steps=DECODE_STEPS)
    launches = build.launch_counts()
    print("per-request (api.prefill_chunk_paged / api.decode_step_paged): "
          + _walls(np, "prefill chunk wall", run["chunk_s"]) + "; "
          + _walls(np, "decode step wall", run["step_s"]))
    print(f"per-request: kernel launches {json.dumps(launches, sort_keys=True)}")
    need = ("paged_prefill_attention_pool", "paged_attention_pool",
            "append_kv")
    if not all(launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"per-request run never launched some of {need}")
    if not all(len(t) == DECODE_STEPS + 1 and all(0 <= v < cfg.vocab_size
                                                  for v in t)
               for t in run["tokens"]):
        raise AssertionError("per-request: wrong greedy tokens")

    # -- split-pool decode, driven directly on every layer's tables --------
    kv = run.pop("kv")
    pool = kv.pools["kv"]
    pos = np.asarray([len(p) + DECODE_STEPS for p, _ in prompts])
    bts = torch.as_tensor(kv.block_tables(list(range(len(prompts))))["kv"]
                          ).to(dev)
    lengths = torch.as_tensor(pos.astype(np.int32)).to(dev)
    k_half, v_half = pool[:, 0].movedim(1, 0), pool[:, 1].movedim(1, 0)
    g = torch.Generator(device=dev).manual_seed(3)
    qs = [torch.randn((len(pos), cfg.n_heads, cfg.resolved_head_dim),
                      generator=g, device=dev, dtype=pool.dtype)
          for _ in range(cfg.n_layers)]
    build.reset_launch_counts()
    split = [pa_ops.paged_attention(qs[l], k_half, v_half, bts[l, 0],
                                    lengths) for l in range(cfg.n_layers)]
    split_launches = build.launch_counts()
    same = all(torch.equal(o, pa_ops.paged_attention_pool(
        qs[l], pool, bts[l, 0], lengths)) for l, o in enumerate(split))
    print(f"split-pool decode over the per-request pool, {cfg.n_layers} "
          f"layers' tables: launches {json.dumps(split_launches)}; equal to "
          f"paged_attention_pool bit for bit: {same}")
    if not same or split_launches.get("paged_attention", 0) == 0:
        raise AssertionError("split-pool decode: not launched, or differs "
                             "from the pool kernel")
    del split, qs, k_half, v_half, pool, kv

    # -- per layer, and whole prefills against float32 ---------------------
    def hook(kind, kv, tokens, tables, pos, n_real):
        # the 40-token prompt's mid-page chunk, and the one decode step
        if kind == "decode" or pos == 24:
            layer_check(torch, np, cfg, model, kind, kv, tokens, tables, pos,
                        n_real)
    run_ref = per_request_run(torch, np, cfg, model, dev, prompts, "ref",
                              decode_steps=1, hook=hook)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    logits = {"kernel": run["logits"], "ref": run_ref["logits"]}
    del run_ref
    logits["control"] = per_request_run(
        torch, np, cfg, model, dev, prompts, "ref",
        read_pps=max(PROMPTS) // 16)["logits"]
    logits["f32"] = per_request_run(torch, np, cfg32, model32, dev, prompts,
                                    "ref")["logits"]
    del model32
    dist = {k: [round((a - b).abs().max().item(), 4)
                for a, b in zip(v, logits["f32"])]
            for k, v in logits.items() if k != "f32"}
    limit = 2 * max(dist["ref"])
    print(f"per-request prefill, last-token logits max abs diff to f32 per "
          f"prompt {list(PROMPTS)}: {json.dumps(dist)}; limit {limit:.4g}")
    if not max(dist["kernel"]) <= limit < max(dist["control"]):
        raise AssertionError(
            f"per-request prefill: the kernel path's logits "
            f"({max(dist['kernel'])} from float32) must be within twice the "
            f"plain bf16 path's ({limit}), and the one-page-short control "
            f"({max(dist['control'])}) beyond it")

    # -- the same prompts through the fused step, side by side -------------
    kv = PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=4,
                           prefix_cache=False, device=dev)
    eng = ServingEngine(cfg, model, max_running=4, max_seq=1024,
                        scheduler="fcfs", step_tokens=256,
                        offload_tier=REMOTE, kv=kv, spec_chunk_ahead=False,
                        device=dev)
    reqs = [eng.submit(list(map(int, p)), DECODE_STEPS + 1)
            for p, _ in prompts]
    _sync(torch, dev)
    build.reset_launch_counts()
    step_s = []
    while (eng.waiting or eng.running) and len(step_s) < 1000:
        t = time.perf_counter()
        eng.step()
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t)
    fused = build.launch_counts()
    mixed = np.asarray(eng.metrics.prefill_tokens_trace) > 0
    step_s = np.asarray(step_s)
    print("fused (ServingEngine FCFS, same prompts, "
          f"{DECODE_STEPS + 1} tokens each): {len(step_s)} steps; "
          + _walls(np, "step wall with prompt chunks", step_s[mixed]) + "; "
          + _walls(np, "decode-only step wall", step_s[~mixed]))
    print(f"fused: kernel launches {json.dumps(fused, sort_keys=True)}")
    agree = [sum(a == b for a, b in zip(r.generated, t))
             for r, t in zip(reqs, run["tokens"])]
    print(f"greedy tokens, per-request vs fused, agreeing per prompt "
          f"{list(PROMPTS)}: {agree} of {DECODE_STEPS + 1} each "
          f"({sum(agree)} of {len(agree) * (DECODE_STEPS + 1)})")
    if not all(len(r.generated) == DECODE_STEPS + 1 for r in reqs):
        raise AssertionError("fused: not every request finished")
    return launches, split_launches


def make_runtime(cfg, dev, host_pages):
    """Phase 6's paged runtime: 16-token pages, 1,024-token contexts, four
    lanes; logical ids cover the LOCAL pool and every parked page (qwen: 24
    layers x up to 50 pages x 12 requests, plus the pool itself)."""
    from repro_torch.serving.kv_cache import PagedStateRuntime
    return PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=4,
                             host_pages=host_pages, n_logical=32768,
                             prefix_cache=False, device=dev)


def make_engine(np, cfg, model, dev, *, host_pages=1024, coordinator=None,
                want_remote_bytes=0.0, **engine_kw):
    """The 12-request CFS engine of phase 6 (a same-card REMOTE donor
    lease of 2 GiB, seeded prompts of 128-768 tokens, 32 new tokens each).
    With a ``coordinator`` the lease is the coordinator's grant of
    ``want_remote_bytes`` instead, polled for reclaims every step;
    ``engine_kw`` (faults, audit, admission, ...) go to the engine.
    Returns (engine, runtime, requests)."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.serving.engine import ServingEngine
    n_req, new_tokens = 12, 32
    kv = make_runtime(cfg, dev, host_pages)
    eng = ServingEngine(cfg, model, max_running=4, max_seq=1024,
                        scheduler="cfs", slice_tokens=8, step_tokens=256,
                        offload_tier=REMOTE, kv=kv, spec_chunk_ahead=False,
                        coordinator=coordinator,
                        want_remote_bytes=want_remote_bytes, respond_every=1,
                        device=dev, **engine_kw)
    if coordinator is None:
        eng.pager.add_remote_lease("donor0", 2 * 1024 ** 3)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(128, 769))
        reqs.append(eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                                          n))),
                               new_tokens, arrival=0.01 * i))
    return eng, kv, reqs


ENGINE_PROFILE_WARMUP = 8           # engine steps before the profiled ones


def profile_engine_steps(torch, eng):
    """One chunk step and one decode-only step of ``eng`` under
    ``torch.profiler`` (CPU and CUDA activities), after
    ``ENGINE_PROFILE_WARMUP`` plain steps: per step its wall, the device
    kernels launched, device busy ms, the idle share and the top-5 device
    kernels. A step of a kind already profiled is dropped. Returns {kind:
    record}, "not measured" where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, n = {}, 0
    while (eng.waiting or eng.running) and len(out) < 2 and n < 1000:
        n += 1
        torch.cuda.synchronize()
        if n <= ENGINE_PROFILE_WARMUP:
            eng.step()
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t)
        kind = ("chunk" if eng.metrics.prefill_tokens_trace[-1] > 0
                else "decode_only")
        if kind in out:
            continue
        device = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.elapsed_us() > 0]
        if not device:
            out[kind] = {"step_wall_ms": wall_us / 1e3,
                         "device": "not measured"}
            continue
        summary = device_time_summary(device, wall_us)
        out[kind] = {
            "step": n, "step_wall_ms": summary["step_wall_ms"],
            "kernels": sum(1 for name, _, _ in device
                           if not name.startswith(("Memcpy", "Memset"))),
            "device_events": summary["device_events"],
            "device_busy_ms": summary["device_busy_ms"],
            "idle_share": summary["idle_share"],
            "by_kind_ms": summary["by_kind_ms"],
            "top5_ms": summary["top10_ms"][:5]}
    return out


def phase_engine(torch, np, cfg, model, dev, need=(), profile=False):
    """``ServingEngine`` (CFS, a same-card REMOTE donor lease) serves 12
    seeded requests at full width. Every request finishes, CFS preempts and
    restores, each park/restore is one fabric message, a family whose
    context is all state planes moves exactly its whole state per leg, and
    every kernel in ``need`` launched (counts reset just before the run).
    With ``profile``, a second run of the same requests profiles one chunk
    step and one decode-only step (``profile_engine_steps``). Returns
    (launch counts, each request's generated tokens)."""
    from repro_torch.kernels import build

    eng, kv, reqs = make_engine(np, cfg, model, dev)
    n_req, new_tokens = len(reqs), reqs[0].max_new_tokens
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
    if all(p.kind == "state" for p in kv.planes.values()):
        state = kv.footprint_bytes(0)
        print(f"engine: {cfg.name} state per request {state:.0f} bytes; "
              f"bytes_fabric / (preemptions + restores) = "
              f"{meter.bytes_fabric / (m.preemptions + m.restores):.0f}")
        if meter.bytes_fabric != (m.preemptions + m.restores) * state:
            raise AssertionError(
                f"engine: bytes_fabric {meter.bytes_fabric} != "
                f"({m.preemptions} + {m.restores}) x {state:.0f}")
    if not all(launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"engine: {cfg.name}'s run never launched some "
                             f"of {list(need)}")
    tokens = [list(r.generated) for r in reqs]
    if profile:
        del eng, kv, reqs
        torch.cuda.empty_cache()
        eng, _, _ = make_engine(np, cfg, model, dev)
        print(f"engine profile: {json.dumps(profile_engine_steps(torch, eng))}")
    return launches, tokens


# -- the lease lifecycle: coordinator reclaim, lease shrink, donor loss -----
LEASE_BYTES = 2 * 1024 ** 3
# the host tier takes every page a reclaim or a shrink parks there: at most
# 8 parked requests x 24 layers x 50 pages (800 tokens / 16) = 9,600 pages
LIFECYCLE_HOST_PAGES = 10240


def cuda_span(torch, fn, *args, **kw):
    """One call of ``fn`` bracketed by CUDA events on the serving stream.
    Returns (its result, ms by the events, wall ms, gather and scatter
    launches during the call)."""
    from repro_torch.kernels import build
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    c0 = build.launch_counts()
    t = time.perf_counter()
    start.record()
    out = fn(*args, **kw)
    end.record()
    end.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    c1 = build.launch_counts()
    return out, start.elapsed_time(end), wall, {
        k: c1.get(k, 0) - c0.get(k, 0) for k in ("gather_pages",
                                                  "scatter_pages")}


def timed_moves(torch, np, kv, names, records):
    """Wrap the runtime's ``names`` (evict_remote, shrink_lease,
    fail_donor) on this instance: each call the engine makes is timed by
    ``cuda_span`` (the call's span on the card, the host leg's copies
    included) and records the meter's and the gather / scatter launch
    counts' deltas, and the live bytes of the pages that sat on the donor
    before the call."""
    from repro_torch.core.aqua_tensor import REMOTE
    meter = kv.meter
    keys = ("bytes_fabric", "bytes_host", "messages_fabric", "messages_host")

    def wrap(name, fn):
        def call(donor, *args):
            aq = kv.planes["kv"].aqua
            pt = aq.page_table
            on = ((pt[:, 0] == REMOTE) & (pt[:, 2] == aq._donors.index(donor))
                  if donor in aq.remote_pools else np.zeros(len(pt), bool))
            if name == "shrink_lease":      # only the reclaimed top slots
                lo = aq.remote_capacity[donor] - int(np.ceil(
                    args[0] * aq.remote_capacity[donor]))
                on &= pt[:, 1] >= lo
            live = float(aq.page_fill[on].sum()) * aq.page_bytes
            before = [getattr(meter, k) for k in keys]
            out, ms, wall, moved = cuda_span(torch, fn, donor, *args)
            records.append(dict(
                call=name, donor=donor, pages=int(on.sum()), live_bytes=live,
                ms=ms, wall_ms=wall,
                **{k: getattr(meter, k) - b for k, b in zip(keys, before)},
                **moved))
            return out
        return call

    for name in names:
        setattr(kv, name, wrap(name, getattr(kv, name)))


def lifecycle_run(torch, np, cfg, model, dev, card, label, *, offers,
                  want, faults=None, audit=False, reclaim_at=None,
                  watch_remote=False):
    """One coordinator-granted engine run of ``make_engine``'s requests on
    the ``LIFECYCLE_HOST_PAGES`` host tier; ``reclaim_at``: the donor asks
    for its memory back after that many steps. Prints wall, steps,
    preemptions and restores, per-tier messages and bytes and each timed
    move. Returns a record."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.kernels import build
    coord = Coordinator(strict_pairing=False)
    for donor, nbytes in offers:
        coord.offer(donor, nbytes)
    eng, kv, reqs = make_engine(np, cfg, model, dev,
                                host_pages=LIFECYCLE_HOST_PAGES,
                                coordinator=coord, want_remote_bytes=want,
                                faults=faults, audit=audit)
    moves: list = []
    timed_moves(torch, np, kv, ("evict_remote", "shrink_lease",
                                "fail_donor"), moves)
    plane = kv.planes["kv"].aqua
    first_remote = None
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t = time.perf_counter()
    while (eng.waiting or eng.running) and eng.metrics.steps < 5000:
        if reclaim_at is not None and eng.metrics.steps == reclaim_at:
            coord.request_reclaim("donor0")
        eng.step()
        if (watch_remote and first_remote is None
                and (plane.page_table[:, 0] == REMOTE).any()):
            first_remote = eng.metrics.steps
    eng.run(0)                      # the final respond of ServingEngine.run
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = build.launch_counts()
    m, meter = eng.metrics, kv.meter
    print(f"lease {label}: {m.steps} steps, {wall:.3f} s wall, preemptions "
          f"{m.preemptions} restores {m.restores}; fabric "
          f"{meter.messages_fabric} messages {meter.bytes_fabric:.0f} bytes, "
          f"host {meter.messages_host} messages {meter.bytes_host:.0f} bytes"
          f"; retries {meter.retries_fabric + meter.retries_host}; tiers "
          f"{json.dumps(kv.stats()['tiers'], sort_keys=True)}; gather "
          f"{launches.get('gather_pages', 0)} scatter "
          f"{launches.get('scatter_pages', 0)} launches; on {card}")
    for mv in moves:
        verb = {"evict_remote": "evacuated", "shrink_lease": "migrated",
                "fail_donor": "lost"}[mv["call"]]
        print(f"lease {label}: {mv['call']}({mv['donor']}) {verb} "
              f"{mv['pages']} pages, {mv['live_bytes']:.0f} live bytes: "
              f"{mv['ms']:.4f} ms by CUDA events ({mv['wall_ms']:.3f} ms "
              f"wall); meter +{mv['messages_fabric']} fabric messages "
              f"+{mv['bytes_fabric']:.0f} bytes, +{mv['messages_host']} "
              f"host messages +{mv['bytes_host']:.0f} bytes; launches "
              f"+{mv['gather_pages']} gather +{mv['scatter_pages']} "
              f"scatter; on {card}")
    if len(eng.finished) != len(reqs) or not all(
            len(r.generated) == r.max_new_tokens
            and all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in reqs):
        raise AssertionError(f"lease {label}: not every request finished "
                             "with its tokens in the vocab")
    if not (launches.get("gather_pages", 0) > 0
            and launches.get("scatter_pages", 0) > 0):
        raise AssertionError(f"lease {label}: rows 6 and 7 never launched")
    return dict(tokens=[list(r.generated) for r in reqs], eng=eng, kv=kv,
                coord=coord, moves=moves, first_remote=first_remote)


def phase_lease_lifecycle(torch, np, cfg, model, dev, card):
    """Phase 6b: the AQUA lease lifecycle on the engine of phase 6, its
    lease granted by a ``Coordinator`` (donor0 offers 2 GiB, the engine
    wants 2 GiB, reclaims polled every step) and a host tier that takes
    every parked page. Four runs of the same 12 requests: a baseline; a
    coordinator reclaim after the first step that leaves pages on the
    donor (evacuated to HOST at the next iteration boundary); a lease
    shrink at that step (a second donor takes donor0's pages, so the
    migration moves them device to device); a donor loss at that step
    (victims recomputed from their prompts, the auditor after every
    step). The reclaim and the shrink must give the baseline's tokens."""
    from repro_torch.core.faults import FaultEvent, FaultInjector
    offer = [("donor0", LEASE_BYTES)]
    base = lifecycle_run(torch, np, cfg, model, dev, card, "baseline",
                         offers=offer, want=LEASE_BYTES, watch_remote=True)
    hit = base["first_remote"]
    if hit is None:
        raise AssertionError("lease baseline: CFS never parked on the donor")
    print(f"lease: the first step after which pages sit on donor0: {hit}")
    steps = {"baseline": base.pop("eng").metrics.steps}
    del base["kv"]

    rec = lifecycle_run(torch, np, cfg, model, dev, card, "reclaim",
                        offers=offer, want=LEASE_BYTES, reclaim_at=hit)
    ev = [mv for mv in rec["moves"] if mv["call"] == "evict_remote"]
    if not rec["coord"].reclaim_status("donor0"):
        raise AssertionError("lease reclaim: reclaim_status is false")
    if rec["kv"].stats()["tiers"]["remote"] != 0 or len(ev) != 1:
        raise AssertionError(f"lease reclaim: remote tier "
                             f"{rec['kv'].stats()['tiers']['remote']}, "
                             f"{len(ev)} evacuations")
    ev = ev[0]
    # a leg that touches REMOTE is a fabric message (the reference's
    # TransferMeter rule), also when it lands on HOST
    if not (ev["pages"] > 0 and ev["messages_fabric"] == 1
            and ev["bytes_fabric"] == ev["live_bytes"]
            and ev["messages_host"] == 0
            and ev["gather_pages"] == ev["messages_fabric"]
            and ev["scatter_pages"] == 0):
        raise AssertionError(f"lease reclaim: evacuation not one metered "
                             f"leg of the donor's live bytes: {ev}")
    if rec["tokens"] != base["tokens"]:
        raise AssertionError("lease reclaim: tokens differ from the "
                             "baseline's (the move changed page bits)")
    steps["reclaim"] = rec.pop("eng").metrics.steps
    del rec
    torch.cuda.empty_cache()

    fi = FaultInjector(seed=0, events=[FaultEvent(
        kind="lease_shrink", donor="donor0", frac=1.0, at_step=hit)])
    shr = lifecycle_run(torch, np, cfg, model, dev, card, "shrink",
                        offers=offer + [("donor1", LEASE_BYTES)],
                        want=2 * LEASE_BYTES, faults=fi)
    m = shr["eng"].metrics
    mv = [x for x in shr["moves"] if x["call"] == "shrink_lease"]
    if not (m.lease_shrinks == 1 and m.migrated_pages > 0
            and m.recomputes == 0 and len(mv) == 1):
        raise AssertionError(f"lease shrink: shrinks {m.lease_shrinks} "
                             f"migrated {m.migrated_pages} recomputes "
                             f"{m.recomputes}")
    mv = mv[0]
    # one leg, donor0 -> donor1 through rows 6 and 7; a move within one tier
    # is not priced (the reference's TransferMeter rule), so the meter stays
    if not (mv["pages"] == m.migrated_pages and mv["gather_pages"] == 1
            and mv["scatter_pages"] == 1 and mv["messages_fabric"] == 0
            and mv["messages_host"] == 0 and mv["bytes_fabric"] == 0):
        raise AssertionError(f"lease shrink: migration not one "
                             f"device-to-device leg: {mv}")
    if shr["tokens"] != base["tokens"]:
        raise AssertionError("lease shrink: tokens differ from the "
                             "baseline's (the migration changed page bits)")
    steps["shrink"] = m.steps
    del shr
    torch.cuda.empty_cache()

    fi = FaultInjector(seed=0, events=[FaultEvent(
        kind="donor_loss", donor="donor0", at_step=hit)])
    loss = lifecycle_run(torch, np, cfg, model, dev, card, "donor loss",
                         offers=offer, want=LEASE_BYTES, faults=fi,
                         audit=True)
    eng = loss["eng"]
    m = eng.metrics
    if not (m.donor_losses == 1 and m.recomputes > 0):
        raise AssertionError(f"lease donor loss: losses {m.donor_losses} "
                             f"recomputes {m.recomputes}")
    if eng.auditor.audits != m.steps:
        raise AssertionError(f"lease donor loss: {eng.auditor.audits} "
                             f"audits in {m.steps} steps")
    if "lost" in loss["kv"].stats()["tiers"]:
        raise AssertionError("lease donor loss: LOST pages left")
    agree = sum(a == b for a, b in zip(loss["tokens"], base["tokens"]))
    print(f"lease donor loss: {m.recomputes} recomputes (rids "
          f"{m.recovered_rids}), {m.steps} steps audited; {agree} of "
          f"{len(base['tokens'])} requests' tokens equal the baseline's "
          f"(reported, not asserted: recomputed rows run in other batch "
          f"compositions)")
    steps["donor_loss"] = m.steps
    del loss, eng
    torch.cuda.empty_cache()
    return steps


# -- admission and the request lifecycle --------------------------------------
# the host tier takes every page a drain parks and every page a restore lands
# there: at most 12 requests x 24 layers x 50 pages = 14,400 kv pages of 64 KiB
REQUEST_HOST_PAGES = 16384
DRAIN_AFTER = 4                     # steps from the cancels to the drain
SNAPSHOT_AFTER = 6                  # steps from the resume to the snapshot


def drive(eng, made_at, shapes, logits=None, max_steps=5000):
    """Step ``eng`` to its end (or ``max_steps`` more steps), recording in
    ``made_at[rid]`` the step that produced each generated token (None for
    tokens made before the first drive), in ``shapes[step]`` the packed
    token batch (R, Tc) of each fused call and, given a ``logits`` dict, in
    ``logits[(rid, position)]`` the float32 logits row that produced each
    token (on the host; the rows' rids are the ones the engine builds its
    block tables for)."""
    from repro_torch.models import api
    serve = api.serve_step_paged
    kv = eng.kv
    tables = kv.block_tables
    row_rids: list = []
    rows: dict = {}

    def recorded_tables(lane_rids, *args, **kw):
        row_rids[:] = list(lane_rids)
        return tables(lane_rids, *args, **kw)

    def recorded(params, cfg, tokens, *args, **kw):
        shapes[eng.metrics.steps] = tuple(tokens.shape)
        out = serve(params, cfg, tokens, *args, **kw)
        if logits is not None:
            idx = [i for i, rid in enumerate(row_rids) if rid is not None]
            host = out[0][idx].float().cpu()
            rows.clear()
            rows.update({row_rids[i]: host[j] for j, i in enumerate(idx)})
        return out

    def stamp(step):
        for r in eng.running + eng.waiting + eng.finished:
            got = made_at.setdefault(r.rid, [])
            for pos in range(len(got), len(r.generated)):
                got.append(step)
                if logits is not None and step is not None:
                    logits[(r.rid, pos)] = rows[r.rid]

    stamp(None)                     # tokens made before this drive
    api.serve_step_paged = recorded
    kv.block_tables = recorded_tables
    try:
        n = 0
        while (eng.waiting or eng.running) and n < max_steps:
            step = eng.metrics.steps
            eng.step()
            n += 1
            stamp(step)
    finally:
        api.serve_step_paged = serve
        del kv.block_tables


def restored_agreement(inflight, at_snapshot, runs):
    """Hold the restored run against the original for every request in
    flight at the snapshot, from its first token made after the snapshot to
    its first parting token (the contexts are equal up to there): the two
    logits rows of a token whose steps packed the same (R, Tc) within 2% of
    the original's norm (phase 5's limit), the others reported. Raises when
    a same-shape row is beyond the limit or the tokens part where the
    shapes agree. Returns a record."""
    (orig, made, shapes, logits), (rest, made2, shapes2, logits2) = runs
    rec = dict(tokens=0, agree=0, same_shape=0, bit_identical=0,
               same_rel=0.0, other_shape=0, other_rel=0.0, parting=None)
    for rid in inflight:
        a, b = orig[rid], rest[rid]
        rec["tokens"] += len(a)
        rec["agree"] += sum(x == y for x, y in zip(a, b))
        part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        last = part if part is not None else min(len(a), len(b)) - 1
        for pos in range(at_snapshot[rid], last + 1):
            s1, s2 = made[rid][pos], made2[rid][pos]
            l1, l2 = logits[(rid, pos)], logits2[(rid, pos)]
            rel = float((l1 - l2).norm() / l1.norm())
            if shapes[s1] == shapes2[s2]:
                rec["same_shape"] += 1
                rec["bit_identical"] += int(bool((l1 == l2).all()))
                rec["same_rel"] = max(rec["same_rel"], rel)
                if rel > LAYER_REL_LIMIT:
                    raise AssertionError(
                        f"restore: rid {rid} position {pos}: logits "
                        f"{rel:.4f} apart at steps {s1}/{s2} of one packed "
                        f"shape {shapes[s1]} (limit {LAYER_REL_LIMIT})")
            else:
                rec["other_shape"] += 1
                rec["other_rel"] = max(rec["other_rel"], rel)
        if part is not None and rec["parting"] is None:
            s1, s2 = made[rid][part], made2[rid][part]
            rec["parting"] = dict(rid=rid, position=part, steps=(s1, s2),
                                  shapes=(shapes.get(s1), shapes2.get(s2)))
            print(f"restore: tokens part at rid {rid} position {part}: "
                  f"original step {s1} packed {shapes.get(s1)}, restored "
                  f"step {s2} packed {shapes2.get(s2)}")
            if shapes.get(s1) == shapes2.get(s2):
                raise AssertionError(
                    f"restore: rid {rid} parts at position {part} where "
                    f"both runs packed {shapes.get(s1)}")
    return rec


def admission_run(torch, np, cfg, model, dev, card, base_tokens):
    """Phase 6c, part 1: phase 6's requests under admission, the auditor
    after every step and the watchdog at 16 steps."""
    eng, _, reqs = make_engine(np, cfg, model, dev,
                               host_pages=REQUEST_HOST_PAGES, audit=True,
                               admission=True, watchdog_steps=16)
    torch.cuda.synchronize()
    t = time.perf_counter()
    while (eng.waiting or eng.running) and eng.metrics.steps < 5000:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    m = eng.metrics
    censored = m.submitted - len(m.ttft)
    first = np.asarray([r.ttft_step for r in reqs], np.float64)
    same = sum(list(r.generated) == b for r, b in zip(reqs, base_tokens))
    tokens = sum(x == y for r, b in zip(reqs, base_tokens)
                 for x, y in zip(r.generated, b))
    print(f"admission: {m.steps} steps, {wall:.3f} s wall; occupancy max "
          f"{max(m.occupancy_trace):.4f}; deferrals {m.admission_deferrals}"
          f"; queue depth max {max(m.queue_depth_trace)}; watchdog trips "
          f"{m.watchdog_trips}; slo_at_risk {eng.admission.slo_at_risk}; "
          f"TTFT p50 {m.ttft_quantile(0.5, censored=censored):.6f} s p99 "
          f"{m.ttft_quantile(0.99, censored=censored):.6f} s (analytic "
          f"clock, arrivals 0.01 s apart); first-token step p50 "
          f"{np.percentile(first, 50):.1f} p99 {np.percentile(first, 99):.1f}"
          f"; preemptions {m.preemptions}; {same} of {len(reqs)} "
          f"requests and {tokens} of {sum(map(len, base_tokens))} tokens "
          f"equal phase 6's (reported, not asserted: admission changes the "
          f"schedule); on {card}")
    if max(m.occupancy_trace) > 1.0 + 1e-9:
        raise AssertionError(f"admission: occupancy {max(m.occupancy_trace)}"
                             " above the page budget")
    if len(eng.finished) != len(reqs) or not all(
            r.terminal == "finished" and len(r.generated) == r.max_new_tokens
            and all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in reqs):
        raise AssertionError("admission: not every request finished with "
                             "its tokens in the vocab")
    if eng.auditor.audits != m.steps:
        raise AssertionError(f"admission: {eng.auditor.audits} audits in "
                             f"{m.steps} steps")
    return m.steps


def snapshot_split(torch, np, kv, snap, total_ms, card):
    """The snapshot's ``kv`` payload read again on the same pages, in its
    two halves: ``AquaTensor.read`` (LOCAL and REMOTE pages gathered on the
    card, HOST pages copied up, reassembled in order) and the copy of the
    result to host memory; the rest of the snapshot's span is bookkeeping
    in Python. Returns the re-read's gather launches (a measurement, not
    the path)."""
    from repro_torch.core.aqua_tensor import HOST, LOCAL, REMOTE
    aq = kv.planes["kv"].aqua
    lps = snap["kv"]["planes"]["kv"]["lps"]
    tiers = aq.page_table[np.asarray(lps, np.int64), 0]
    data, read_ms, _, moved = cuda_span(torch, aq.read, lps)
    _, copy_ms, _, _ = cuda_span(torch, data.cpu)
    print(f"lifecycle: snapshot split: read {read_ms:.4f} ms (LOCAL "
          f"{int((tiers == LOCAL).sum())}, REMOTE {int((tiers == REMOTE).sum())}"
          f", HOST {int((tiers == HOST).sum())} pages; "
          f"+{moved['gather_pages']} gather), to host {copy_ms:.4f} ms, the "
          f"rest {total_ms - read_ms - copy_ms:.4f} ms; on {card}")
    return moved


def cancel_every_state(eng, kv, auditor):
    """Cancel a waiting, a prefilling, a decoding and a parked request (the
    last with its pages on donor0) at the first step that has all four;
    each must leave no page and no slot, ``output`` must raise and the
    auditor stay clean. Returns [(state, rid)]."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.core.errors import CancelledError
    plane = kv.planes["kv"]

    def on_donor(r):
        lps = plane.flat(r.rid)
        return bool(r.parked) and len(lps) > 0 and bool(
            (plane.aqua.page_table[lps, 0] == REMOTE).all())

    picks = None
    while (eng.waiting or eng.running) and eng.metrics.steps < 5000:
        eng.step()
        if picks is None and not any(on_donor(r) for r in eng.waiting):
            continue
        picks = [("waiting", next((r for r in eng.waiting
                                   if r.lifecycle == "waiting"), None)),
                 ("prefilling", next((r for r in eng.running
                                      if r.lifecycle == "prefilling"), None)),
                 ("decoding", next((r for r in eng.running
                                    if r.lifecycle == "running"), None)),
                 ("parked", next((r for r in eng.waiting if on_donor(r)),
                                 None))]
        if all(r is not None for _, r in picks):
            break
    if picks is None or not all(r is not None for _, r in picks):
        raise AssertionError(f"lifecycle: no step with a waiting, a "
                             f"prefilling, a decoding and a parked request: "
                             f"{picks}")
    print(f"lifecycle: step {eng.metrics.steps}: cancelling "
          + ", ".join(f"{k} rid {r.rid}" for k, r in picks))
    for kind, r in picks:
        if not eng.cancel(r.rid):
            raise AssertionError(f"lifecycle: cancel of {kind} rid {r.rid} "
                                 "was a no-op")
        held = [n for n, p in kv.planes.items() if r.rid in p.pages]
        if held or r.slot is not None or r.terminal != "cancelled":
            raise AssertionError(f"lifecycle: cancelled {kind} rid {r.rid} "
                                 f"holds pages in {held}, slot {r.slot}, "
                                 f"terminal {r.terminal}")
        try:
            eng.output(r.rid)
        except CancelledError:
            pass
        else:
            raise AssertionError(f"lifecycle: output of cancelled rid "
                                 f"{r.rid} did not raise CancelledError")
        bad = auditor.check(kv, engine=eng)
        if bad:
            raise AssertionError(f"lifecycle: auditor after cancelling "
                                 f"{kind} rid {r.rid}: {bad}")
    return [(k, r.rid) for k, r in picks]


def lifecycle_moves(torch, np, cfg, model, dev, card):
    """Phase 6c, part 2: cancels, a drain and resume, a snapshot mid-stream
    and its restore into a fresh runtime, on phase 6's requests without
    admission. Returns the launches the snapshot's timing re-read made."""
    from repro_torch.core.aqua_tensor import HOST, LOCAL
    from repro_torch.core.faults import InvariantAuditor
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    eng, kv, reqs = make_engine(np, cfg, model, dev,
                                host_pages=REQUEST_HOST_PAGES)
    auditor = InvariantAuditor()
    cancelled = cancel_every_state(eng, kv, auditor)

    made_at: dict = {}
    shapes: dict = {}
    drive(eng, made_at, shapes, max_steps=DRAIN_AFTER)
    pt = kv.planes["kv"].aqua.page_table
    host0, meter0 = int((pt[:, 0] == HOST).sum()), kv.meter.bytes_host
    n, ms, wall, moved = cuda_span(torch, eng.drain)
    local = pt[:, 0] == LOCAL
    print(f"lifecycle: drain at step {eng.metrics.steps} parked {n} requests"
          f", {int((pt[:, 0] == HOST).sum()) - host0} pages to HOST, "
          f"{kv.meter.bytes_host - meter0:.0f} live bytes: {ms:.4f} ms by "
          f"CUDA events ({wall:.3f} ms wall); launches +{moved['gather_pages']}"
          f" gather +{moved['scatter_pages']} scatter; on {card}")
    scratch = kv.planes["kv"].scratch_lp
    if (eng.running or kv._active or any(r.slot is not None
                                         for r in eng.waiting)
            or sorted(eng._free_slots) != list(range(eng.max_running))
            or int(local.sum()) != 1 or not local[scratch]):
        raise AssertionError(f"lifecycle: drain left running "
                             f"{[r.rid for r in eng.running]}, pins "
                             f"{sorted(kv._active)}, {int(local.sum())} "
                             f"LOCAL pages")
    if n and moved["gather_pages"] == 0:
        raise AssertionError("lifecycle: the drain's parks launched no "
                             "gather")
    eng.step()                      # a draining engine admits nothing
    if eng.running:
        raise AssertionError("lifecycle: a draining engine admitted work")
    eng.resume()
    drive(eng, made_at, shapes, max_steps=SNAPSHOT_AFTER)
    snap, ms, wall, moved = cuda_span(torch, eng.snapshot)
    planes = snap["kv"]["planes"].values()
    pages = sum(len(p["lps"]) for p in planes)
    nbytes = sum(p["data"].nbytes for p in planes if p["data"] is not None)
    inflight = sorted(d["rid"] for d in snap["running"] + snap["waiting"])
    print(f"lifecycle: snapshot at step {eng.metrics.steps}: {pages} pages, "
          f"{nbytes} payload bytes on the host, {len(inflight)} requests in "
          f"flight: {ms:.4f} ms by CUDA events ({wall:.3f} ms wall); "
          f"launches +{moved['gather_pages']} gather "
          f"+{moved['scatter_pages']} scatter; on {card}")
    if not all(isinstance(p["data"], np.ndarray) for p in planes) \
            or not pages or not inflight:
        raise AssertionError("lifecycle: the snapshot holds no host payload "
                             "or nothing in flight")
    measured = snapshot_split(torch, np, kv, snap, ms, card)
    at_snapshot = {d["rid"]: len(d["generated"])
                   for d in snap["running"] + snap["waiting"]}
    logits: dict = {}
    drive(eng, made_at, shapes, logits)
    original = {r.rid: list(r.generated) for r in reqs}
    steps = eng.metrics.steps
    if not all(r.done for r in reqs if r.terminal != "cancelled"):
        raise AssertionError("lifecycle: the original run did not finish")
    del eng, kv, reqs
    torch.cuda.empty_cache()

    spare = make_runtime(cfg, dev, REQUEST_HOST_PAGES)
    _, alone, _, _ = cuda_span(torch, spare.restore_state, snap["kv"])
    print(f"lifecycle: restore_state alone, on another fresh runtime: "
          f"{alone:.4f} ms by CUDA events; on {card}")
    del spare
    torch.cuda.empty_cache()
    kv2 = make_runtime(cfg, dev, REQUEST_HOST_PAGES)
    eng2, ms, wall, moved = cuda_span(torch, ServingEngine.restore, cfg,
                                      model, snap, device=dev, kv=kv2)
    eng2.pager.add_remote_lease("donor0", LEASE_BYTES)
    pt = kv2.planes["kv"].aqua.page_table
    print(f"lifecycle: restore of {pages} pages: {ms:.4f} ms by CUDA events "
          f"({wall:.3f} ms wall), {int((pt[:, 0] == HOST).sum())} pages on "
          f"HOST; launches +{moved['gather_pages']} gather "
          f"+{moved['scatter_pages']} scatter; on {card}")
    bad = InvariantAuditor().check(kv2, engine=eng2)
    if bad:
        raise AssertionError(f"lifecycle: auditor after restore: {bad}")
    made2: dict = {}
    shapes2: dict = {}
    logits2: dict = {}
    c0 = build.launch_counts()
    t = time.perf_counter()
    drive(eng2, made2, shapes2, logits2)
    torch.cuda.synchronize()
    c1 = build.launch_counts()
    restored = {r.rid: list(r.generated)
                for r in eng2.finished + eng2.waiting + eng2.running}
    if not all(len(restored[rid]) == len(original[rid]) for rid in inflight):
        raise AssertionError("lifecycle: the restored run did not finish "
                             "every request in flight at the snapshot")
    print(f"lifecycle: restored run {eng2.metrics.steps - snap['metrics']['steps']}"
          f" steps (the original: {steps - snap['metrics']['steps']}), "
          f"{time.perf_counter() - t:.3f} s wall; launches "
          f"+{c1.get('gather_pages', 0) - c0.get('gather_pages', 0)} gather "
          f"+{c1.get('scatter_pages', 0) - c0.get('scatter_pages', 0)} "
          f"scatter; cancelled {eng2.metrics.cancelled}, drained "
          f"{eng2.metrics.drained}")
    rec = restored_agreement(inflight, at_snapshot, (
        (original, made_at, shapes, logits),
        (restored, made2, shapes2, logits2)))
    print(f"lifecycle: restore agreement: {json.dumps(rec)} (cancelled "
          f"before the snapshot: {cancelled})")
    if rec["parting"] is None:
        print(f"lifecycle: the {len(inflight)} requests in flight at the "
              f"snapshot finish with the original's tokens after restore")
    else:
        print(f"lifecycle: restored tokens part from the original's where "
              f"the packed shapes differ: {rec['agree']} of {rec['tokens']} "
              f"tokens agree; every logits row of a step packed alike is "
              f"within {LAYER_REL_LIMIT}")
    return measured


def phase_request_lifecycle(torch, np, cfg, model, dev, card, base_tokens):
    """Phase 6c: admission and the request lifecycle on phase 6's engine.
    Returns the gather/scatter/attention launches of the phase."""
    from repro_torch.kernels import build
    build.reset_launch_counts()
    admission_run(torch, np, cfg, model, dev, card, base_tokens)
    torch.cuda.empty_cache()
    measured = lifecycle_moves(torch, np, cfg, model, dev, card)
    torch.cuda.empty_cache()
    counts = build.launch_counts()
    for k, n in measured.items():
        counts[k] -= n
    return counts


# -- rwkv6-3b: the RWKV-6 family's paths ------------------------------------
F32_FLOPS = 67e12                   # H100 SXM datasheet, outside tensor cores
# exponentials: 16 results per clock per SM (CUDA programming guide,
# compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
WKV_SRC = "src/repro_torch/csrc/wkv6.cu"
# (B, T) of the engine's WKV launches at full width with max_running 4 and
# step_tokens 256: the chunk region (8 rows of a 256 bucket), the decode
# region, and a short bucket whose only chunk is short
WKV_SHAPES = {"chunk": (8, 256), "decode": (4, 1), "short_bucket": (8, 24)}
# the reference's test_wkv6_sweep limits (rtol, atol): bf16 y, f32 state
WKV_LIMITS = ((2e-2, 5e-2), (1e-3, 5e-4))
WKV_DECAYS = (0.1, 5.0)             # weak .. the sweep's strong-decay stress


def wkv_bound(B, T, H, hd, io_bytes):
    """Least time of one WKV call: the bytes it must move (r, k, v, y in
    the compute dtype, w and the state in and out in float32, u) over the
    memory rate, against the chunked algorithm's float32 operations over
    67 TFLOP/s and its exponentials (the causal pairs of each chunk) over
    the special-function units' rate. Returns (ms, bound_by, parts)."""
    nbytes = B * T * H * hd * (4 * io_bytes + 4) + 2 * B * H * hd * hd * 4 \
        + H * hd * 4
    flops = exps = 0
    for t0 in range(0, T, 32):
        c = min(32, T - t0)
        pairs = c * (c - 1) // 2
        flops += (7 * c * hd + 4 * pairs * hd + 4 * c * hd * hd
                  + 2 * (pairs + c) * hd + hd * hd)
        exps += 2 * c * hd + pairs * hd + hd
    flops, exps = flops * B * H, exps * B * H
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32": flops / F32_FLOPS * 1e3, "exp": exps / SFU_PER_S * 1e3}
    ms = max(parts.values())
    return ms, "bytes" if parts["bytes"] >= ms else "operations", parts


def wkv_inputs(torch, g, B, T, H, hd, wmax, dev):
    """The sweep's distributions: r, k, v standard normal in bf16, w
    uniform in [-wmax, -1e-3], u standard normal, state 0.1 x normal."""
    r, k, v = (torch.randn((B, T, H, hd), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    w = -(torch.rand((B, T, H, hd), generator=g, device=dev)
          * (wmax - 1e-3) + 1e-3)
    u = torch.randn((H, hd), generator=g, device=dev)
    s0 = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.1
    return r, k, v, w, u, s0


def limit_ratio(a, b, rtol, atol):
    """Largest |a - b| / (atol + rtol |b|): within the limit when <= 1."""
    b = b.float()
    return ((a.float() - b).abs() / (atol + rtol * b.abs())).max().item()


def wkv_ratio(got, want):
    """``limit_ratio`` of y and of the state, at their limits; the larger."""
    return max(limit_ratio(a, b, *lim)
               for a, b, lim in zip(got, want, WKV_LIMITS))


def phase_wkv_kernel(torch, np, cfg, report):
    """``wkv6`` against its plain versions at the engine's shapes (the
    float32 scan ``wkv6_ref``, and ``wkv6_plain``, which takes the chunked
    form at T 256), weak and strong decays; a control with one lane's
    incoming state zeroed must land beyond the limits. Device times as for
    the attention kernels."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    print_wkv_resources(wkv_ops)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    cases = {}
    for name, (B, T) in WKV_SHAPES.items():
        ratios, controls, errs = [], [], []
        for wmax in WKV_DECAYS:
            args = wkv_inputs(torch, g, B, T, H, hd, wmax, dev)
            got = wkv_ops.wkv6(*args)
            s0c = args[5].clone()
            s0c[0] = 0.0
            ctrl = wkv_ops.wkv6(*args[:5], s0c)
            scan = wkv_ref.wkv6_ref(*args)
            plain = wkv_ref.wkv6_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"wkv6 {name}: not finite")
            ratios += [wkv_ratio(got, scan), wkv_ratio(got, plain)]
            controls.append(wkv_ratio(ctrl, scan))
            errs.append((got[0].float() - scan[0].float()).abs().max().item())
            del got, ctrl, scan, plain
        # the plain chunked form and scan issue ~100-200 launches per call
        # at T > 1: two calls stay inside the launch queue
        ms, plain_ms = interleaved(lambda: wkv_ref.wkv6_plain(*args),
                                   lambda: wkv_ops.wkv6(*args),
                                   20 if T > 1 else 100,
                                   plain_iters=2 if T > 1 else 20)
        b, by, parts = wkv_bound(B, T, H, hd, 2)
        cases[name] = dict(
            shape=f"B={B} T={T} H={H} hd={hd} (bf16 r/k/v/y)",
            max_abs_err=max(errs), limit_ratio=max(ratios),
            control_ratio=min(controls), tolerance=(
                "y rtol 2e-2 atol 5e-2, state rtol 1e-3 atol 5e-4"),
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            bound_parts_ms=parts, library_ms=None)
        print(f"kernel wkv6 {cases[name]['shape']}: error/limit "
              f"{max(ratios):.3g} (vs scan and plain, decays up to "
              f"{max(WKV_DECAYS)}); control (one lane's state zeroed) "
              f"{min(controls):.3g}; max abs y err {max(errs):.3g}; kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b * 1e3:.3f} us "
              f"({by}: bytes {parts['bytes'] * 1e3:.2f}, f32 "
              f"{parts['f32'] * 1e3:.2f}, exp {parts['exp'] * 1e3:.2f} us)")
        if not max(ratios) <= 1.0 < min(controls):
            raise AssertionError(
                f"wkv6 {name}: error/limit {max(ratios)} must be <= 1 and "
                f"the control's {min(controls)} above it")
        del args
    report.append(dict(
        name="wkv6", route="cuda", source=WKV_SRC,
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:81",
        **{**cases["chunk"], "max_abs_err": max(c["max_abs_err"]
                                                for c in cases.values())},
        decode=cases["decode"], short_bucket=cases["short_bucket"]))


def rwkv_state_pools(torch, np, cfg, dev, rows, seed):
    """Random full-width state pools (wkv float32 with unit entries, shift
    in the compute dtype) with one slot per (layer, real row); slot 0 is
    scratch. Returns (pools, tables (n_layers, 1, R))."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    hd = cfg.ssm.rwkv_head_dim
    L, R = cfg.n_layers, len(rows)
    P = 1 + L * int(sum(rows))
    pools = {"wkv": torch.randn((P, cfg.d_model // hd, hd, hd), generator=g,
                                device=dev),
             "shift": torch.randn((P, 2, cfg.d_model), generator=g,
                                  device=dev).to(cfg.torch_compute_dtype())}
    bt = np.zeros((L, 1, R), np.int32)
    free = rng.permutation(np.arange(1, P)).astype(np.int32)
    for l in range(L):
        for r in range(R):
            if rows[r]:
                bt[l, 0, r], free = free[0], free[1:]
    return pools, bt


def rwkv_time_mix_regions(torch, cfg, blk, x, pools, ws, nr_dev, n_dec,
                          impl):
    """Layer ``blk``'s ``rwkv_time_mix`` on the packed step's two regions
    (decode lanes' first column, chunk rows with their ``n_real``), reading
    the lanes' incoming wkv and shift pages at slots ``ws`` (the pools are
    not written). -> (output per region, new wkv state per region)."""
    from repro_torch.layers.core import rms_norm
    from repro_torch.layers.rwkv6 import rwkv_time_mix
    h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
    shift, wkv = pools["shift"][ws.long()], pools["wkv"][ws.long()]
    out_d, _, s_d = rwkv_time_mix(blk.mix.tm, cfg, h[:n_dec, :1],
                                  shift[:n_dec, 0], wkv[:n_dec], impl=impl)
    out_c, _, s_c = rwkv_time_mix(blk.mix.tm, cfg, h[n_dec:],
                                  shift[n_dec:, 0], wkv[n_dec:], impl=impl,
                                  n_real=nr_dev[n_dec:])
    return (out_d, out_c), torch.cat([s_d, s_c])


def phase_rwkv_layer_step(torch, np, cfg, model, model32, dev):
    """One full-width rwkv6-3b packed step (4 decode lanes, a 200-token and
    a 56-token chunk row, 6 pad rows; R 12, Tc 256), checked two ways.

    Per layer, on the same input and pools: the time-mix of both regions
    through the kernel and through the plain versions. Each real token's
    output may differ by at most ``LAYER_REL_LIMIT`` relative to that
    token's output, and each real row's new wkv state stays within the WKV
    limits; a control (the plain version with decode lane 0's incoming wkv
    page zeroed) must land beyond both. The whole sub-layer
    (``lm.rwkv_mixed_paged``) then runs both ways: its shift pages within
    ``LAYER_REL_LIMIT`` of the pages' largest entry (scratch excluded: idle
    and pad rows all write it); the plain run carries the layer on.

    Whole step: logits of the kernel path no further from a float32 step
    than twice the plain bf16 path's, the control (lane 0's wkv pages zeroed
    in every layer) further."""
    from repro_torch.layers.core import embed
    from repro_torch.models import api, lm
    q_starts, n_reals, n_dec, Tc = main_path_plan()
    R = len(q_starts)
    pools, bt = rwkv_state_pools(torch, np, cfg, dev, n_reals > 0, 6)
    tables = {"wkv": bt, "shift": bt}
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    real = np.nonzero(n_reals > 0)[0]
    compared = torch.as_tensor(np.arange(Tc)[None]
                               < n_reals[n_dec:, None]).to(dev)
    keep = torch.ones(pools["wkv"].shape[0], dtype=torch.bool, device=dev)
    keep[0] = False
    nr_dev = torch.as_tensor(n_reals.astype(np.int64)).to(dev)
    bt_dev = torch.as_tensor(bt).to(dev)
    x = embed(model.embed, cfg, torch.as_tensor(tokens).to(dev))
    p_ref = {k: v.clone() for k, v in pools.items()}
    p_ctrl = {k: v.clone() for k, v in pools.items()}
    rows = {"out_k": [], "out_c": [], "wkv_k": [], "wkv_c": [], "shift_k": []}
    for layer, blk in enumerate(model.blocks):
        ws = bt_dev[layer, 0]
        p_ctrl["wkv"].copy_(p_ref["wkv"])
        p_ctrl["wkv"][int(bt[layer, 0, 0])] = 0.0
        outs = {name: rwkv_time_mix_regions(torch, cfg, blk, x, p, ws,
                                            nr_dev, n_dec, impl)
                for name, p, impl in (("k", p_ref, "kernel"),
                                      ("r", p_ref, "ref"),
                                      ("c", p_ctrl, "ref"))}
        (ref_d, ref_c), ref_s = outs["r"]
        for key, name in (("k", "out_k"), ("c", "out_c")):
            (od, oc), _ = outs[key]
            d_dec = ((od.float() - ref_d.float()).abs().amax(-1)
                     / ref_d.float().abs().amax(-1).clamp_min(1e-6))
            d_chk = ((oc.float() - ref_c.float()).abs().amax(-1)
                     / ref_c.float().abs().amax(-1).clamp_min(1e-6))
            rows[name].append(max(d_dec.max().item(),
                                  d_chk[compared].max().item()))
        for key, name in (("k", "wkv_k"), ("c", "wkv_c")):
            rows[name].append(limit_ratio(outs[key][1][real], ref_s[real],
                                          *WKV_LIMITS[1]))
        del outs
        p_k = {k: v.clone() for k, v in p_ref.items()}
        lm.rwkv_mixed_paged(blk, cfg, x, p_k, ws, ws, nr_dev, n_dec,
                            "kernel")
        x = lm.rwkv_mixed_paged(blk, cfg, x, p_ref, ws, ws, nr_dev, n_dec,
                                "ref")
        sd = p_k["shift"][keep].float() - p_ref["shift"][keep].float()
        rows["shift_k"].append(sd.abs().max().item() / p_ref["shift"][
            keep].float().abs().max().item())
        del p_k
    print(f"rwkv layer step, per layer ({cfg.n_layers} layers, R={R} "
          f"Tc={Tc}): time-mix output max per-token relative diff to "
          f"plain: kernel {max(rows['out_k']):.4g}, control (lane 0's state "
          f"zeroed) least {min(rows['out_c']):.4g}; new wkv state "
          f"error/limit kernel {max(rows['wkv_k']):.4g}, control least "
          f"{min(rows['wkv_c']):.4g}; shift pages max relative diff "
          f"{max(rows['shift_k']):.4g}")
    if not (max(rows["out_k"]) <= LAYER_REL_LIMIT < min(rows["out_c"])
            and max(rows["wkv_k"]) <= 1.0 < min(rows["wkv_c"])
            and max(rows["shift_k"]) <= LAYER_REL_LIMIT):
        raise AssertionError(f"rwkv layer step: kernel vs plain outside the "
                             f"limits, or a control within them: {rows}")

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    runs = {"ref": (model, cfg, "ref", False),
            "kernel": (model, cfg, "kernel", False),
            "control": (model, cfg, "ref", True),
            "f32": (model32, cfg32, "ref", False)}
    outs = {}
    for name, (mdl, c, impl, control) in runs.items():
        p = {"wkv": pools["wkv"].clone(),
             "shift": pools["shift"].to(c.torch_compute_dtype()).clone()}
        if control:
            p["wkv"][torch.as_tensor(bt[:, 0, 0].astype(np.int64))] = 0.0
        logits, _ = api.serve_step_paged(mdl, c, tokens, p, tables,
                                         q_starts, n_reals, n_decode=n_dec,
                                         impl=impl)
        _sync(torch, dev)
        outs[name] = logits.float()
        del p
    if tuple(outs["kernel"].shape) != (R, cfg.vocab_size) \
            or not torch.isfinite(outs["kernel"]).all():
        raise AssertionError("rwkv layer step: logits of the wrong shape or "
                             "not finite")
    dist = {name: [round(v, 4) for v in (outs[name] - outs["f32"]).abs()
                   .amax(-1)[real].tolist()]
            for name in ("kernel", "ref", "control")}
    agree = (outs["kernel"][real].argmax(-1)
             == outs["f32"][real].argmax(-1)).float().mean().item()
    print(f"rwkv layer step, whole: logits |f32| max "
          f"{outs['f32'][real].abs().max().item():.3g}; per real row max abs "
          f"diff to f32: {json.dumps(dist)}; argmax agreement of the kernel "
          f"path with f32 {agree:.3f}")
    limit = 2 * max(dist["ref"])
    if not max(dist["kernel"]) <= limit < max(dist["control"]):
        raise AssertionError(
            f"rwkv layer step: the kernel path's logits "
            f"({max(dist['kernel'])} from float32) must be within twice the "
            f"plain bf16 path's ({limit}), and the control "
            f"({max(dist['control'])}) beyond it")


def phase_rwkv_per_request(torch, np, cfg, model, model32, dev):
    """rwkv6-3b through the per-request entry points at full width: the
    four prompts of phase 5, chunk by chunk through
    ``api.prefill_chunk_paged``, then 32 steps of ``api.decode_step_paged``
    (counts reset just before, read after; ``wkv6`` must launch). Each
    prompt's last-token logits no further from float32 than twice the plain
    bf16 path's; a control that drops the state between chunks (wkv pages
    zeroed before every chunk but the first) further. Beside it, the same
    prompts through the fused engine (FCFS): walls, launches, and how many
    greedy tokens the two paths share, in bf16 and, as a yardstick for
    bf16 noise, in float32 through the kernel on both sides (reported, not
    asserted), with how far the float32 kernel path's prefill logits lie
    from the float32 plain path's (how much the model amplifies a rounding
    difference)."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    rng = np.random.default_rng(8)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), split)
               for n, split in PROMPTS.items()]
    _sync(torch, dev)
    build.reset_launch_counts()
    run = per_request_run(torch, np, cfg, model, dev, prompts, "kernel",
                          decode_steps=DECODE_STEPS)
    launches = build.launch_counts()
    print("rwkv per-request (api.prefill_chunk_paged / "
          "api.decode_step_paged): "
          + _walls(np, "prefill chunk wall", run["chunk_s"]) + "; "
          + _walls(np, "decode step wall", run["step_s"]))
    print(f"rwkv per-request: kernel launches "
          f"{json.dumps(launches, sort_keys=True)}")
    if launches.get("wkv6", 0) == 0:
        raise AssertionError("rwkv per-request run never launched wkv6")
    if not all(len(t) == DECODE_STEPS + 1 and all(0 <= v < cfg.vocab_size
                                                  for v in t)
               for t in run["tokens"]):
        raise AssertionError("rwkv per-request: wrong greedy tokens")

    def drop_state(kind, kv, tokens, tables, pos, n_real):
        if kind == "prefill" and pos > 0:
            slots = torch.as_tensor(tables["wkv"].reshape(-1).astype(
                np.int64)).to(dev)
            kv.pools["wkv"][slots] = 0.0
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    run32 = per_request_run(torch, np, cfg32, model32, dev, prompts, "ref")
    logits = {"kernel": run["logits"],
              "ref": per_request_run(torch, np, cfg, model, dev, prompts,
                                     "ref")["logits"],
              "control": per_request_run(torch, np, cfg, model, dev, prompts,
                                         "ref", hook=drop_state)["logits"],
              "f32": run32["logits"]}
    dist = {k: [round((a - b).abs().max().item(), 4)
                for a, b in zip(v, logits["f32"])]
            for k, v in logits.items() if k != "f32"}
    limit = 2 * max(dist["ref"])
    print(f"rwkv per-request prefill, last-token logits max abs diff to f32 "
          f"per prompt {list(PROMPTS)}: {json.dumps(dist)}; limit "
          f"{limit:.4g}")
    if not max(dist["kernel"]) <= limit < max(dist["control"]):
        raise AssertionError(
            f"rwkv per-request prefill: the kernel path's logits "
            f"({max(dist['kernel'])} from float32) must be within twice the "
            f"plain bf16 path's ({limit}), and the control "
            f"({max(dist['control'])}) beyond it")

    def fused(c, mdl):
        eng = ServingEngine(c, mdl, max_running=4, max_seq=1024,
                            scheduler="fcfs", step_tokens=256,
                            offload_tier=REMOTE, kv_page_tokens=16,
                            spec_chunk_ahead=False, device=dev)
        reqs = [eng.submit(list(map(int, p)), DECODE_STEPS + 1)
                for p, _ in prompts]
        _sync(torch, dev)
        build.reset_launch_counts()
        step_s = []
        while (eng.waiting or eng.running) and len(step_s) < 1000:
            t = time.perf_counter()
            eng.step()
            _sync(torch, dev)
            step_s.append(time.perf_counter() - t)
        if not all(len(r.generated) == DECODE_STEPS + 1 for r in reqs):
            raise AssertionError("rwkv fused: not every request finished")
        mixed = np.asarray(eng.metrics.prefill_tokens_trace) > 0
        return ([r.generated for r in reqs], np.asarray(step_s), mixed,
                build.launch_counts())

    def agreeing(a, b):
        return [sum(x == y for x, y in zip(p, q)) for p, q in zip(a, b)]
    tokens, step_s, mixed, launched = fused(cfg, model)
    print("rwkv fused (ServingEngine FCFS, same prompts, "
          f"{DECODE_STEPS + 1} tokens each): {len(step_s)} steps; "
          + _walls(np, "step wall with prompt chunks", step_s[mixed]) + "; "
          + _walls(np, "decode-only step wall", step_s[~mixed]))
    print(f"rwkv fused: kernel launches "
          f"{json.dumps(launched, sort_keys=True)}")
    agree = agreeing(tokens, run["tokens"])
    run32k = per_request_run(torch, np, cfg32, model32, dev, prompts,
                             "kernel", decode_steps=DECODE_STEPS)
    agree32 = agreeing(fused(cfg32, model32)[0], run32k["tokens"])
    spread32 = [round((a - b).abs().max().item(), 5)
                for a, b in zip(run32k["logits"], run32["logits"])]
    margins = [round(float(v[0] - v[1]), 4)
               for v in (lg.topk(2).values for lg in run["logits"])]
    n = len(agree) * (DECODE_STEPS + 1)
    print(f"rwkv greedy tokens, per-request vs fused, agreeing per prompt "
          f"{list(PROMPTS)}: bf16 {agree} ({sum(agree)} of {n}), float32 "
          f"{agree32} ({sum(agree32)} of {n}); bf16 prefill logits' top-2 "
          f"margin per prompt {margins} (against their distance to float32 "
          f"above); float32 prefill logits, kernel vs plain, max abs diff "
          f"per prompt {spread32}")
    return launches


# -- qwen1.5-0.5b training: the flash attention kernels --------------------
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:76"
# (B, Sq, Sk, H, K, hd, causal, window): the reference's test_kernels sweep
# (GQA, window, right-aligned Sq < Sk, bidirectional, MQA at hd 256), then
# the training shape of qwen1.5-0.5b at batch 4 and 2048 tokens
FLASH_SWEEP = [(2, 128, 128, 4, 2, 64, True, 0),
               (1, 256, 256, 4, 4, 32, True, 64),
               (2, 64, 192, 6, 2, 64, True, 0),
               (1, 128, 128, 2, 2, 128, False, 0),
               (1, 64, 64, 8, 1, 256, True, 0)]
TRAIN_ATTN = (4, 2048, 2048, 16, 16, 64, True, 0)
# forward: the reference's TOL (tests/test_kernels.py); backward: distance
# of dq / dk / dv to the plain formula, relative to its norm
FLASH_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
FLASH_BWD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# the train step, kernel path against plain path at batch 1: each
# parameter's gradient (distance relative to the plain gradient's norm)
# and the loss (absolute); attention outputs per layer as LAYER_REL_LIMIT
GRAD_REL_LIMIT = 5e-2
LOSS_ABS_LIMIT = 2e-2
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 4, 2048


def flash_control(torch, q, k, v, causal, window):
    """The plain version with every row's diagonal key (k_pos == q_pos)
    masked as well: each row loses one visible key. Differentiable."""
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         attention_mask)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    mask &= torch.arange(Sk, device=q.device)[None, :] != q_pos[:, None]
    qg = q.float().reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / hd ** 0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", probs, v).reshape(B, Sq, H, hd)


def flash_inputs(torch, g, shape, dtype):
    B, Sq, Sk, H, K, hd, _, _ = shape
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                      (B, Sq, H, hd))]


def flash_work(shape, itemsize):
    """(forward FLOP, forward bytes, backward FLOP, backward bytes) the
    call must do and move: 2 products forward and 5 backward of 2 FLOP per
    visible (query, key) pair and head dim per query head; q, k, v (and o,
    dO) read once, o (dq, dk, dv) written once, lse and D in float32."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    B, Sq, Sk, H, K, hd, causal, window = shape
    pairs = int(attention_mask(Sq, Sk, causal, window, "cpu").sum())
    qb, kb = B * Sq * H * hd * itemsize, B * Sk * K * hd * itemsize
    lse = B * H * Sq * 4
    return (4 * B * H * hd * pairs, 2 * qb + 2 * kb + lse,
            10 * B * H * hd * pairs, 4 * qb + 4 * kb + 2 * lse)


def library_attention_ms(torch, q, k, v, do, iters):
    """The yardstick: ``scaled_dot_product_attention`` (is_causal, so
    Sq == Sk) on the same inputs, forward alone and forward + backward,
    device ms per call. Timed here only; the port never calls it."""
    from torch.nn import functional as F
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        return torch.autograd.grad(out, leaves, dot)
    return device_ms(fwd, iters), device_ms(fwd_bwd, iters)


TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkdv_tc")
# the bf16 paged-attention kernels, in the order of ops.tc_kernel_info
PAGED_TC = ("paged_mixed_tc", "paged_prefill_tc",
            "paged_decode_tc<FusedPool>", "paged_decode_tc<SplitPools>")


def _ptxas_key(name):
    """(kernel, hd) of a bf16 flash or paged-attention kernel's mangled
    name, or of the WKV kernel's (``wkv6<float32|bfloat16>``), else None; a
    decode kernel's name carries its pool layout."""
    import re
    m = re.search(r"wkv6_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    if m:
        return (f"wkv6<{'float32' if m.group(1) == 'f' else 'bfloat16'}>",
                int(m.group(2)))
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_tc)ILi(\d+)E", name)
    if m:
        return m.group(1), int(m.group(2))
    m = re.search(r"(paged_(?:mixed|prefill|decode)_tc)ILi(\d+)E"
                  r"(?:N\w*?\d(FusedPool|SplitPools)E)?", name)
    if m:
        return (m.group(1) + (f"<{m.group(3)}>" if m.group(3) else ""),
                int(m.group(2)))
    return None


def ptxas_resources(log):
    """{(kernel, hd): (registers, spill stores, spill loads)} of the bf16
    tensor-core flash kernels, the bf16 paged-attention kernels and the WKV
    kernel, from ``nvcc -Xptxas -v``'s log."""
    import re
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        key = _ptxas_key(name or "")
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            regs = found.get(key, (0, 0, 0))[0]
            found[key] = (regs, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            _, st, ld = found.get(key, (0, 0, 0))
            found[key] = (int(m.group(1)), st, ld)
    return found


def print_resources(label, head_dims, kernel_info):
    """One line per head dim: each kernel's registers and spills (ptxas),
    local and dynamic shared memory, and resident blocks per SM where
    ``kernel_info(hd)`` ({kernel: record}) reports them."""
    from repro_torch.kernels import build
    ptxas = ptxas_resources(build.build_log)
    for hd in head_dims:
        parts = []
        for kern, rec in kernel_info(hd).items():
            regs, st, ld = ptxas.get((kern, hd), (None, None, None))
            part = (f"{kern} {rec['registers']} registers (ptxas {regs}), "
                    f"spill stores/loads {st}/{ld}, local "
                    f"{rec['local_bytes']} B, shared {rec['smem_bytes']} B")
            if "blocks_per_sm" in rec:
                part += f", {rec['blocks_per_sm']} blocks per SM"
            parts.append(part)
        print(f"{label} hd {hd}: " + "; ".join(parts))


def print_flash_resources(fa_ops):
    """The bf16 tensor-core flash kernels at every head dim."""
    print_resources("flash bf16 kernels", fa_ops.HEAD_DIMS, lambda hd: dict(
        zip(TC_KERNELS, fa_ops.tc_kernel_info(hd).values())))


def print_paged_resources(pa_ops):
    """The bf16 paged-attention kernels at every head dim they take."""
    print_resources("paged attention bf16 kernels", pa_ops.BF16_HEAD_DIMS,
                    lambda hd: dict(zip(PAGED_TC,
                                        pa_ops.tc_kernel_info(hd).values())))


def print_wkv_resources(wkv_ops):
    """The WKV kernel at hd 32 and 64, both compute dtypes."""
    print_resources("wkv6 kernel", (32, 64), wkv_ops.wkv6_kernel_info)


def phase_flash_kernels(torch, report):
    """Flash attention forward and backward kernels against their plain
    versions (module docstring, phase 11); returns nothing, appends the
    two rows to ``report``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = {"fwd": [], "bwd": []}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    for shape in FLASH_SWEEP + [TRAIN_ATTN]:
        causal, window = shape[6], shape[7]
        kw = dict(causal=causal, window=window)
        for dname, dt in dtypes.items():
            q, k, v, do = flash_inputs(torch, g, shape, dt)
            o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
            want = fa_ref.flash_attention_ref(q, k, v, **kw)
            ctrl = flash_control(torch, q, k, v, causal, window)
            err = (o.float() - want.float()).abs().max().item()
            c_err = (ctrl.float() - want.float()).abs().max().item()
            del want, ctrl
            ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
            got = fa_ops.flash_attention_bwd(q, k, v, ro, rlse.float(), do,
                                             **kw)
            ref = fa_ref.flash_attention_bwd_ref(q, k, v, ro, rlse, do, **kw)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            c_out = flash_control(torch, *leaves, causal, window)
            c_grads = torch.autograd.grad(c_out, leaves, do)
            torch.cuda.synchronize()
            b_err = max(rel(a, b) for a, b in zip(got, ref))
            cb_err = min(rel(a, b) for a, b in zip(c_grads, ref))
            finite = bool(torch.isfinite(o).all()) and all(
                bool(torch.isfinite(t).all()) for t in got)
            del got, ref, c_out, c_grads, leaves, ro, rlse
            name = (f"B={shape[0]} Sq={shape[1]} Sk={shape[2]} H={shape[3]}"
                    f" K={shape[4]} hd={shape[5]} causal={causal} "
                    f"window={window} {dname}")
            print(f"flash {name}: fwd err {err:.3g} (limit "
                  f"{FLASH_TOL[dname]}, control {c_err:.3g}); bwd rel "
                  f"{b_err:.3g} (limit {FLASH_BWD_REL[dname]}, control "
                  f"{cb_err:.3g})")
            if not (finite and err <= FLASH_TOL[dname] < c_err
                    and b_err <= FLASH_BWD_REL[dname] < cb_err):
                raise AssertionError(
                    f"flash attention {name}: forward error {err} (control "
                    f"{c_err}) / backward {b_err} (control {cb_err}) "
                    f"against limits {FLASH_TOL[dname]} / "
                    f"{FLASH_BWD_REL[dname]}, finite {finite}")
            rows["fwd"].append(dict(shape=name, max_abs_err=err,
                                    control=c_err))
            rows["bwd"].append(dict(shape=name, max_rel_err=b_err,
                                    control=cb_err))

    # times at the training shape, bf16
    q, k, v, do = flash_inputs(torch, g, TRAIN_ATTN, torch.bfloat16)
    kw = dict(causal=True, window=0)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
    # deterministic backward: no atomics, so two calls agree bit for bit
    first = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"flash train shape bf16 backward, two calls bit-identical: {same}")
    if not same:
        raise AssertionError("flash attention bf16 backward differs between "
                             "two calls on the same inputs")
    del first, second
    ms_f, plain_f = interleaved(
        lambda: fa_ref.flash_attention_ref(q, k, v, **kw),
        lambda: fa_ops.flash_attention_fwd(q, k, v, **kw), 10, plain_iters=3)
    ms_b, plain_b = interleaved(
        lambda: fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
        lambda: fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw), 10,
        plain_iters=3)
    lib_f, lib_fb = library_attention_ms(torch, q, k, v, do, 10)
    f_flop, f_bytes, b_flop, b_bytes = flash_work(TRAIN_ATTN, 2)
    bf, byf = bound_ms(f_bytes, f_flop)
    bb, byb = bound_ms(b_bytes, b_flop)
    shape = rows["fwd"][-1]["shape"]
    print(f"flash train shape {shape}: forward kernel {ms_f:.4f} ms plain "
          f"{plain_f:.4f} bound {bf:.4f} ({byf}) library {lib_f:.4f}; "
          f"backward kernel {ms_b:.4f} ms plain {plain_b:.4f} bound "
          f"{bb:.4f} ({byb}) library fwd+bwd {lib_fb:.4f} "
          f"(minus fwd {lib_fb - lib_f:.4f})")
    for part, flop, ms, bound in (("forward", f_flop, ms_f, bf),
                                  ("backward", b_flop, ms_b, bb)):
        print(f"flash {part}: {flop / (ms * 1e9):.1f} TFLOP/s of the "
              f"algorithm's {flop:.4g} FLOP, {bound / ms:.4f} of its bound "
              f"({bound:.4f} ms / {ms:.4f} ms)")
    print_flash_resources(fa_ops)
    del q, k, v, do, o, lse
    common = dict(route="cuda", source=FLASH_SRC, replaces=FLASH_TPU)
    report.append(dict(
        name="flash_attention", **common, shape=shape,
        max_abs_err=rows["fwd"][-1]["max_abs_err"],
        tolerance=FLASH_TOL["bfloat16"], ms=ms_f, plain_ms=plain_f,
        bound_ms=bf, bound_by=byf, library_ms=lib_f, sweep=rows["fwd"]))
    report.append(dict(
        name="flash_attention_bwd", **common, shape=shape,
        max_abs_err=rows["bwd"][-1]["max_rel_err"],
        error_kind="dq/dk/dv distance relative to the plain formula's norm",
        tolerance=FLASH_BWD_REL["bfloat16"], ms=ms_b, plain_ms=plain_b,
        bound_ms=bb, bound_by=byb, library_ms=lib_fb - lib_f,
        library_note="the library attention's forward + backward "
        f"({lib_fb:.4f} ms) minus its forward", sweep=rows["bwd"]))


def train_step_grads(torch, model, batch, loss_fn):
    from repro_torch.training.train_loop import trainable_params
    params = trainable_params(model)
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), dict(zip(params, grads))


def phase_train_step(torch, np, cfg, model, dev):
    """One full-width train step at batch 1 through the kernels and the
    plain versions (module docstring, phase 12). Returns its launches."""
    from repro_torch.kernels import build
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import (embed, linear, mlp, rms_norm,
                                         unembed)
    from repro_torch.models import api, lm
    from repro_torch.models.losses import shifted_xent
    from repro_torch.training.data import DataConfig, make_batch
    batch = make_batch(DataConfig(seed=0, batch=1, seq_len=TRAIN_SEQ), cfg, 0)
    tokens = batch["tokens"].to(dev)
    # the first layer: its control changes every later layer's input
    control_layer = 0

    def control_attention(mix, h):
        B, T, _ = h.shape
        pos = torch.arange(T, device=h.device)[None, :]
        q, k, v = attn._project_qkv(mix, cfg, h, pos)
        ctx = flash_control(torch, q, k, v, True, 0)
        return linear(mix.wo, ctx.reshape(B, T, -1))

    def control_loss(m, b):
        x = embed(m.embed, cfg, tokens)
        for layer, blk in enumerate(m.blocks):
            x = lm._layer(blk, cfg, x, lambda mix, h: (
                control_attention(mix, h) if layer == control_layer else
                attn.attention_full(mix, cfg, h, impl="ref")))
        x = rms_norm(m.final_norm, x, cfg.rmsnorm_eps)
        return shifted_xent(unembed(m.embed, cfg, x), tokens)

    # per layer, on the same input: kernel, plain and control attention
    rel = {"kernel": [], "control": []}
    with torch.no_grad():
        x = embed(model.embed, cfg, tokens)
        for blk in model.blocks:
            h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
            out_r = attn.attention_full(blk.mix, cfg, h, impl="ref")
            scale = out_r.float().abs().amax(-1).clamp_min(1e-6)
            for name, o in (("kernel", attn.attention_full(
                    blk.mix, cfg, h, impl="kernel")),
                    ("control", control_attention(blk.mix, h))):
                d = (o.float() - out_r.float()).abs().amax(-1) / scale
                rel[name].append(d.max().item())
            x = x + out_r
            x = x + mlp(blk.ffn, cfg, rms_norm(blk.n2, x, cfg.rmsnorm_eps))
        del x, h, out_r
    build.reset_launch_counts()
    loss_k, g_k = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="kernel"))
    _sync(torch, dev)
    launches = build.launch_counts()
    loss_r, g_r = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="ref"))
    loss_c, g_c = train_step_grads(torch, model, batch, control_loss)
    _sync(torch, dev)

    def grad_rel(gs):
        return {n: ((gs[n].float() - g_r[n].float()).norm()
                    / g_r[n].float().norm().clamp_min(1e-30)).item()
                for n in g_r}
    gk, gc = grad_rel(g_k), grad_rel(g_c)
    worst = sorted(gk.items(), key=lambda kv: -kv[1])[:3]
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    print(f"train step (batch 1, seq {TRAIN_SEQ}): attention per layer, "
          f"kernel vs plain per token max {max(rel['kernel']):.4g} (limit "
          f"{LAYER_REL_LIMIT}), control (layer loses its diagonal key) min "
          f"{min(rel['control']):.4g}")
    print(f"train step: loss kernel {loss_k:.6f} plain {loss_r:.6f} (|d| "
          f"{abs(loss_k - loss_r):.3g}, limit {LOSS_ABS_LIMIT}) control "
          f"(layer {control_layer}) {loss_c:.6f} (|d| "
          f"{abs(loss_c - loss_r):.3g})")
    print(f"train step: gradients kernel vs plain, relative norm, worst "
          f"{[(n, float(f'{r:.3g}')) for n, r in worst]} (limit "
          f"{GRAD_REL_LIMIT});"
          f" control worst {max(gc.values()):.4g} "
          f"({max(gc, key=gc.get)})")
    print(f"train step: launches {json.dumps(launches, sort_keys=True)}")
    del g_k, g_r, g_c
    if not (finite and max(rel["kernel"]) <= LAYER_REL_LIMIT
            < min(rel["control"])):
        raise AssertionError(f"train step attention: kernel {rel['kernel']} "
                             f"control {rel['control']} finite {finite}")
    if not (abs(loss_k - loss_r) <= LOSS_ABS_LIMIT
            and max(gk.values()) <= GRAD_REL_LIMIT < max(gc.values())):
        raise AssertionError(f"train step: loss {loss_k} vs {loss_r}, "
                             f"gradients {worst}, control {max(gc.values())}")
    if launches.get("flash_attention", 0) != cfg.n_layers or launches.get(
            "flash_attention_bwd", 0) < cfg.n_layers:
        raise AssertionError(f"train step launches {launches}: want "
                             f"{cfg.n_layers} forward, >= {cfg.n_layers} "
                             "backward")
    return launches


def phase_train_run(torch, np, cfg, dev, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """``train_loop.train`` for ``steps`` steps at full width (module
    docstring, phase 13). Returns its launches."""
    from repro_torch.kernels import build
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
    from repro_torch.training.train_loop import TrainConfig, train
    dcfg = DataConfig(seed=0, batch=batch, seq_len=seq)
    ocfg = AdamWConfig(lr=cosine_schedule(3e-4, warmup=1, total=steps))
    tcfg = TrainConfig(steps=steps, impl="kernel")
    gen = torch.Generator(device=dev).manual_seed(3)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    out = train(cfg, dcfg, ocfg, tcfg, device=dev, generator=gen)
    _sync(torch, dev)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    losses = out["losses"]
    secs = np.asarray(out["step_times"])
    steady = secs[1:]
    tokens = batch * seq
    f_flop, _, b_flop, _ = flash_work(
        (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, True, 0), 2)
    attn_flop = cfg.n_layers * (f_flop + b_flop)
    model_flop = 6 * cfg.param_count() * tokens + attn_flop
    p50 = float(np.percentile(steady, 50))
    print(f"train run: {steps} steps, batch {batch} x {seq}, losses "
          f"{[round(l, 4) for l in losses]}")
    print(f"train run: step time (steps 2-{steps}) p50 "
          f"{p50 * 1e3:.2f} ms p99 {np.percentile(steady, 99) * 1e3:.2f} ms;"
          f" first step {secs[0] * 1e3:.2f} ms; {tokens / p50:.1f} tokens/s;"
          f" peak memory {peak:.2f} GiB")
    print(f"train run: launches per step "
          f"{json.dumps({k: v / steps for k, v in launches.items()})}"
          f"; model FLOP per step {model_flop:.4g} (6 x "
          f"{cfg.param_count()} params x {tokens} tokens + attention "
          f"{attn_flop:.4g}), {model_flop / BF16_FLOPS * 1e3:.2f} ms at the"
          f" bf16 peak: model-FLOP share "
          f"{model_flop / (p50 * BF16_FLOPS):.4f} of the p50 step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train run losses {losses}: must be finite "
                             "and fall")
    if cuda:
        profile_train_step(torch, cfg, dcfg, ocfg, tcfg, out, steps)
    return launches


# device time of the profiled step by kind of kernel, matched on its name
PROFILE_KINDS = (("flash", ("flash_",)),
                 ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("reduction", ("reduce_kernel", "softmax", "Reduce")),
                 ("copy", ("copy_kernel", "Memcpy", "Memset")),
                 ("elementwise", ("elementwise_kernel",)))


def device_time_summary(events, wall_us):
    """From device events (name, start us, end us) of one step and its wall
    time: device time by kernel name (top 10) and by kind, the flash
    kernels' sum against the step, and the idle share (1 - the union of
    device activity over the wall)."""
    by_name: dict = {}
    for name, start, end in events:
        by_name[name] = by_name.get(name, 0.0) + end - start
    spans = sorted((start, end) for _, start, end in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    flash = sum(t for n, t in by_name.items() if "flash_" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kinds: dict = {}
    for n, t in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS if any(
            key in n for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t / 1e3
    return {"step_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_events": len(events),
            "flash_ms": flash / 1e3, "flash_share_of_step": flash / wall_us,
            "flash_share_of_busy": flash / busy, "by_kind_ms": kinds,
            "top10_ms": [[n[:200], t / 1e3] for n, t in top]}


def profile_train_step(torch, cfg, dcfg, ocfg, tcfg, out, step):
    """One more steady step of the trained model under ``torch.profiler``
    (CPU and CUDA activities): device time by kernel name (top 10), the
    flash kernels' sum against the step, and the device's idle share (1 -
    the union of device activity over the step's wall). Prints "not
    measured" where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_loop import make_train_step
    step_fn = make_train_step(cfg, ocfg, tcfg)
    batch = make_batch(dcfg, cfg, step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(out["params"], out["opt"], batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and e.time_range.elapsed_us() > 0]
    if not device:
        print(f"train profile: one step {wall_us / 1e3:.2f} ms wall; device "
              "time by kernel, flash share and idle share: not measured "
              "(the trace holds no device events)")
        return
    print("train profile: " + json.dumps(device_time_summary(
        [(e.name, e.time_range.start, e.time_range.end) for e in device],
        wall_us)))


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
    per_request, split = phase_per_request(torch, np, cfg, model, dev)
    launches, base_tokens = phase_engine(
        torch, np, cfg, model, dev, need=("paged_mixed_attention_pool",
                                          "append_kv", "gather_pages",
                                          "scatter_pages"), profile=True)
    if launches["append_kv"] != launches["paged_mixed_attention_pool"]:
        raise AssertionError(
            f"engine: {launches['append_kv']} page-writer launches, not one "
            f"per layer per step ({launches['paged_mixed_attention_pool']} "
            f"mixed attention launches)")
    t_lease = time.perf_counter()
    phase_lease_lifecycle(torch, np, cfg, model, dev, card)
    print(f"lease lifecycle phase: {time.perf_counter() - t_lease:.1f} s")
    t_req = time.perf_counter()
    request_lifecycle = phase_request_lifecycle(torch, np, cfg, model, dev,
                                                card, base_tokens)
    print(f"admission and request lifecycle phase: "
          f"{time.perf_counter() - t_req:.1f} s")
    del model
    torch.cuda.empty_cache()
    print(f"qwen1.5-0.5b phases done at {time.perf_counter() - t0:.1f} s")

    # -- rwkv6-3b: the wkv state and shift planes, the WKV kernel ---------
    rcfg = get_config("rwkv6-3b")
    phase_wkv_kernel(torch, np, rcfg, report)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = lm.init_params(rcfg, gen, "cuda")
    model32 = copy.deepcopy(model).float()
    phase_rwkv_layer_step(torch, np, rcfg, model, model32, dev)
    rwkv_per_request = phase_rwkv_per_request(torch, np, rcfg, model,
                                              model32, dev)
    del model32
    torch.cuda.empty_cache()
    rwkv_engine, _ = phase_engine(torch, np, rcfg, model, dev,
                                  need=("wkv6", "gather_pages",
                                        "scatter_pages"))
    del model
    torch.cuda.empty_cache()
    print(f"rwkv6-3b phases done at {time.perf_counter() - t0:.1f} s")

    # -- qwen1.5-0.5b training: the flash attention kernels ----------------
    phase_flash_kernels(torch, report)
    gen = torch.Generator(device="cuda").manual_seed(2)
    model = lm.init_params(cfg, gen, "cuda")
    phase_train_step(torch, np, cfg, model, dev)
    del model
    torch.cuda.empty_cache()
    train_run = phase_train_run(torch, np, cfg, dev)
    # each kernel's launches on the first path that runs it: the qwen engine
    # (the fused step), the qwen per-request path, the split-pool drive, the
    # rwkv engine, the rwkv per-request path, the train run; and on every
    # path that runs it, phase 6c's admission and request lifecycle included
    paths = (("engine", launches), ("per-request", per_request),
             ("split-pool drive", split), ("rwkv engine", rwkv_engine),
             ("rwkv per-request", rwkv_per_request), ("train", train_run),
             ("request lifecycle", request_lifecycle))
    for k in report:
        k["path"], counts = next(((p, c) for p, c in paths
                                  if c.get(k["name"], 0) > 0), ("none", {}))
        k["launches"] = int(counts.get(k["name"], 0))
        k["launches_by_path"] = {p: int(c[k["name"]]) for p, c in paths
                                 if c.get(k["name"], 0) > 0}
    missing = [k["name"] for k in report if k["launches"] == 0]
    if missing:
        raise AssertionError(f"no path launched {missing}")
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
