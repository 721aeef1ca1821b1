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

Then deepseek-v2-lite-16b at its published width (27 layers, d 2048, 16
heads, MLA rank 512 + rope 64, 64 routed experts top-6 + 2 shared of
1408, vocab 102400, bf16; random seeded weights): every layer MLA, whose
context is the ``mla`` token plane of (16, 576) bf16 pages (18,432 B),
then the dropless MoE; neither has a Pallas kernel in the reference, so
the path's kernels are rows 6-7, which park and restore its pages:

14. mla rows — the gather's plan, registers, local memory and ring at the
   ``mla`` leg (1,350 pages: a 16 KiB chunk and a 2,048 B tail a row);
   gather and scatter bit-exact against their plain versions at 1 row, 7
   rows (fewer work items than the grid), 3 x the grid + 5 and 1,350
   rows, ids outside the pool included; the leg's device times (the
   gather cold, as in phase 3) beside ``index_select`` / ``index_copy_``
   and the bound (bytes over 3.35 TB/s), under ``deepseek_mla`` in the
   two kernels' records.
15. model — ``lm.init_params`` from a seeded CUDA generator: the
   reference's ``param_count()`` must be 16,210,309,120 (the model holds
   that plus its kv_norm and final_norm scales); memory allocated.
16. deepseek layer step — phase 4's packed step, bf16 against float32 a
   layer at a time (a float32 copy of the whole model does not fit beside
   it): per layer, on the bf16 path's input, MLA and the MoE each within
   ``LAYER_REL_LIMIT`` per real token of a float32 copy of the layer, each
   control beyond (MLA: the furthest decode lane's newest page swapped for
   scratch; MoE: routing to top-5); the share of real tokens whose top-6
   experts differ between the bf16 and float32 streams (printed, not
   asserted); the bf16 layers' logits equal ``api.serve_step_paged``'s bit
   for bit on the real rows, and nearer the float32 step's than the
   control's.
17. deepseek per-request — phase 5's prompts through the per-request entry
   points (no kernel launches there) beside the FCFS engine: walls and
   agreeing greedy tokens.
18. deepseek engine — phase 6 at full width: every request finishes,
   preemptions and restores one fabric message each, gather and scatter
   launched, the meter's bytes a whole number of token rows (27 x 1,152
   B: it counts live bytes, a tail page at its fill); its profile runs
   the MoE inside a ``record_function`` range and gives the MoE's share of
   the launch calls, the host syncs (one per MoE layer) and the MoE's
   device span.
19. deepseek round trip — a 300-token prompt in two chunks and 8 decode
   steps, parked on a same-card REMOTE lease and restored after each:
   every logits row bit-identical to the unparked run, one message per
   leg through the gather and scatter.

Then jamba-v0.1-52b at its published widths (d 4096, 32 heads on 8 KV
heads of 128, d_ff 14336, 16 experts top-2 in every second layer, Mamba
d_state 16, d_conv 4, expand 2, dt_rank 256, vocab 65536, bf16; random
seeded weights), 16 of its 32 layers: two hybrid periods of 8 (attention
at index 4, Mamba elsewhere), the deepest whole number of periods that
fits one 80 GB card beside a float32 copy of one MoE layer. Its context
is three planes: ``ssm`` (8192, 16) float32 and ``conv`` (3, 8192) bf16
state pages, one per Mamba layer (14), beside the ``kv`` token plane of
the 2 attention layers. The Mamba layer has no Pallas kernel in the
reference (its scan is ``jnp``), so the path's kernels are rows 2-7:

20. jamba kernels — rows 6-7 at one request's three legs (14 ssm pages of
   524,288 B, 14 conv pages of 49,152 B, 100 kv pages of 65,536 B): the
   gather's plans and resources, bit-exact at 1, 7, 3 x the grid + 5 and
   the leg's rows, ids outside the pool included, the ssm and conv rows
   also in the other of float32 and bf16; times beside ``index_select``
   / ``index_copy_`` and the bound. Rows 4 and 5 at the main path's
   packed step with 32 heads on 8 KV heads of 128 (``jamba`` records).
21. model — ``lm.init_params`` from a seeded CUDA generator at 16 layers:
   ``param_count()`` must be 26,053,361,664 (the model holds that plus
   the Mamba layers' conv_b and dt_bias and final_norm); memory
   allocated.
22. jamba layer step — phase 16's packed step, bf16 against a float32
   copy of each layer: Mamba, attention and MoE each within
   ``LAYER_REL_LIMIT`` per real token, controls beyond (the furthest
   decode lane's Mamba state zeroed; its newest kv page read as scratch;
   top-1 routing); the share of real tokens whose top-2 experts differ
   between the bf16 and float32 streams (printed); the bf16 layers'
   logits equal ``api.serve_step_paged``'s bit for bit on the real rows
   and lie nearer the float32 step's than a dropped-state control's.
23. jamba per-request — phase 5's prompts through the per-request entry
   points (rows 2, 3 and 5 launch): prefill logits against float32,
   computed layer-major a float32 layer copy at a time
   (``layer_major_run``), within twice the plain bf16 path's distance;
   at the first decode step a control with every lane's ssm pages zeroed
   beyond twice the plain path's; beside it the FCFS engine.
24. jamba engine — phase 6 at full width: every request finishes, one
   fabric message per leg across the three planes, bytes_fabric = legs x
   8,028,160 B of state (14 ssm + 14 conv pages, moved whole) plus whole
   8,192 B token rows (2 layers x 4,096 B, live bytes); rows 4-7 launch,
   the page writer once per attention layer per step; its profile runs
   the MoE inside a ``record_function("moe")`` range and each Mamba scan
   inside a ``record_function("mamba_scan")`` range and gives each
   range's share of the device time and of the launch calls.
25. jamba round trip — phase 19's park/restore round trip over the three
   planes, bit-identical to the unparked run.

Then internvl2-1b at its published width (24 layers, d 896, 14 heads on
2 KV heads of 64, d_ff 4864, vocab 151655, tied, bf16; random seeded
weights), a VLM whose prompts open with 256 prefix embedding rows (the
stub frontend's image, seeded per request), served on the ``kv`` plane
(12,288 B a token), the port's first odd GQA group (G 7):

26. internvl2 kernels — rows 1-5 at 14 heads on 2 of 64
   (``attention_rows``): the bf16 paged kernels' resources, row 4 at the
   main path's step and decode-only step, rows 1-3 with split == pool
   and mixed == per-request bit for bit, row 5 in both forms beside
   ``index_put_``; rows 6-7 at the ``kv`` leg of 1,200 x 8,192 B
   (``leg_rows``). ``internvl2`` / ``internvl2_kv`` records.
27. model — ``lm.init_params`` from a seeded CUDA generator:
   ``param_count()`` 493,752,448, the module 896 more (final_norm).
28. layer step — phase 4's packed step with each chunk row's seeded
   prefix block at its positions below 256 (``lm.embed_rows``), per layer
   kernel vs plain, whole step vs float32.
29. chunked prefix — 256 prefix rows + 44 tokens in one chunk and in
   three (the prefix split over all three): last-token logits within 2%
   (norm-relative), a zero-prefix control beyond.
30. engine — phase 6 with a prefix per request (text prompts shorter by
   256); bytes_fabric whole 12,288 B token rows.
31. round trip and snapshot — phase 19's round trip with a prefix,
   bit-identical; phase 6's requests snapshotted after 12 steps (prefix
   blocks as raw bf16 words), restored into a fresh runtime: every
   in-flight request finishes; tokens made at steps packed alike in both
   runs have logits within 2%, and a request decoding at the snapshot
   gives the original's tokens at least up to its first token made at a
   step packed otherwise (``packed_alike_agreement``; past that, bf16
   rounding of other GEMM tilings may part the streams at a near-tie).

32. LoRA adapter cache (``serving/lora.py``) at qwen1.5-0.5b's width —
   rows 6-7 at the adapter page (24 x 131,072 B); 8 rank-16 adapters
   (3,145,728 B each) parked beside a 100-page same-card REMOTE lease and
   ``capacity_local`` 2: pages read back equal to the raveled leaves bit
   for bit; a hit meters nothing, a miss its adapter's bytes as one
   message per tier its pages lie on, misses served from both the donor
   and the host; the cold fetch's gather from the donor timed beside
   ``index_select`` and its bound (``lora_fetch`` record); ``apply_lora``
   with B = 0 gives the unmerged logits bit for bit, B != 0 moves them.

Then gemma-7b at its published width (28 layers, d 3072, 16 heads of 256
on 16 KV heads, GeGLU d_ff 24576, vocab 256000, tied, embeddings scaled
by sqrt(d), bf16; random seeded weights): rows 1-5 at head_dim 256, a
``kv`` token row of 458,752 B:

33. gemma kernels — ``attention_rows`` at 16 heads of 256 (the kernels'
   resources must show no local memory) and rows 6-7 at the ``kv`` leg
   of 1,400 x 262,144 B. ``gemma`` / ``gemma_kv`` records.
34. model — 8,537,677,824 by the formula (15.90 GiB), the module 3,072
   more.
35. layer step — phase 4's packed step, per layer kernel vs plain and
   the kernel's attention within 2% per token of a float32 copy of the
   layer (controls beyond both); the whole step's logits against the
   plain path's printed (the float32 model does not fit beside the bf16
   one).
36. gemma per-request — phase 5 without the whole-prefill float32
   yardstick: per-layer checks, the split-pool drive (row 1 at hd 256),
   the FCFS engine beside it.
37. gemma engine — phase 6 on a 4 GiB lease (every parked request's
   pages, 2.9 GB), profiled; bytes_fabric whole 458,752 B token rows.
38. gemma round trip — bit-identical.

Then dbrx-132b at its published widths (d 6144, 48 heads on 8 KV heads of
128: G 6, 16 experts of 10752 top 4 and no shared expert, vocab 100352,
bf16; random seeded weights), 8 of its 40 layers (``DBRX_LAYERS``: 50.86
GiB, room for a float32 copy of one MoE layer):

39. dbrx kernels — ``attention_rows`` at 48 heads on 8 of 128.
40. model — 27,305,803,776 by the formula, the module 6,144 more.
41. dbrx layer step — phase 22's packed step (``phase_moe_layer_step``):
   attention and the MoE per layer within 2% per real token of a float32
   copy of the layer, controls beyond (the furthest lane's newest page
   read as scratch; top-3 routing); the share of tokens whose top-4
   experts differ printed; the bf16 layers' logits equal the served
   step's bit for bit, nearer float32 than a step whose furthest lane
   reads scratch for its newest page in every layer.
42. dbrx per-request — phase 36's path (per-layer checks, the split-pool
   drive at G 6, the FCFS engine beside it).
43. dbrx engine — phase 6, profiled with the ``moe`` range.
44. dbrx round trip — bit-identical.

Then the paper's own models at their published widths, full depth (the
reference's ``configs/aqua_paper.py``: RoPE, RMSNorm, 16-token ``kv``
pages of bf16; random seeded weights). aqua-llama2-13b (40 layers, d
5120, 40 heads on 40 of 128, SwiGLU 13824, vocab 32000; 24.24 GiB,
327,680 B a layer's page):

45. llama2 kernels — ``attention_rows`` at 40 heads on 40 (G 1), rows
   6-7 at the ``kv`` leg of 2,000 x 327,680 B.
46. model — 13,015,859,200, the module 5,120 more.
47. layer step — phase 35's (``whole_f32=False``): the attention and the
   MLP per layer within 2% of a float32 copy of each (the MLP's control
   drops its last sixteenth of hidden units).
48. per-request — phase 36's path; its split-pool drive launches row 1
   at hd 128.
49. engine — phase 6 on a 6 GiB lease (8 parked x 40 layers x 50 pages x
   327,680 B = 5.24 GB).
50. round trip — bit-identical.

aqua-codellama-34b (48 layers, d 8192, 64 heads on 8 of 128: G 8,
SwiGLU 22016, vocab 32016, rope theta 1e6; 62.85 GiB, whose reads bound
a decode-only step at 20.1 ms):

51. codellama kernels — ``attention_rows`` at 64 heads on 8.
52. model — 33,744,224,256, the module 8,192 more.
53. layer step — as phase 47.
54. engine — phase 6, profiled; its decode-only step's wall, device time
   and idle share printed beside the time its weight reads take.
55. round trip — bit-identical.

aqua-opt-30b (48 layers, d 7168, 56 heads on 56 of 128, a non-gated
tanh-gelu MLP of 28672, vocab 50272; 56.47 GiB, 458,752 B a layer's
page):

56. opt kernels — rows 6-7 at the ``kv`` leg of 2,400 x 458,752 B, then
   ``attention_rows`` at 56 heads on 56 over a 12,289-page pool (the
   engine's LOCAL pool, 5.64 GB, 2.82e9 elements: table entries past
   element 2^31).
57. model — 30,316,396,544, the module 7,168 more.
58. layer step — as phase 47, the gelu MLP against its float32 copy.
59. engine — phase 6 on a 9 GiB lease (8.81 GB parked) beside the
   5.64 GB LOCAL pool.
60. round trip — bit-identical (a 512 MiB lease: the request's 440 MB).

61. minicpm-2b — its count (2,724,878,592) and phase 6's engine run.

Each of these models prints its phase spans and each span's peak memory.

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

Then training beyond the dense family (``training families`` prints its
phase spans and peaks):

62. wkv backward kernel — ``wkv6_bwd`` (``csrc/wkv6_bwd.cu``) against
   ``wkv6_backward_plain`` on the card at rwkv6-3b's training shape (4,
   2048, 40, 64) and with a short last chunk (T 2047), in bf16 and float32,
   at the decays of phase 7: dr, dk, dv, dw, du and dstate within rtol
   1e-3 / atol 5e-4 in float32 and within 2e-2 of the plain norm (per
   chunk of 32 tokens for the token-shaped gradients) in bf16; a control,
   the plain backward with the middle chunk's dS' dropped, beyond both;
   two launches bit-identical; each of its three passes alone against its
   plain twin (states and state gradients at the float32 limits, the
   chunk pass at the limits above). Device times at the training shape in
   bf16 (plain, kernel, kernel, plain) beside the plain backward, autograd
   through ``wkv6_chunked`` and the bound (bytes over 3.35 TB/s, float32
   operations over 67 TFLOP/s, one exponential a causal pair and key dim
   over the SFUs), and each pass's device time by kernel name over 20
   profiled calls; registers, local and shared memory and blocks per SM of
   each pass at hd 32 and 64.
63. rwkv6-3b train step — full width and depth (3,832,545,280
   parameters), batch 1 x 2048, remat: phase 12's check of the loss and
   every gradient through ``impl="kernel"`` (the WKV forward and backward
   kernels) against ``impl="ref"`` (autograd through the plain chunked
   form), a control whose first layer drops its WKV state every 256
   tokens beyond; 32 ``wkv6_bwd`` and at least 32 ``wkv6`` launches.
64. rwkv6-3b train run — phase 13 at 4 x 2048 with remat for 5 steps
   (57.11 GiB of training state at 16 B a parameter, printed first), with
   its profiled step's ``wkv6`` / ``wkv6_bwd`` launches.
65. deepseek-v2-lite-16b train — 3 of 27 layers (``DEEPSEEK_TRAIN_LAYERS``,
   2,173,972,480 parameters), batch 4 x 2048 (capacity 960 a expert):
   the share of assignments each layer's capacity dispatch drops, phase
   12's check (its control: the first layer's MoE routes to top 5), then
   a 5-step run whose profiled step runs the MoE inside the ``moe`` range:
   its launch calls, host syncs (none allowed) and device time.
66. jamba-v0.1-52b sub-layers — one Mamba, the attention (flash forward
   and backward at hd 128, G 4) and one MoE sub-layer (16 experts, top 2,
   capacity dispatch), each with its norm, at full width: forward and
   backward at 1 x 1024 in bf16 against a float32 copy: the sub-layer's
   output within 2% per token, every weight's (and the input's) gradient
   within 5% of its norm; controls beyond (Mamba: the last sixteenth of
   its inner channels dropped at ``out_proj``; attention: the diagonal key
   masked; MoE: top 1).
67. internvl2-1b train run — phase 13 for 5 steps at 4 x 2048 (256 prefix
   rows and 1,792 tokens a row), full depth (493,752,448 parameters).

Then the dense KV-cache path (``api.init_decode_state``, ``api.prefill``,
``api.decode_step``), which serves the windowed configs that have no page
plane (``dense KV-cache path`` prints the phase spans and peaks):

68. row 9 at the path's prefill shapes, bf16 — gemma3-12b's local layers
   (B 2, T 3,000, 16 heads on 8 of 256, window 1,024), its global layers
   (window 0) and aqua-mistral-7b's (B 1, T 4,608, 32 heads on 8 of 128,
   window 4,096): the flash forward against its plain version within
   3e-2, the diagonal-masked control beyond, two launches bit-identical,
   device times (plain, kernel, kernel, plain) beside the library
   attention under the same window as an explicit mask and the bound (4
   FLOP a causal pair in the window, head dim and query head over 989
   TFLOP/s); under ``dense_cache`` in the ``flash_attention`` entry.
69. gemma3-12b at full width and depth (48 layers, 5 local to 1 global,
   qk-norm; 11,765,391,360 by the formula, the module 3,840 + 24,576
   norm scales more): the cache for B 2, seq 4,096 (local layers 1,024
   slots, global 4,096: 1,207,959,552 B against 3,221,225,472 B for a
   full cache); then two seeded 3,000-token prompts (past the window, so
   the rings roll) and one decode step driven layer by layer
   (``dense_layer_check``): every layer's attention and MLP, prefilling
   and decoding, within 2% per token of a float32 copy of the layer fed
   the same input and cache, a control (layer 0's copy with no window)
   beyond, every local ring's slot j holding the K of the last position
   p with p mod 1,024 = j, exactly; then the main path, ``api.prefill``
   and 64 ``api.decode_step``s (launch counts reset before each, read
   after: 48 flash launches a prefill), its logits equal to the layer
   check's bit for bit; prefill wall, decode-step p50/p99, peak memory;
   one more decode step and a prefill profiled.
70. aqua-mistral-7b at full width and depth: phase 69 at B 1, seq 8,192,
   a 4,608-token prompt (536,870,912 B of cache against 1,073,741,824
   B; 32 flash launches a prefill).
71. the reference's gate (``test_arch_smoke.py:52``) in float32 at full
   width: gemma3-12b at 6 of 48 layers (one group) and mistral at 4 of
   32, a prompt past the window (1,100 / 4,200 tokens) then 16 / 8
   decode steps, each step's logits within 1e-4 of the row's norm of the
   training forward's at the same position (the two orders of one
   float32 computation); a control decoding at pos + 1 beyond.

Then the link terms, the paper's figures and AQUA-PLACER (``link legs,
paper sim, placer`` prints the phase spans and peaks):

72. link legs — an ``AquaTensor`` with aqua-llama2-13b's kv pages
   (327,680 B) whose LOCAL pool, same-card REMOTE slab and pinned host
   pool each hold 2,048 pages (671 MB). At 1, 2, 4, ..., 2,048 pages the
   runtime's own moves (``offload(prefer=HOST)`` / ``ensure_local``: row 6
   and the host copy, the host copy and row 7; ``offload(prefer=REMOTE)``
   / ``ensure_local``: rows 6 and 7), each timed wall to wall with
   ``torch.cuda.synchronize()`` on both sides, median of 5 after a warm
   round trip; every round trip bit-identical, every move metered as its
   pages' bytes in one message through one gather and/or one scatter.
   Beside each size a pinned ``copy_`` of the same bytes each way and the
   slab's HBM bound (2 x bytes / 3.35 TB/s). ``fit_link_model`` fits the
   host samples of both directions (``calibrate_profile(H100_SXM,
   host_samples=...)``) and the slab samples, printed as a same-card
   slab, not NVLink.
73. paper sim — ``ServingSimulator`` under ``A100_NVLINK``, ``H100_SXM``
   and phase 72's calibrated profile: aqua-codellama-34b on 80 Poisson
   requests (Fig. 9 / 1b: vllm over host, cfs over the fabric and over
   host; TTFT p50/p90, RCT p50 and their ratios) and aqua-opt-30b's
   decode throughput at 8,000 tokens (Fig. 7, fabric over host). The
   reference's gates asserted on ``A100_NVLINK``; every run finishes.
74. placer serve — ``place`` (bnb) of two LLM consumers and two
   producers on 2 servers of 2 GPUs, its pairs on a
   ``Coordinator(strict_pairing=True)``, the paired producer's spare
   memory offered by a ``BatchInformer``; aqua-llama2-13b at full width
   and depth on a 4 GiB grant (CFS, REMOTE offload, ``audit=True``)
   serves 6 requests through rows 1-7; the producer reclaims at the first
   step with pages on its lease: the reclaim completes, no REMOTE page is
   left, every request finishes, an audit every step and one at the end
   clean.

Then whisper-tiny, the encoder-decoder family, and windowed training
(``whisper and windowed training`` prints the phase spans and peaks):

75. row 9 at whisper-tiny's shapes (6 heads on 6 of 64), float32 and
   bf16: the encoder's bidirectional (4, 1,500), the cross-attention at
   prefill (4 rows, then 1 row at decode, against 1,500 keys), the
   decoder's causal (8, 448), and forward and backward at the training
   shapes (8, 1,500) bidirectional, (8, 448) causal and (8, 448 -> 1,500)
   cross: the forward within phase 11's limits of its plain version, the
   backward's dq/dk/dv within its limits of the plain formula's norm, a
   control (each query row's heaviest visible key dropped) beyond both;
   device times (plain, kernel, kernel, plain) beside the library
   attention on the same shape (``library_attention_ms``) and the bound (4
   FLOP a visible pair, head dim and query head forward, 10 backward,
   over 989 TFLOP/s); under ``whisper`` in the ``flash_attention`` and
   ``flash_attention_bwd`` entries.
76. whisper-tiny served at full width and depth, bf16, through
   ``api.init_decode_state`` / ``prefill`` / ``decode_step``: B 4, seeded
   frame embeddings (4, 1,500, 384), 4-token prompts decoded greedily to
   448 positions (launch counts reset before the prefill and before the
   decode, read after: 12 flash launches a prefill, 4 a decode step);
   prefill ms (after a warm-up prefill), decode-step p50/p99, tokens/s,
   peak memory, cache bytes, the last step profiled. Both engines (``ServingEngine``,
   ``PagedStateRuntime``) raise ``ValueError``. The gate, a float32 copy:
   each decode step's logits (teacher-forced to 448) and the prefill's
   within phase 71's 1e-4 of the row's norm of the training forward's at
   the same position; a control decoding with the cross cache zeroed
   beyond.
77. whisper-tiny train step at 8 x 448 decoder tokens over 1,500 frames:
   phase 12's check (loss 2e-2, every gradient 5e-2 of its norm, kernel
   against plain; the control masks the diagonal key of decoder layer 0's
   self-attention); ``compress_tree`` of the step's gradients on the card
   bit-equal to the same call on CPU copies, every error buffer within
   1.01 x its scale; then phase 13's 10-step run (p50, tokens/s, peak
   memory, row 9 forward and backward launches a step, one step
   profiled).
78. windowed training on the card, kernel against plain: gemma3-12b at
   its width cut to one group (5 layers windowed at 1,024, 1 global) at
   1 x 2,048, aqua-mistral-7b at its width cut to 2 layers at 1 x 4,608
   (the window of 4,096 binds): in bf16 at phase 12's limits, then a
   float32 copy at 1e-4 on the loss and 1e-3 on every gradient's norm,
   a control (layer 0 attending with no window) beyond the float32
   limits; 5 kernel train steps each (p50, peak memory); row 9's forward
   and backward at each windowed shape checked and timed as in phase 75.
79. the mesh tier legs: a ``MeshTierDomain`` over two distinct cards
   where there are two, else ``[cuda:0, cuda:0]`` (one H100 is one
   device: the "peer" is the same card, a leg a same-HBM ``copy_`` plus
   rows 6 and 7, not NVLink; the phase prints which). Phase 72's
   ``AquaTensor`` (aqua-llama2-13b kv pages, 327,680 B) with ``mesh=``
   the domain beside phase 72's slab, 1-2,048 pages, alternating: every
   round trip bit-identical, each move one leg on the wire, one fabric
   message, one row 6 and one row 7 launch; median wall per move; the
   domain's own leg samples fitted by ``calibrated_profile(H100_SXM)``.
   Its launches are the ``mesh tier legs`` path.
80. the engine over the domain: phase 74's aqua-llama2-13b serve at
   full width and depth (6 requests, CFS, REMOTE, a 4 GiB lease,
   ``audit=True``) without a mesh and over a domain on the datasheet
   clock (the ``mesh engine`` path), then ``calibrate_clock()`` fitted to
   that run's legs: greedy tokens and every request's final pages
   (digested as it retires) equal, legs on the wire equal to priced
   fabric messages; step p50s and the simulated TTFT p50s (relative only)
   printed.
81. ``compressed_psum`` over seeded gradients at every parameter shape
   of qwen1.5-0.5b on an NCCL group of world size 1 (a ``HashStore``, no
   socket), two rounds of error feedback, bit-equal to
   ``decompress(compress())`` on the card and on CPU copies, ms a tree
   and wire bytes; then ``reshard_for_mesh`` of its host-resident
   parameters onto ``make_debug_mesh(1)``, bytes a device.
82. the roofline against the card: four cells of the dry run
   (``launch/dryrun.py``) at a batch one card holds — qwen1.5-0.5b
   ``train_4k`` at B 4 (row 9 forward and backward), ``prefill_32k`` at
   B 1 (row 9), ``decode_32k`` at B 8, rwkv6-3b ``long_500k`` at B 1 (row
   8's decode) — each traced on the ``meta`` device, then built on the
   card (random seeded weights, ``api.instantiate``'s tokens, a zeroed
   cache) and run 2 + 5 times, the 5 timed by CUDA events. Per cell: the
   p50, the trace's ``t_compute`` and ``t_memory`` (``analysis/
   roofline.py`` on ``H100_SXM``), the achieved share of 989 TFLOP/s and
   of 3.35 TB/s, and the trace's argument + temp bytes beside
   ``torch.cuda.max_memory_allocated``. It fails when the larger roofline
   term exceeds 1.05 x the p50 (a bound above the time means a wrong
   count) or when a kernel's launches differ from the trace's entries x
   7. Meanwhile, in a worker process, ``dryrun.main`` on the ``h100`` mesh
   for the qwen1.5-0.5b and rwkv6-3b rows (the whole dry run takes longer
   than 120 s on a CPU); then ``report.summarize`` of them.
83. the partitioned serving step (``api.prefill`` / ``api.decode_step``
   with ``shard_axes``, ``distributed/partition.py``). (a) On an NCCL
   group of world size 1 (a ``HashStore``) over a (1, 1, 1) mesh: qwen1.5-
   0.5b at full width and depth (a prefill of 2 x 2,048, 16 greedy decode
   steps) and dbrx-132b at 8 of 40 layers under FSDP (2 x 512, 8 steps:
   expert parallelism and the FSDP gather at a group of one), each held
   to the unpartitioned step on the same weights: greedy tokens equal and
   every step's logits bit for bit (phases 69-70's rule), the shards
   sharing the model's storage, one row 9 launch a layer in the prefill;
   and deepseek-v2-lite-16b at 4 of 27 layers (MLA, one
   dense and three MoE layers), jamba-v0.1-52b at 8 of 32 (one group:
   attention, Mamba, MoE) under FSDP, rwkv6-3b and whisper-tiny (over
   1,500 frames) at full width and depth, 2 x 512 and 8 steps each, every
   run launching what its unpartitioned run launches. (b) Rank 0 of
   ``pod256`` at its own per-device shapes under a fake process group of
   256 (its collectives move no bytes: the rank's local work with no
   wire, values unchecked): qwen1.5-0.5b ``decode_32k`` (8 lanes, one kv
   head), ``prefill_32k`` (2 x 32,768, one head through row 9), dbrx-132b
   ``decode_32k`` at 8 of 40 layers, deepseek
   ``decode_32k`` at 4 layers, jamba ``decode_32k`` at 8, rwkv6-3b
   ``long_500k`` (the key-slice WKV, 4 of each head's 64 key rows) and
   whisper-tiny ``decode_32k``, each traced on
   ``meta`` by ``dryrun.build_cell`` and run on instantiated shards 2 + 5
   times (CUDA events): the p50 beside the per-device traced bound, the
   launches equal to the trace's entries x 7, the shards' bytes equal to
   the record's arguments and ``max_memory_allocated`` (less what earlier
   phases still hold) within 5% of the trace's arguments + temporaries.
   Then row 9 at that rank's prefill shape (2 x 32,768, one head of 64 on
   one kv head, causal) and at dbrx-132b's prefill shape of (a) (2 x 512,
   48 heads of 128 on 8 kv heads, causal) through phase 75's check and
   timing (float32 and bf16 against the plain
   version, the heaviest-key control; kernel, plain, library and bound
   ms), under ``partition`` in the ``flash_attention`` record, and at
   whisper-tiny's rank shapes (one head: the encoder over 1,500
   frames, the cross-attention of 8 decode rows against them). (c) The
   key-slice WKV forward (``csrc/wkv6_keyslice.cu``: 32-token chunk sums,
   a scan over the chunks, a chunk pass) against its plain twin at
   rwkv6-3b's rank shapes, prefill (2, 32,768, 40 heads, K 4, V 64) and
   decode (8, 1, 40, 4, 64), at row 8's limits with a zeroed-state
   control beyond them; kernel, plain and bound ms in its
   ``wkv6_keyslice`` record; then each of its three
   kernels alone against its plain twin (``keyslice_pass_checks``: T 1,
   31, 32, 33, 1,031 at K 4, 8, 16, float32 and bf16, and the prefill
   shape), each with a control beyond its limit, and their ``*_info``.
84. the partitioned train step (``make_train_step`` with
   ``TrainConfig.shard_axes``: FSDP rules, sequence parallelism, remat,
   micro-batches, the vocab-parallel cross-entropy, data-parallel
   gradients, the global clipping norm). (a) On an NCCL group of world
   size 1 over a (1, 1, 1) mesh, two steps against two unpartitioned
   steps from the same seeded weights and batches: qwen1.5-0.5b at full
   width and depth (4 x 2,048, 4 micro-batches), internvl2-1b at full
   width and depth (4 x 1,024: 256 prefix rows, 2 micro-batches) and
   gemma3-12b at 6 of 48 layers (2 x 2,048, 2 micro-batches: five
   windowed layers and a global one), deepseek-v2-lite-16b at 3 of 27
   layers (4 x 1,024, 2 micro-batches: MLA and the expert-parallel MoE)
   and jamba-v0.1-52b in two layers at full width (1 x 512: attention +
   MLP, then Mamba + the MoE, a hybrid period of 2), rwkv6-3b at 4 of 32
   layers at full width (4 x 2,048, 2 micro-batches: at a group of one
   the square WKV and its backward, rows 8 and 8b) and whisper-tiny at
   full width and depth (8 x 448 over 1,500 frames, 2 micro-batches);
   every step's loss and grad norm, then every parameter and AdamW moment
   bit for bit (on the card up to 16 GiB of state, else equal checksums
   of their bits), the same launches, row 9's forward and backward among
   them where the config has attention, and the same share of assignments
   dropped per MoE layer; the host wall of both. (b) Rank 0 of ``pod256``
   in ``train_4k`` (16 of the 256 rows: its rows of 4 micro-batches of
   64, 4 x 4,096 each) under a fake process group, traced on ``meta`` and
   run as phase 83(b) runs a serving cell, twice (the p50 of 2; their
   meta traces meanwhile in worker processes while (a) runs):
   qwen1.5-0.5b (one head a rank), dbrx-132b at 8 layers,
   deepseek-v2-lite-16b at 4, jamba-v0.1-52b at 8 (one hybrid period),
   rwkv6-3b at 8 of 32 (4 of each head's 64 key rows: the key-slice WKV
   forward and backward kernels) and whisper-tiny (the covered route: one
   head a rank). (c) Row 9 at those ranks' micro-batch shapes (4 x 4,096,
   causal: qwen one head of 64 on one kv head, dbrx 3 heads of 128 on
   one, jamba 2 on one; whisper-tiny's encoder over 1,500 frames and its
   cross-attention of 4,096 rows against them, one head of 64; its
   decoder's self-attention is qwen's shape), forward and backward,
   through phase 75's check and timing, under ``partition_train`` in the
   ``flash_attention`` and ``flash_attention_bwd`` records. (d) The
   key-slice WKV backward (``csrc/wkv6_keyslice_bwd.cu``: chunk sums, the
   scan both ways, a chunk pass) against its plain twin (the rectangular
   ``wkv6_backward_plain``) at the ``pod256`` rank's rwkv6-3b
   ``train_4k`` micro-batch (4, 4,096, 40 heads, K 4, V 64) in bf16 and
   at (2, 1,031, 40, 8, 64) in float32, weak and strong decays: dr, dk,
   dv, dw, du and dstate within row 8b's limits (bf16 2e-2 of the plain
   norm, per 32 tokens; float32 rtol 1e-3 atol 5e-4), a control (the
   kernel on a dy with one token zeroed) beyond them; each of its kernels
   and state passes alone against its plain twin as in (c), at the
   micro-batch too, with their ``*_info``; ``wkv6_keyslice`` forward and
   backward through autograd (the ``WKV6KeySlice`` op) against autograd
   of the plain forward; kernel, plain and bound ms of the backward (its
   ``wkv6_keyslice_bwd`` record) and of the forward at that shape
   (``wkv6_keyslice``'s ``train`` case), and each pass's kernel ms there
   from the profiler.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or run outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
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


def release(torch):
    """Free a family's tensors before the next family's phases: engines
    and runtimes hold reference cycles, so their pools wait for the cycle
    collector (~25 GiB after the rwkv phases otherwise)."""
    gc.collect()
    torch.cuda.empty_cache()


def model_laps(torch, label, t0):
    """A model's phase spans: ``lap(name)`` closes the running phase (its
    wall and ``torch.cuda.max_memory_allocated`` since the last lap; an
    engine phase resets the peak just before its run), ``done()`` prints
    them."""
    spans, t = {}, [time.perf_counter()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def lap(name):
        torch.cuda.synchronize()
        spans[name] = {"s": round(time.perf_counter() - t[0], 1),
                       "peak_gib": round(torch.cuda.max_memory_allocated()
                                         / 2 ** 30, 2)}
        torch.cuda.reset_peak_memory_stats()
        t[0] = time.perf_counter()

    def done():
        print(f"{label} phase spans (s) and peak memory (GiB): "
              f"{json.dumps(spans)}; done at {time.perf_counter() - t0:.1f} "
              f"s")
    return lap, done


def one_writer_a_layer(label, launches):
    """The fused step launches the page writer once per attention layer per
    step: as many row-5 launches as row-4 launches."""
    if launches["append_kv"] != launches["paged_mixed_attention_pool"]:
        raise AssertionError(
            f"{label}: {launches['append_kv']} page-writer launches, not one "
            f"per attention layer per step "
            f"({launches['paged_mixed_attention_pool']} mixed attention "
            f"launches)")


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


def per_request_kernels(torch, np, pool, rng, g, H, read_pps):
    """The per-request kernels at the engine's shapes, each against its
    plain version and timed; decode over the split halves against decode
    over the pool, and both per-request kernels against one mixed launch,
    bit for bit. Returns {kernel: record}."""
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
    records = {"paged_prefill_attention_pool": dict(
        name="paged_prefill_attention_pool", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:245",
        **{**cases[512], "max_abs_err": max(c["max_abs_err"]
                                            for c in cases.values())},
        mid_page=cases[200])}

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
    records["paged_attention_pool"] = dict(
        name="paged_attention_pool", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:157", shape=shape, max_abs_err=err,
        tolerance=3e-2, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None)
    dec_split = pa_ops.paged_attention(q, k_half, v_half, bt, lengths)
    err = check("paged_attention", dec_split,
                pa_ref.paged_attention_ref(q, k_half, v_half, bt, lengths))
    ms, plain_ms = interleaved(
        lambda: pa_ref.paged_attention_ref(q, k_half, v_half, bt, lengths),
        lambda: pa_ops.paged_attention(q, k_half, v_half, bt, lengths), 10)
    records["paged_attention"] = dict(
        name="paged_attention", route="cuda", source=KERNEL_SRC,
        replaces=f"{TPU_SRC}:454", shape=shape + " (split K/V views)",
        max_abs_err=err, tolerance=3e-2, ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None)

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
    return records


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


def mla_leg_shape(dcfg):
    """Rows 6-7 at deepseek-v2-lite-16b's ``mla`` leg: one request's park
    of ~800 tokens (50 pages of 16 tokens a layer, 27 layers) of 18,432 B
    pages, (16, 576) bf16 — a 16 KiB chunk and a 2,048 B tail a row on the
    bulk route. In ``gather_leg_shapes``' form."""
    from repro_torch.layers.mla import latent_dim
    return {"deepseek_mla": ((16, latent_dim(dcfg)),
                             dcfg.torch_compute_dtype(), dcfg.n_layers * 50,
                             0)}


def gather_leg_inputs(torch, qcfg, rcfg, dev, shapes=None):
    """Per leg shape (``shapes``, default ``gather_leg_shapes``): (leg,
    pool, id sets, bytes a call moves). The ids come in disjoint sets,
    enough that more than ``ROTATION_BYTES`` move between two uses of one
    set and of its staging buffer when they are taken in turn (the L2
    holds 50 MB; the engine finds a parked request's pages cold)."""
    import math
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = shapes or gather_leg_shapes(torch, qcfg, rcfg)
    for leg, (page, dtype, n, P) in shapes.items():
        row = math.prod(page) * dtype.itemsize
        call_bytes = 2 * n * row + 4 * n
        sets = math.ceil(ROTATION_BYTES / call_bytes) + 1
        P = max(P, sets * n + 1)
        pool = torch.randn((P,) + page, generator=g, device=dev).to(dtype)
        perm = torch.randperm(P - 1, generator=g, device=dev) + 1
        yield (leg, pool, list(perm[:sets * n].to(torch.int32).view(sets, n)),
               call_bytes)


def gather_legs(torch, np, kv_ops, kv_ref, qcfg, rcfg, dev, shapes=None):
    """Row 6 at each leg shape, cold (``gather_leg_inputs``): on every id
    set bit-exact against the plain version; then device times over the
    sets in turn (plain, kernel, kernel, plain) and ``REPEATS`` rounds
    beside ``index_select``."""
    legs = {}
    for leg, pool, id_sets, call_bytes in gather_leg_inputs(
            torch, qcfg, rcfg, dev, shapes):
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


def print_gather_resources(torch, kv_ops, qcfg, rcfg, shapes=None):
    """The bulk-copy gather's plan, registers, local memory and ring at each
    leg shape; it must use no local memory and fit the card's opt-in shared
    memory per block."""
    import math
    shapes = shapes or gather_leg_shapes(torch, qcfg, rcfg)
    for leg, (page, dtype, n, _) in shapes.items():
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
    report.extend(per_request_kernels(torch, np, pool, rng, g, H,
                                      read_pps).values())

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


def per_layer_attention(torch, cfg, model, x, pool, attend, real, keep,
                        layer_f32=False):
    """Run the layers from input ``x`` on a copy of ``pool``; at each layer,
    on the same input and pool, the attention through the kernels, through
    the plain versions and through the plain versions' control
    (``attend(mix, h, pool, layer, impl, control) -> (out, pool)``). The
    plain output carries the layer on. Returns each layer's largest
    per-token distance to the plain output over the ``real`` tokens,
    relative to that token's largest output, for the kernel and for the
    control, and whether the pages written by the kernel and plain paths
    are equal over the ``keep`` slots. With ``layer_f32`` also each one's
    distance to a float32 copy of the layer's attention run by the plain
    versions on the same input and pool in float32 (``kernel_f32``,
    ``control_f32``), and, for a dense MLP, the layer's MLP on its normed
    input against a float32 copy of it (``mlp_f32``), a control beyond
    (``mlp_control_f32``: the float32 copy without its last sixteenth of
    hidden units, as a product that lost its last tile of the
    reduction)."""
    from repro_torch.layers.core import MLP, mlp, rms_norm
    from repro_torch.models import lm
    p_ref = pool.clone()
    rel = {"kernel": [], "control": []}
    if layer_f32:
        rel.update(kernel_f32=[], control_f32=[], mlp_f32=[],
                   mlp_control_f32=[])
    pages_equal = True
    for layer, blk in enumerate(model.blocks):
        h = rms_norm(blk.n1, x, cfg.rmsnorm_eps)
        out_k, p_k = attend(blk.mix, h, p_ref.clone(), layer, "kernel", False)
        # [0]: each copy of the pool is dropped as soon as its call returns
        out_c = attend(blk.mix, h, p_ref.clone(), layer, "ref", True)[0]
        outs = [("kernel", out_k), ("control", out_c)]
        if layer_f32:
            out_32 = attend(copy.deepcopy(blk.mix).float(), h.float(),
                            p_ref.float(), layer, "ref", False)[0]
        out_r, p_ref = attend(blk.mix, h, p_ref, layer, "ref", False)
        scale = out_r.float().abs().amax(-1).clamp_min(1e-6)
        for name, o in outs:
            d = (o.float() - out_r.float()).abs().amax(-1) / scale
            rel[name].append(d[real].max().item())
        if layer_f32:
            scale = out_32.abs().amax(-1).clamp_min(1e-6)
            for name, o in outs:
                d = (o.float() - out_32).abs().amax(-1) / scale
                rel[f"{name}_f32"].append(d[real].max().item())
            del out_32
        pages_equal &= torch.equal(p_k[keep], p_ref[keep])
        del p_k
        x = x + out_r
        h2 = rms_norm(blk.n2, x, cfg.rmsnorm_eps)
        ffn_out = lm.ffn_apply(blk.ffn, cfg, h2)
        if layer_f32 and isinstance(blk.ffn, MLP):
            ffn32 = copy.deepcopy(blk.ffn).float()
            want = mlp(ffn32, cfg, h2.float())
            cut = ffn32.up.w.shape[1] * 15 // 16
            for lin, dim in ((ffn32.up, 1), (ffn32.gate, 1),
                             (ffn32.down, 0)):
                if lin is not None:
                    lin.w.data = lin.w.data.narrow(dim, 0, cut)
            ctrl = mlp(ffn32, cfg, h2.float())
            for name, o in (("mlp_f32", ffn_out),
                            ("mlp_control_f32", ctrl)):
                rel[name].append(rel_per_token(torch, o, want, real))
            del ffn32, want, ctrl
        x = x + ffn_out
    return rel, pages_equal


def phase_layer_step(torch, np, cfg, model, dev, prefix=False,
                     whole_f32=True):
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
    further.

    ``prefix`` (a VLM): the chunk rows take seeded prefix embedding rows at
    their positions below ``n_prefix_embeds`` (``lm.embed_rows``), every
    path the same block. Without ``whole_f32`` (a model whose float32 copy
    does not fit beside it) the float32 yardstick is per layer instead: the
    attention through the kernels within ``LAYER_REL_LIMIT`` per real token
    of a float32 copy of the layer on the same input and pool, the control
    beyond; the whole step's logits against the plain path's are printed
    (the control drops one of 44 pages of one lane, below the rounding
    that 28 bf16 layers carry into logits of up to ~20)."""
    from repro_torch.layers import attention as attn
    from repro_torch.models import api, lm
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
    pre = None
    if prefix:
        # every chunk row its own seeded image, the decode rows none
        pre = 0.02 * torch.randn((R, cfg.n_prefix_embeds, cfg.d_model),
                                 generator=g, device=dev)
        pre[:n_dec] = 0.0
        pre = pre.to(cfg.torch_compute_dtype())
    x = lm.embed_rows(model, cfg, torch.as_tensor(tokens).to(dev), q_starts,
                      pre)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")

    def attend(mix, h, p, layer, impl, control):
        c = cfg32 if h.dtype == torch.float32 else cfg
        return attn.attention_mixed_paged(
            mix, c, h, p, bt_dev[layer, 0], q_starts, n_reals,
            n_decode=n_dec, read_pps=short_pps if control else read_pps,
            impl=impl, meta=meta)
    rel, pages_equal = per_layer_attention(torch, cfg, model, x, pool,
                                           attend, compared, slice(1, None),
                                           layer_f32=not whole_f32)
    lk, lc = max(rel["kernel"]), min(rel["control"])
    print(f"layer step, per layer ({L} layers, R={R} Tc={Tc}"
          f"{', prefix rows' if prefix else ''}): attention "
          f"output max per-row relative diff to plain: kernel {lk:.4g} "
          f"(layers {', '.join(f'{v:.3g}' for v in rel['kernel'])}); "
          f"control reading {short_pps} of {read_pps} pages, least "
          f"{lc:.4g} (layers {', '.join(f'{v:.3g}' for v in rel['control'])})"
          f"; written pages equal: {pages_equal}")
    if not whole_f32:
        k32, c32 = max(rel["kernel_f32"]), min(rel["control_f32"])
        m32, mc32 = max(rel["mlp_f32"]), min(rel["mlp_control_f32"])
        print(f"layer step, per layer against a float32 copy of the layer's "
              f"attention: kernel {k32:.4g} (layers "
              f"{', '.join(f'{v:.3g}' for v in rel['kernel_f32'])}); "
              f"control least {c32:.4g}; the layer's {cfg.activation} MLP "
              f"against a float32 copy of it: {m32:.4g} (layers "
              f"{', '.join(f'{v:.3g}' for v in rel['mlp_f32'])}); control "
              f"(the last sixteenth of its hidden units dropped) least "
              f"{mc32:.4g}")
        if not k32 <= LAYER_REL_LIMIT < c32:
            raise AssertionError(
                f"layer step: kernel vs the float32 layer {k32} must be "
                f"within {LAYER_REL_LIMIT}, and the control ({c32}) beyond")
        if not m32 <= LAYER_REL_LIMIT < mc32:
            raise AssertionError(
                f"layer step: the MLP vs its float32 copy {m32} must be "
                f"within {LAYER_REL_LIMIT}, and the control ({mc32}) beyond")

    # -- whole step against float32 ----------------------------------------
    runs = {"ref": (model, cfg, "ref", read_pps),
            "kernel": (model, cfg, "kernel", read_pps),
            "control": (model, cfg, "ref", short_pps)}
    if whole_f32:
        runs["f32"] = (copy.deepcopy(model).float(), cfg32, "ref", read_pps)
    real = np.nonzero(n_reals > 0)[0]
    outs = {}
    for name, (mdl, c, impl, pps) in runs.items():
        p = pool.clone().to(c.torch_compute_dtype())
        logits, _ = api.serve_step_paged(
            mdl, c, tokens, {"kv": p}, {"kv": bt}, q_starts, n_reals,
            n_decode=n_dec, read_pps=pps, impl=impl,
            prefix_embeds=(None if pre is None
                           else pre.to(c.torch_compute_dtype())))
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
            n_reals, n_decode=n_dec, read_pps=read_pps, impl="kernel",
            prefix_embeds=pre)
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

    base = "f32" if whole_f32 else "ref"

    def rows(name):
        d = (outs[name] - outs[base]).abs().amax(-1)[real]
        return [round(v, 4) for v in d.tolist()]
    dist = {name: rows(name) for name in outs if name != base}
    agree = (outs["kernel"][real].argmax(-1)
             == outs[base][real].argmax(-1)).float().mean().item()
    print(f"layer step, whole: logits |{base}| max "
          f"{outs[base][real].abs().max().item():.3g}; per real row max abs "
          f"diff to {base}: {json.dumps(dist)}; argmax agreement of the "
          f"kernel path with {base} {agree:.3f}")
    if not pages_equal:
        raise AssertionError("layer step: pages written by the kernel path "
                             "differ from the plain path's")
    if not lk <= LAYER_REL_LIMIT < lc:
        raise AssertionError(
            f"layer step: kernel vs plain {lk} must be within "
            f"{LAYER_REL_LIMIT}, and the one-page-short control ({lc}) "
            f"beyond it")
    if not whole_f32:
        return
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
PER_REQUEST_ROWS = ("paged_prefill_attention_pool", "paged_attention_pool",
                    "append_kv")                # rows 3, 2, 5


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
        if step == 0:
            run["first_step_logits"] = lg.float()
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


def phase_per_request(torch, np, cfg, model, dev, whole_f32=True):
    """The per-request serving path at full width (module docstring, phase
    5). Without ``whole_f32`` (a model whose float32 copy does not fit
    beside it) the whole prefills are not held against float32; the
    per-layer checks, the split-pool drive and the fused engine beside it
    stay. Returns {kernel: launches} of its run and of the split-pool
    drive."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as pa_ops
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
    if not all(launches.get(k, 0) > 0 for k in PER_REQUEST_ROWS):
        raise AssertionError(f"per-request run never launched some of "
                             f"{PER_REQUEST_ROWS}")
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
    if not whole_f32:
        del run_ref
        return phase_fused_beside(torch, np, cfg, model, dev, prompts,
                                  run["tokens"], launches, split_launches)
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
    return phase_fused_beside(torch, np, cfg, model, dev, prompts,
                              run["tokens"], launches, split_launches)


def phase_fused_beside(torch, np, cfg, model, dev, prompts, tokens,
                       launches, split_launches):
    """Phase 5's prompts through the fused step (an FCFS engine), its walls
    and launches beside the per-request run's greedy ``tokens``."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedStateRuntime
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
             for r, t in zip(reqs, tokens)]
    print(f"greedy tokens, per-request vs fused, agreeing per prompt "
          f"{list(PROMPTS)}: {agree} of {DECODE_STEPS + 1} each "
          f"({sum(agree)} of {len(agree) * (DECODE_STEPS + 1)})")
    if not all(len(r.generated) == DECODE_STEPS + 1 for r in reqs):
        raise AssertionError("fused: not every request finished")
    return launches, split_launches


LEASE_BYTES = 2 * 1024 ** 3          # phase 6's same-card donor lease


def make_runtime(cfg, dev, host_pages, mesh=None):
    """Phase 6's paged runtime: 16-token pages, 1,024-token contexts, four
    lanes; logical ids cover the LOCAL pool and every parked page (qwen: 24
    layers x up to 50 pages x 12 requests, plus the pool itself). With
    ``mesh`` its REMOTE slabs live on the domain's donor entries (the
    keyword is passed only then, so ``scripts/engine_ab.py`` can drive a
    checkout older than the domain)."""
    from repro_torch.serving.kv_cache import PagedStateRuntime
    extra = {} if mesh is None else {"mesh": mesh}
    return PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=4,
                             host_pages=host_pages, n_logical=32768,
                             prefix_cache=False, device=dev, **extra)


def make_engine(np, cfg, model, dev, *, host_pages=1024, coordinator=None,
                want_remote_bytes=0.0, lease_bytes=LEASE_BYTES, n_req=12,
                **engine_kw):
    """The 12-request CFS engine of phase 6 (a same-card REMOTE donor
    lease of ``lease_bytes``, 2 GiB by default, seeded prompts of 128-768
    tokens, 32 new tokens each; ``n_req`` takes the first of them).
    With a ``coordinator`` the lease is the coordinator's grant of
    ``want_remote_bytes`` instead, polled for reclaims every step;
    ``engine_kw`` (faults, audit, admission, ...) go to the engine; a
    ``mesh`` goes to the runtime.
    A VLM's requests each carry a seeded prefix block (std 0.02, the token
    embeddings' scale) ahead of a text prompt shorter by its rows, so every
    request fits the 1,024-token context.
    Returns (engine, runtime, requests)."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.serving.engine import ServingEngine
    new_tokens = 32
    P = cfg.n_prefix_embeds
    kv = make_runtime(cfg, dev, host_pages, engine_kw.pop("mesh", None))
    eng = ServingEngine(cfg, model, max_running=4, max_seq=1024,
                        scheduler="cfs", slice_tokens=8, step_tokens=256,
                        offload_tier=REMOTE, kv=kv, spec_chunk_ahead=False,
                        coordinator=coordinator,
                        want_remote_bytes=want_remote_bytes, respond_every=1,
                        device=dev, **engine_kw)
    if coordinator is None:
        eng.pager.add_remote_lease("donor0", lease_bytes)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(128, 769))
        pre = None
        if P:
            n = max(n - P, 16)
            pre = 0.02 * np.random.default_rng(100 + i).standard_normal(
                (P, cfg.d_model)).astype(np.float32)
        reqs.append(eng.submit(list(map(int, rng.integers(0, cfg.vocab_size,
                                                          n))),
                               new_tokens, arrival=0.01 * i,
                               prefix_embeds=pre))
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
        # a record_function range shows on the device timeline too: it is
        # no kernel
        device = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.elapsed_us() > 0
                  and e.name not in RANGES]
        if not device:
            out[kind] = {"step_wall_ms": wall_us / 1e3,
                         "device": "not measured", **host_calls(prof)}
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
            "top5_ms": summary["top10_ms"][:5],
            **host_calls(prof)}
        for name in RANGES:
            spans = [(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and e.name == name]
            if not spans:
                continue
            # the range on the device timeline: from each call's first
            # kernel to its last; and the kernels' time that starts inside
            inside = sum(b - a for _, a, b in device
                         if any(lo <= a <= hi for lo, hi in spans)) / 1e3
            out[kind][f"{name}_device_span_ms"] = sum(
                b - a for a, b in spans) / 1e3
            out[kind][f"{name}_device_ms"] = inside
            out[kind][f"{name}_device_share"] = (
                inside / summary["device_busy_ms"])
    return out


HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
MOE_RANGE = "moe"                   # the MoE's record_function range
SCAN_RANGE = "mamba_scan"           # the Mamba scan's record_function range
RANGES = (MOE_RANGE, SCAN_RANGE)


@contextlib.contextmanager
def profile_ranges(torch):
    """Within the block, each MoE feed-forward (the serving step's
    dropless one and the training forward's capacity dispatch) runs inside
    a ``record_function("moe")`` range and each Mamba scan (the chunked scan
    of ``mamba_forward`` and the step of ``mamba_decode``) inside a
    ``record_function("mamba_scan")`` range."""
    from repro_torch.layers import mamba as mamba_mod
    from repro_torch.layers.moe import MoE
    from repro_torch.models import lm

    def ranged(name, fn, when=None):
        def call(*args, **kw):
            if when is not None and not when(*args, **kw):
                return fn(*args, **kw)
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call
    saved = [(lm, "ffn_apply", lm.ffn_apply),
             (lm, "moe_apply", lm.moe_apply),
             (mamba_mod, "_chunked_ssm_scan", mamba_mod._chunked_ssm_scan),
             (mamba_mod, "_ssm_step", mamba_mod._ssm_step)]
    lm.ffn_apply = ranged(MOE_RANGE, lm.ffn_apply,
                          lambda p, *a: isinstance(p, MoE))
    # the training forward calls the capacity dispatch directly
    lm.moe_apply = ranged(MOE_RANGE, lm.moe_apply,
                          lambda *a, **kw: not kw.get("dropless", True))
    mamba_mod._chunked_ssm_scan = ranged(SCAN_RANGE,
                                         mamba_mod._chunked_ssm_scan)
    mamba_mod._ssm_step = ranged(SCAN_RANGE, mamba_mod._ssm_step)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def host_calls(prof):
    """From a profiled step's CPU events: kernel launches and host syncs
    (runtime calls), and, for each of ``RANGES`` the step ran inside, how
    many calls of the range and how many launches and syncs fell inside
    them."""
    from torch.autograd import DeviceType
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    launches = [e for e in cpu if "LaunchKernel" in e.name]
    syncs = [e for e in cpu if e.name in HOST_SYNCS]
    out = {"launch_calls": len(launches), "host_syncs": len(syncs)}
    for name in RANGES:
        spans = [(e.time_range.start, e.time_range.end) for e in cpu
                 if e.name == name]
        if not spans:
            continue

        def inside(evs):
            return sum(1 for e in evs if any(a <= e.time_range.start <= b
                                             for a, b in spans))
        out.update({f"{name}_calls": len(spans),
                    f"{name}_launch_calls": inside(launches),
                    f"{name}_launch_share": inside(launches)
                    / max(len(launches), 1),
                    f"{name}_host_syncs": inside(syncs)})
    return out


def phase_engine(torch, np, cfg, model, dev, need=(), profile=False,
                 lease_bytes=LEASE_BYTES):
    """``ServingEngine`` (CFS, a same-card REMOTE donor lease) serves 12
    seeded requests at full width. Every request finishes, CFS preempts and
    restores, each park/restore is one fabric message, a family whose
    context is all state planes moves exactly its whole state per leg, a
    family with one token plane whole token rows of every layer, and every
    kernel in ``need`` launched (counts reset just before the run). With
    ``profile``, a second run of the same requests profiles one chunk step
    and one decode-only step (``profile_engine_steps``; an MoE layer's
    feed-forward runs inside a ``record_function("moe")`` range there).
    ``lease_bytes``: the donor lease, room for every parked request's
    pages, so each leg is one fabric message.
    Returns (launch counts, each request's generated tokens)."""
    from repro_torch.kernels import build

    eng, kv, reqs = make_engine(np, cfg, model, dev, lease_bytes=lease_bytes)
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
    prompt = sum(r.prompt_positions for r in reqs)
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
    # the meter counts a leg's state pages whole and its token pages'
    # live bytes (a tail page at its fill): whole tokens of every layer
    planes = list(kv.planes.values())
    state = sum(p.n_layers * p.aqua.page_bytes for p in planes
                if p.kind == "state")
    row = sum(p.n_layers * p.token_bytes for p in planes
              if p.kind == "tokens")
    legs = m.preemptions + m.restores
    tokens_moved = meter.bytes_fabric - legs * state
    print(f"engine: {cfg.name} planes "
          + ", ".join(f"{p.name} ({p.kind}, {p.n_layers} layers, pages of "
                      f"{p.aqua.page_bytes} B)" for p in planes)
          + f"; state per request {state} B, a token row {row} B; "
          f"bytes_fabric {meter.bytes_fabric:.0f} = {legs} legs x {state} "
          f"+ {tokens_moved / row if row else 0:.2f} token rows")
    if tokens_moved < 0 or (tokens_moved % row if row else tokens_moved):
        raise AssertionError(
            f"engine: bytes_fabric {meter.bytes_fabric} is not {legs} legs "
            f"x {state} B of state plus whole {row} B token rows")
    if not all(launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"engine: {cfg.name}'s run never launched some "
                             f"of {list(need)}")
    tokens = [list(r.generated) for r in reqs]
    if profile:
        del eng, kv, reqs
        torch.cuda.empty_cache()
        eng, _, _ = make_engine(np, cfg, model, dev,
                                lease_bytes=lease_bytes)
        with profile_ranges(torch):
            prof = profile_engine_steps(torch, eng)
        print(f"engine profile: {json.dumps(prof)}")
        dec = prof.get("decode_only", {})
        if cfg.moe is None and "idle_share" in dec:
            # every weight but an untied model's token embeddings, of
            # which a step reads a row a token
            read = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "embed.tok" or model.embed.head is None)
            print(f"engine: {cfg.name} decode-only step: wall "
                  f"{dec['step_wall_ms']:.2f} ms, device busy "
                  f"{dec['device_busy_ms']:.2f} ms, idle share "
                  f"{dec['idle_share']:.4f}; the weights it reads, {read:,} "
                  f"B, take {read / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 "
                  f"TB/s")
    return launches, tokens


# -- the lease lifecycle: coordinator reclaim, lease shrink, donor loss -----
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
    the special-function units' rate (``rwkv6_wkv/ops.py:work``). Returns
    (ms, bound_by, parts)."""
    return wkv_parts(B, T, H, hd, io_bytes, backward=False)


def wkv_parts(B, T, H, hd, io_bytes, *, backward):
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    flops, exps, nbytes = wkv_ops.work(B, T, H, hd, io_bytes,
                                       backward=backward)
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


def fused_fcfs_run(torch, np, cfg, model, dev, prompts, label):
    """``prompts`` [(tokens, split)] through the fused engine (FCFS, 16-token
    pages, no preemption), ``DECODE_STEPS + 1`` tokens each, every step
    timed to its end on the device. Returns (each prompt's tokens, step
    walls in s, which steps held prompt chunks, launch counts)."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.kernels import build
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, model, max_running=4, max_seq=1024,
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
        raise AssertionError(f"{label} fused: not every request finished")
    mixed = np.asarray(eng.metrics.prefill_tokens_trace) > 0
    return ([r.generated for r in reqs], np.asarray(step_s), mixed,
            build.launch_counts())


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
    from repro_torch.kernels import build
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
        return fused_fcfs_run(torch, np, c, mdl, dev, prompts, "rwkv")

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
# -- deepseek-v2-lite-16b: MLA and the dropless MoE on the mla latent plane --
def leg_rows(torch, np, shapes, report, dev, other_dtypes=()):
    """Rows 6-7 at each leg of ``shapes`` (``gather_leg_shapes``' form):
    the bulk gather's plan and resources there; gather and scatter
    bit-exact against their plain versions at 1 row, 7 rows (fewer work
    items than the grid), 3 x the grid + 5 and the leg's rows, each with
    ids outside the pool, in the leg's dtype and in each of
    ``other_dtypes`` at the same row bytes; the leg's times (gather cold,
    as ``gather_legs``; scatter) beside ``index_select`` / ``index_copy_``
    and the bound. Adds a record per leg to both kernels' entries."""
    import math
    from repro_torch.kernels.kv_gather import ops as kv_ops
    from repro_torch.kernels.kv_gather import ref as kv_ref
    print_gather_resources(torch, kv_ops, None, None, shapes)
    g = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    grid = kv_ops.BLOCKS_PER_SM * kv_ops.sm_count(0)
    for leg, (page, dtype, n_leg, _) in shapes.items():
        row = math.prod(page) * dtype.itemsize
        P = 2 * n_leg + 1
        plans, forms = [], [(page, dtype)]
        for other in other_dtypes:
            if other != dtype:
                last = page[-1] * dtype.itemsize // other.itemsize
                forms.append((page[:-1] + (last,), other))
        for n in (1, 7, 3 * grid + 5, n_leg):
            Pn = max(P, n + 2)
            ids = rng.choice(Pn, n, replace=False).astype(np.int32)
            if n > 2:
                ids[0], ids[n // 2] = -1, Pn            # outside the pool
            ids = torch.as_tensor(ids).to(dev)
            for shape, dt in forms:
                pool = torch.randn((Pn,) + shape, generator=g,
                                   device=dev).to(dt)
                got = kv_ops.gather_pages(pool, ids)
                new = torch.randn(got.shape, generator=g, device=dev).to(dt)
                scattered = kv_ops.scatter_pages(pool.clone(), new, ids)
                torch.cuda.synchronize()
                if not (torch.equal(got, kv_ref.gather_pages_ref(pool, ids))
                        and torch.equal(scattered, kv_ref.scatter_pages_ref(
                            pool.clone(), new, ids))):
                    raise AssertionError(
                        f"gather/scatter at {n} {leg} rows ({dt}) differ "
                        f"from their plain versions")
                del pool, got, new, scattered
            plan = kv_ops.gather_plan(n, row, 16, kv_ops.sm_count(0))
            plans.append(f"{n} rows: {plan.route}, chunk {plan.chunk_bytes} "
                         f"B (tail {row % plan.chunk_bytes} B), "
                         f"{plan.blocks} blocks")
        also = "".join(f", also as {shape} {dt}" for shape, dt in forms[1:])
        print(f"gather/scatter kernels at {leg} rows of {row} B ({page}, "
              f"{dtype}{also}): bit-exact against the plain versions, ids "
              f"outside the pool included, at {'; '.join(plans)}")

    gathers = gather_legs(torch, np, kv_ops, kv_ref, None, None, dev, shapes)
    for leg, (page, dtype, n_leg, _) in shapes.items():
        row = math.prod(page) * dtype.itemsize
        P = 2 * n_leg + 1
        staging_pool = torch.randn((P,) + page, generator=g,
                                   device=dev).to(dtype)
        ids = torch.as_tensor(rng.choice(P, n_leg, replace=False).astype(
            np.int32)).to(dev)
        staging = kv_ops.gather_pages(staging_pool, ids)
        remote = torch.zeros((2 * n_leg,) + page, device=dev, dtype=dtype)
        dst = torch.as_tensor(rng.choice(2 * n_leg, n_leg, replace=False)
                              .astype(np.int32)).to(dev)
        dst64 = dst.long()
        ms, plain_ms = interleaved(
            lambda: kv_ref.scatter_pages_ref(remote, staging, dst),
            lambda: kv_ops.scatter_pages(remote, staging, dst), 20)
        vs_lib = against_library(
            np, lambda: remote.index_copy_(0, dst64, staging),
            lambda: kv_ops.scatter_pages(remote, staging, dst), 20)
        b, by = bound_ms(2 * n_leg * row + 4 * n_leg)
        scatter = dict(shape=f"{leg}: {n_leg} pages of {row} B into "
                             f"{2 * n_leg}, {dtype}",
                       max_abs_err=0.0, tolerance=0.0, ms=ms,
                       plain_ms=plain_ms, bound_ms=b, bound_by=by,
                       library_ms=vs_lib["library_median_ms"],
                       vs_library=vs_lib)
        for name, case in (("gather_pages", gathers[leg]),
                           ("scatter_pages", scatter)):
            next(k for k in report if k["name"] == name)[leg] = case
            print(f"kernel {name} {case['shape']}: kernel {case['ms']:.4f} "
                  f"ms plain {case['plain_ms']:.4f} ms bound "
                  f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}) "
                  f"library {case['library_ms']:.4f} ms; vs library, "
                  f"{REPEATS} interleaved repeats"
                  + (f" ({case['rotation']})" if "rotation" in case else "")
                  + ": " + json.dumps(case["vs_library"]))
        del staging_pool, staging, remote


def phase_mla_rows(torch, np, dcfg, report, dev):
    """Rows 6-7 at the ``mla`` leg (module docstring, phase 14):
    ``leg_rows`` there, whose plan must carry a tail chunk. Adds a
    ``deepseek_mla`` record to both kernels' entries."""
    import math
    from repro_torch.kernels.kv_gather import ops as kv_ops
    shapes = mla_leg_shape(dcfg)
    ((page, dtype, n_leg, _),) = shapes.values()
    row = math.prod(page) * dtype.itemsize
    if row % kv_ops.gather_plan(n_leg, row, 16,
                                kv_ops.sm_count(0)).chunk_bytes == 0:
        raise AssertionError("the mla leg's plan has no tail chunk")
    leg_rows(torch, np, shapes, report, dev)


def phase_deepseek_model(torch, dcfg):
    """The full-width model from a seeded CUDA generator (phase 15): its
    parameters against the reference's formula and the memory it holds."""
    from repro_torch.models import lm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    model = lm.init_params(dcfg, gen, "cuda")
    torch.cuda.synchronize()
    span = time.perf_counter() - t
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    # the formula counts neither the MLA's kv_norm scales nor final_norm
    norms = dcfg.n_layers * dcfg.mla.kv_lora_rank + dcfg.d_model
    print(f"deepseek model: param_count() {dcfg.param_count():,} (the "
          f"reference's formula); the model holds {n:,} = that + {norms:,} "
          f"kv_norm and final_norm scales the formula leaves out, "
          f"{nbytes / 2 ** 30:.2f} GiB; torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB before); built in {span:.1f} s")
    if dcfg.param_count() != 16_210_309_120 or n != dcfg.param_count() \
            + norms:
        raise AssertionError("deepseek model: wrong parameter count")
    return model


def rel_per_token(torch, got, want, real):
    """The largest, over the ``real`` tokens, per-token distance of ``got``
    to ``want`` relative to that token's largest entry of ``want``."""
    scale = want.float().abs().amax(-1).clamp_min(1e-6)
    d = (got.float() - want.float()).abs().amax(-1) / scale
    return d[real].max().item()


def expert_sets(torch, p, cfg, h):
    from repro_torch.layers.moe import route
    _, idx, _ = route(p, cfg, h.reshape(-1, h.shape[-1]))
    return idx.sort(dim=-1).values


def phase_deepseek_layer_step(torch, np, cfg, model, dev):
    """One full-width packed step (``main_path_plan``) of deepseek, bf16
    against float32 a layer at a time (phase 16; the whole model in
    float32, ~65 GB, does not fit beside the bf16 one).

    Per layer, on the bf16 path's layer input and pool: MLA
    (``mla_mixed_paged``) through the layer as it is and through a float32
    copy of it, within ``LAYER_REL_LIMIT`` per real token, a control (the
    float32 copy with the furthest decode lane's newest page swapped for
    scratch in its table) beyond it; the dropless MoE likewise on the same
    normed input, its control routing to top-(k-1). On the two streams
    each path carries (the bf16 step and a float32 step), the share of
    real tokens whose top-k experts differ is printed, not asserted. Whole
    step: the bf16 layers' logits must equal ``api.serve_step_paged``'s
    bit for bit (so the layers compared are the served ones), and lie
    nearer the float32 step's than the control's table gives."""
    import dataclasses
    from repro_torch.layers import mla as mla_mod
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.layers.moe import moe_apply
    from repro_torch.models import api
    rng = np.random.default_rng(1)
    g = torch.Generator(device=dev).manual_seed(1)
    page, max_seq = 16, 1024
    read_pps = max_seq // page
    pps_pad = read_pps + 256 // page + 1
    q_starts, n_reals, n_dec, Tc = main_path_plan()
    R, L = len(q_starts), cfg.n_layers
    need = [-(-(int(s) + max(int(n), 1)) // page) if n else 0
            for s, n in zip(q_starts, n_reals)]
    P = 1 + L * sum(need)
    dt = cfg.torch_compute_dtype()
    lane = int(np.argmax(q_starts[:n_dec]))            # the control's lane
    lost = int(q_starts[lane]) // page
    pool = torch.randn((P, page, mla_mod.latent_dim(cfg)), generator=g,
                       device=dev, dtype=dt)
    bt = np.zeros((L, 1, R, pps_pad), np.int32)        # 0 = scratch
    free = rng.permutation(np.arange(1, P)).astype(np.int32)
    for l in range(L):
        for r in range(R):
            bt[l, 0, r, :need[r]], free = free[:need[r]], free[need[r]:]
    tokens = rng.integers(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    bt_ctrl = bt.copy()
    bt_ctrl[:, 0, lane, lost] = 0         # the lane's newest page: scratch
    tables = {False: torch.as_tensor(bt).to(dev),
              True: torch.as_tensor(bt_ctrl).to(dev)}
    real = torch.as_tensor(np.arange(Tc)[None] < n_reals[:, None]).to(dev)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    ctrl32 = cfg32.replace(moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.top_k - 1))
    eps = cfg.rmsnorm_eps

    def mix(p, c, h, pl, layer, control=False):
        return mla_mod.mla_mixed_paged(p, c, h, pl, tables[control][layer, 0],
                                       q_starts, n_reals, n_decode=n_dec,
                                       read_pps=read_pps)

    t = time.perf_counter()
    x = embed(model.embed, cfg, torch.as_tensor(tokens).to(dev))
    x32 = x.float()
    pool_b, pool_32 = pool.clone(), pool.float()
    rel = {k: [] for k in ("mla", "mla_control", "moe", "moe_control")}
    differ = []
    for layer, blk in enumerate(model.blocks):
        blk32 = copy.deepcopy(blk).float()
        h = rms_norm(blk.n1, x, eps)
        out_b, _ = mix(blk.mix, cfg, h, pool_b, layer)
        out_f, _ = mix(blk32.mix, cfg32, h.float(), pool_b.float(), layer)
        out_c, _ = mix(blk32.mix, cfg32, h.float(), pool_b.float(), layer,
                       control=True)
        rel["mla"].append(rel_per_token(torch, out_b, out_f, real))
        rel["mla_control"].append(rel_per_token(torch, out_c, out_f, real))
        x = x + out_b
        h2 = rms_norm(blk.n2, x, eps)
        moe_b = moe_apply(blk.ffn, cfg, h2)[0]
        moe_f = moe_apply(blk32.ffn, cfg32, h2.float())[0]
        moe_c = moe_apply(blk32.ffn, ctrl32, h2.float())[0]
        rel["moe"].append(rel_per_token(torch, moe_b, moe_f, real))
        rel["moe_control"].append(rel_per_token(torch, moe_c, moe_f, real))
        x = x + moe_b
        # the float32 step, on its own stream and pool
        x32 = x32 + mix(blk32.mix, cfg32, rms_norm(blk32.n1, x32, eps),
                        pool_32, layer)[0]
        h2_32 = rms_norm(blk32.n2, x32, eps)
        sets = (expert_sets(torch, blk.ffn, cfg, h2)
                != expert_sets(torch, blk32.ffn, cfg32, h2_32)).any(-1)
        differ.append(sets.reshape(R, Tc)[real].float().mean().item())
        x32 = x32 + moe_apply(blk32.ffn, cfg32, h2_32)[0]
        del blk32, out_b, out_f, out_c, moe_b, moe_f, moe_c
    last = torch.as_tensor(np.clip(n_reals - 1, 0, Tc - 1)).to(dev)
    rows = torch.arange(R, device=dev)

    def logits_of(mdl, c, xs):
        xs = rms_norm(mdl.final_norm, xs, eps)
        return unembed(mdl.embed, c, xs[rows, last]).float()
    emb32 = copy.deepcopy(model.embed).float()
    fin32 = copy.deepcopy(model.final_norm).float()
    head32 = type("Head", (), {"embed": emb32, "final_norm": fin32})
    outs = {"bf16 layers": logits_of(model, cfg, x),
            "f32": logits_of(head32, cfg32, x32)}
    del emb32, fin32, head32, x, x32, pool_32
    span = time.perf_counter() - t
    for name, table in (("served", bt), ("control", bt_ctrl)):
        p = pool.clone()
        lg, _ = api.serve_step_paged(model, cfg, tokens, {"mla": p},
                                     {"mla": table}, q_starts, n_reals,
                                     n_decode=n_dec, read_pps=read_pps)
        outs[name] = lg.float()
        del p
    torch.cuda.synchronize()
    keep = np.nonzero(n_reals > 0)[0]
    # pad rows read the scratch page, whose duplicate writes land in no
    # defined order: only the real rows are the step's answer
    same = torch.equal(outs["served"][keep], outs["bf16 layers"][keep])
    dist = {k: [round(v, 4) for v in
                (outs[k] - outs["f32"]).abs().amax(-1)[keep].tolist()]
            for k in ("served", "control")}
    agree = (outs["served"][keep].argmax(-1)
             == outs["f32"][keep].argmax(-1)).float().mean().item()
    fmt = lambda v: ", ".join(f"{a:.3g}" for a in v)       # noqa: E731
    print(f"deepseek layer step, per layer ({L} layers, R={R} Tc={Tc}), "
          f"bf16 vs float32 max per-token relative diff: MLA "
          f"{max(rel['mla']):.4g} (layers {fmt(rel['mla'])}), control "
          f"(the lane at {int(q_starts[lane])} reading scratch for its "
          f"newest page) least "
          f"{min(rel['mla_control']):.4g}; MoE {max(rel['moe']):.4g} (layers "
          f"{fmt(rel['moe'])}), control routing to top-{cfg.moe.top_k - 1} "
          f"least {min(rel['moe_control']):.4g}; {span:.1f} s")
    print(f"deepseek layer step, routing: share of real tokens whose top-"
          f"{cfg.moe.top_k} experts differ between the bf16 and float32 "
          f"steps, per layer: {fmt(differ)}; mean "
          f"{float(np.mean(differ)):.4g}")
    print(f"deepseek layer step, whole: the bf16 layers' logits of the "
          f"{len(keep)} real rows equal api.serve_step_paged's bit for bit: "
          f"{same}; |f32| max "
          f"{outs['f32'][keep].abs().max().item():.3g}; per real row max abs"
          f" diff to f32: {json.dumps(dist)}; argmax agreement with f32 "
          f"{agree:.3f}")
    for kind in ("mla", "moe"):
        lk, lc = max(rel[kind]), min(rel[f"{kind}_control"])
        if not lk <= LAYER_REL_LIMIT < lc:
            raise AssertionError(
                f"deepseek layer step: {kind} bf16 vs float32 {lk} must be "
                f"within {LAYER_REL_LIMIT}, and its control ({lc}) beyond")
    if not same:
        raise AssertionError("deepseek layer step: the layers compared are "
                             "not the served step's")
    if tuple(outs["served"].shape) != (R, cfg.vocab_size) \
            or not torch.isfinite(outs["served"]).all():
        raise AssertionError("deepseek layer step: logits of the wrong "
                             "shape or not finite")
    if not max(dist["served"]) < max(dist["control"]):
        raise AssertionError(
            f"deepseek layer step: the served step's logits "
            f"({max(dist['served'])} from float32) must lie nearer than the "
            f"control's ({max(dist['control'])})")
    return {"mla": max(rel["mla"]), "moe": max(rel["moe"]),
            "routing_differs": float(np.mean(differ))}


def phase_deepseek_per_request(torch, np, cfg, model, dev):
    """Phase 5's prompts and decode steps through the per-request entry
    points at full width (phase 17; MLA and the MoE launch no kernel
    there: counts reset just before, printed), beside the same prompts
    through the fused step (``ServingEngine``, FCFS): walls and agreeing
    greedy tokens (reported, not asserted)."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), split)
               for n, split in PROMPTS.items()]
    _sync(torch, dev)
    build.reset_launch_counts()
    run = per_request_run(torch, np, cfg, model, dev, prompts, "kernel",
                          decode_steps=DECODE_STEPS)
    launches = build.launch_counts()
    print("deepseek per-request (api.prefill_chunk_paged / "
          "api.decode_step_paged): "
          + _walls(np, "prefill chunk wall", run["chunk_s"]) + "; "
          + _walls(np, "decode step wall", run["step_s"])
          + f"; kernel launches {json.dumps(launches, sort_keys=True)}")
    if not all(len(t) == DECODE_STEPS + 1 and all(0 <= v < cfg.vocab_size
                                                  for v in t)
               for t in run["tokens"]) or not all(
            torch.isfinite(lg).all() for lg in run["logits"]):
        raise AssertionError("deepseek per-request: wrong greedy tokens or "
                             "logits not finite")
    del run["kv"]
    tokens, step_s, mixed, _ = fused_fcfs_run(torch, np, cfg, model, dev,
                                              prompts, "deepseek")
    agree = [sum(a == b for a, b in zip(x, y))
             for x, y in zip(tokens, run["tokens"])]
    print(f"deepseek fused (ServingEngine FCFS, same prompts): "
          f"{len(step_s)} steps; "
          + _walls(np, "step wall with prompt chunks", step_s[mixed]) + "; "
          + _walls(np, "decode-only step wall", step_s[~mixed])
          + f"; greedy tokens agreeing with the per-request path per prompt"
          f" {list(PROMPTS)}: {agree} of {DECODE_STEPS + 1} each")
    return launches


def roundtrip_run(torch, np, cfg, model, dev, prompt, chunks, steps, park,
                  prefix=None, lease_bytes=1 << 28):
    """One prompt chunk by chunk through the per-request entry points, then
    ``steps`` decode steps; with ``park``, the request parks on a REMOTE
    lease of ``lease_bytes`` and is restored after every chunk and step.
    ``prefix`` (a VLM's (1, P, d) block on the device) fills the prompt's
    first P positions, whose token ids are dummies. Returns every logits
    row and the runtime."""
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.models import api
    from repro_torch.serving.kv_cache import PagedStateRuntime
    from repro_torch.serving.scheduler import bucket_tokens
    kv = PagedStateRuntime(cfg, max_seq=1024, page_tokens=16, max_running=2,
                           prefix_cache=False, device=dev)
    kv.add_remote_lease("donor0", lease_bytes)
    pad = kv.pps + 256 // kv.page_tokens + 1
    logs, pos = [], 0
    for c in chunks:
        kv.ensure_capacity(0, pos + c)
        tk = np.zeros((1, bucket_tokens(c)), np.int32)
        tk[0, :c] = prompt[pos:pos + c]
        lg, kv.pools = api.prefill_chunk_paged(
            model, cfg, tk, kv.pools, kv.block_tables_prefill(0, pad_to=pad),
            pos, c - 1, prefix_embeds=prefix, read_pps=kv.pps)
        pos += c
        if park:
            kv.park(0, pos, prefer=REMOTE)
            kv.restore(0)
    logs.append(lg[0])
    for t in range(steps):
        ctx = len(prompt) + t + 1
        kv.ensure_capacity(0, ctx)
        lg, kv.pools = api.decode_step_paged(
            model, cfg, kv.pools, kv.block_tables([0, None]),
            [int(logs[-1].argmax()), 0], [ctx - 1, 0])
        logs.append(lg[0])
        if park:
            kv.park(0, ctx, prefer=REMOTE)
            kv.restore(0)
    _sync(torch, dev)
    return logs, kv


def phase_roundtrip(torch, np, cfg, model, dev, label, lease_bytes=1 << 28):
    """A park/restore round trip at full width (phases 19 and 25): a
    300-token prompt in two mid-page chunks and 8 decode steps, parked on
    a same-card REMOTE lease (``lease_bytes``, room for the request's
    pages) and restored after every chunk and step, must give every logits
    row bit for bit as the unparked run; gather and scatter must launch,
    one fabric message per leg whatever the number of planes. A VLM's
    prompt opens with a seeded prefix block (its first ``n_prefix_embeds``
    positions). Returns the parked run's launch counts."""
    from repro_torch.kernels import build
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 300)
    prefix = vlm_prefix(torch, cfg, dev, 6)
    if prefix is not None:
        prompt[:cfg.n_prefix_embeds] = 0
    base, _ = roundtrip_run(torch, np, cfg, model, dev, prompt, (120, 180),
                            8, False, prefix)
    build.reset_launch_counts()
    parked, kv = roundtrip_run(torch, np, cfg, model, dev, prompt,
                               (120, 180), 8, True, prefix, lease_bytes)
    launches = build.launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(base, parked))
    m = kv.meter
    print(f"{label} round trip: {len(base)} logits rows (2 chunks, 8 "
          f"steps) parked and restored after each, planes "
          f"{', '.join(kv.planes)}: bit-identical to the unparked run: "
          f"{same}; messages_fabric {m.messages_fabric}, bytes_fabric "
          f"{m.bytes_fabric:.0f}; launches "
          f"{json.dumps(launches, sort_keys=True)}")
    if not same or m.messages_fabric != 2 * (2 + 8) or not all(
            launches.get(k, 0) > 0 for k in ("gather_pages",
                                             "scatter_pages")):
        raise AssertionError(f"{label} round trip: logits differ from the "
                             f"unparked run, or the legs are not one "
                             f"message each through the kernels")
    return launches


# -- jamba-v0.1-52b: Mamba and attention, the ssm/conv planes beside kv -----
JAMBA_LAYERS = 16                   # two hybrid periods: the deepest whole
#                                     number that fits one 80 GB card


def jamba_leg_shapes(torch, jcfg):
    """Rows 6-7 at one jamba request's three legs (``gather_leg_shapes``'
    form): its ``ssm`` state, (d_inner, d_state) float32 = 524,288 B a
    page, and ``conv`` state, (d_conv - 1, d_inner) bf16 = 49,152 B, a
    page per Mamba layer (14 at 16 layers), and a park of ~800 tokens of
    ``kv`` (50 pages of 16 tokens a layer, 2 attention layers, 65,536 B)."""
    di = jcfg.ssm.mamba_expand * jcfg.d_model
    n_attn = sum(jcfg.is_attention_layer(l) for l in range(jcfg.n_layers))
    n_mamba = jcfg.n_layers - n_attn
    native = jcfg.torch_compute_dtype()
    return {"jamba_ssm": ((di, jcfg.ssm.mamba_d_state), torch.float32,
                          n_mamba, 0),
            "jamba_conv": ((jcfg.ssm.mamba_d_conv - 1, di), native, n_mamba,
                           0),
            "jamba_kv": ((2, jcfg.n_kv_heads, 16, jcfg.resolved_head_dim),
                         native, n_attn * 50, 0)}


def phase_jamba_kernels(torch, np, jcfg, report, dev):
    """Rows 4-7 at jamba's shapes (phase 20): rows 6-7 at the three legs
    (``leg_rows``; the ssm and conv rows also bit-exact in the other of
    float32 and bf16); row 4, the mixed attention, at the main path's
    packed step with 32 heads on 8 KV heads of 128 (``attention_case``);
    row 5, the page writer, at that step (``step_writer_case``). Adds
    ``jamba_*`` records to the kernels' entries."""
    leg_rows(torch, np, jamba_leg_shapes(torch, jcfg), report, dev,
             other_dtypes=(torch.float32, torch.bfloat16))
    rng = np.random.default_rng(7)
    g = torch.Generator(device=dev).manual_seed(7)
    page, read_pps = 16, 1024 // 16
    pool = torch.randn((2049, 2, jcfg.n_kv_heads, page,
                        jcfg.resolved_head_dim), generator=g, device=dev,
                       dtype=jcfg.torch_compute_dtype())
    cases = {"paged_mixed_attention_pool": attention_case(
                 torch, np, pool, rng, g, main_path_plan(), jcfg.n_heads,
                 read_pps),
             "append_kv": step_writer_case(torch, np, pool, rng, g,
                                           read_pps)}
    for name, case in cases.items():
        next(k for k in report if k["name"] == name)["jamba"] = case
        print(f"kernel {name} jamba {case['shape']} (hd "
              f"{jcfg.resolved_head_dim}, {jcfg.n_heads} heads on "
              f"{jcfg.n_kv_heads}): err {case['max_abs_err']:.3g} kernel "
              f"{case['ms']:.4f} ms plain {case['plain_ms']:.4f} ms bound "
              f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}) library "
              f"{case['library_ms']}")
    del pool


def phase_jamba_model(torch, jcfg):
    """The model at the published widths, ``JAMBA_LAYERS`` deep, from a
    seeded CUDA generator (phase 21): the reference's ``param_count()``
    and what the model holds (the formula leaves out the Mamba layers'
    conv_b and dt_bias and final_norm)."""
    from repro_torch.models import lm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = lm.init_params(jcfg, torch.Generator(device="cuda").manual_seed(9),
                           "cuda")
    torch.cuda.synchronize()
    span = time.perf_counter() - t
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    di = jcfg.ssm.mamba_expand * jcfg.d_model
    n_mamba = sum(not jcfg.is_attention_layer(l)
                  for l in range(jcfg.n_layers))
    extra = n_mamba * 2 * di + jcfg.d_model
    print(f"jamba model: {jcfg.n_layers} of the published 32 layers (two "
          f"hybrid periods; 32 layers are 96.06 GiB in bf16), published "
          f"widths; param_count() {jcfg.param_count():,} (the reference's "
          f"formula); the model holds {n:,} = that + {extra:,} conv_b, "
          f"dt_bias and final_norm entries the formula leaves out, "
          f"{nbytes / 2 ** 30:.2f} GiB; torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({before / 2 ** 30:.2f} GiB before); built in {span:.1f} s")
    if jcfg.param_count() != 26_053_361_664 or n != jcfg.param_count() \
            + extra:
        raise AssertionError("jamba model: wrong parameter count")
    return model


def moe_step_inputs(torch, np, cfg, dev, plan, page, pps_pad):
    """Pools and tables of a packed step (``plan``) of a family with a MoE
    on the ``kv`` plane and, for jamba, the ``ssm`` and ``conv`` state
    planes: every live row (decode lanes, chunk rows with real tokens) owns
    a random mid-stream ssm and conv page per Mamba layer and its kv pages
    per attention layer, every slot its own; pad rows point at scratch
    (slot 0). Returns (pools, host tables, tokens)."""
    rng = np.random.default_rng(11)
    g = torch.Generator(device=dev).manual_seed(11)
    from repro_torch.models import lm
    q_starts, n_reals, n_dec, Tc = plan
    R, G = len(q_starts), lm.n_groups(cfg)
    live = np.nonzero((np.arange(R) < n_dec) | (n_reals > 0))[0]
    need = [-(-(int(s) + max(int(n), 1)) // page) if r in live else 0
            for r, (s, n) in enumerate(zip(q_starts, n_reals))]
    n_sub = {k: len(v["positions"]) for k, v in lm.paged_layout(cfg).items()}
    dt = cfg.torch_compute_dtype()
    P_kv = 1 + G * sum(need)
    pools, tables = {}, {}
    if "ssm" in n_sub:
        from repro_torch.layers.mamba import _dims
        di, ds, dc, _ = _dims(cfg)
        P_state = 1 + G * n_sub["ssm"] * len(live)
        pools["ssm"] = 0.1 * torch.randn((P_state, di, ds), generator=g,
                                         device=dev)
        pools["conv"] = torch.randn((P_state, dc - 1, di), generator=g,
                                    device=dev).to(dt)
    pools["kv"] = torch.randn((P_kv, 2, cfg.n_kv_heads, page,
                               cfg.resolved_head_dim), generator=g,
                              device=dev).to(dt)
    for name in ("ssm", "conv") if "ssm" in n_sub else ():
        bt = np.zeros((G, n_sub[name], R), np.int32)
        bt[:, :, live] = (1 + rng.permutation(P_state - 1)).reshape(
            G, n_sub[name], len(live))
        tables[name] = bt
    bt = np.zeros((G, 1, R, pps_pad), np.int32)
    free = rng.permutation(np.arange(1, P_kv)).astype(np.int32)
    for gi in range(G):
        for r in range(R):
            bt[gi, 0, r, :need[r]], free = free[:need[r]], free[need[r]:]
    tables["kv"] = bt
    tokens = rng.integers(0, cfg.vocab_size, (R, Tc)).astype(np.int32)
    return pools, tables, tokens


def phase_moe_layer_step(torch, np, cfg, model, dev, label):
    """One full-width packed step (``main_path_plan``) of a family with a
    MoE (jamba, dbrx), bf16 against float32 a layer at a time (phases 22
    and 40; neither model fits the card in float32).

    Per layer, on the bf16 path's layer input and pools: the mixer (Mamba:
    ``mamba_mixed_paged``; attention: ``attention_mixed_paged``) through
    the layer as it is and through a float32 copy of it, within
    ``LAYER_REL_LIMIT`` per real token, a control beyond (Mamba: the
    furthest decode lane's ssm and conv pages zeroed, a dropped state;
    attention: that lane's newest kv page swapped for scratch); the MoE
    likewise on the same normed input, its control routing to top-(k-1).
    On the two streams each path carries (the bf16 step and a float32
    step), the share of real tokens whose top-k experts differ is printed,
    not asserted. Whole step: the bf16 layers' logits must equal
    ``api.serve_step_paged``'s bit for bit on the real rows, and lie
    nearer the float32 step's than a control step's: the furthest decode
    lane's Mamba state lost (jamba) or its newest kv page read as scratch
    in every layer (a family of attention alone)."""
    import dataclasses
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.layers.moe import MoE, moe_apply
    from repro_torch.models import api, lm
    page, max_seq = 16, 1024
    read_pps = max_seq // page
    pps_pad = read_pps + 256 // page + 1
    plan = main_path_plan()
    q_starts, n_reals, n_dec, Tc = plan
    R = len(q_starts)
    pools0, bt, tokens = moe_step_inputs(torch, np, cfg, dev, plan, page,
                                         pps_pad)
    states = [k for k in ("ssm", "conv") if k in bt]
    lane = int(np.argmax(q_starts[:n_dec]))            # the controls' lane
    lost = int(q_starts[lane]) // page
    bt_ctrl = {k: v.copy() for k, v in bt.items()}
    bt_ctrl["kv"][:, 0, lane, lost] = 0       # the lane's newest page
    tables = {False: {k: torch.as_tensor(v).to(dev) for k, v in bt.items()},
              True: {k: torch.as_tensor(v).to(dev)
                     for k, v in bt_ctrl.items()}}
    dropped = {k: torch.as_tensor(bt[k][:, :, lane].reshape(-1)).long()
               .to(dev) for k in states}
    real = torch.as_tensor(np.arange(Tc)[None] < n_reals[:, None]).to(dev)
    nr_dev = torch.as_tensor(n_reals.astype(np.int64)).to(dev)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    ctrl32 = cfg32.replace(moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.top_k - 1))
    eps = cfg.rmsnorm_eps

    def f32(pools):
        return {k: v.to(torch.float32, copy=True) for k, v in pools.items()}

    # the served step's metadata: a chunk row writes only its own pages
    meta = attn.step_meta(q_starts, n_reals, n_dec, Tc, dev,
                          page=lm._own_pages_only(cfg, pools0))

    def mix(kind, gi, j, p, c, h, pools, control=False):
        t = tables[control and kind == "attn"]
        if kind == "mamba":
            return lm.mamba_mixed_paged(p, c, h, pools, t["ssm"][gi, j],
                                        t["conv"][gi, j], nr_dev, n_dec)
        return attn.attention_mixed_paged(
            p, c, h, pools["kv"], t["kv"][gi, j], q_starts, n_reals,
            n_decode=n_dec, read_pps=read_pps, meta=meta)[0]

    t = time.perf_counter()
    x = embed(model.embed, cfg, torch.as_tensor(tokens).to(dev))
    x32 = x.float()
    pools_b = {k: v.clone() for k, v in pools0.items()}
    pools_32 = f32(pools0)
    kinds = sorted({kind for _, _, kind in lm.sublayers(cfg)}) + ["moe"]
    rel = {k: [] for kind in kinds for k in (kind, f"{kind}_control")}
    differ = []
    for blk, (gi, j, kind) in zip(model.blocks, lm.sublayers(cfg)):
        blk32 = copy.deepcopy(blk).float()
        before = f32(pools_b)
        h = rms_norm(blk.n1, x, eps)
        out_b = mix(kind, gi, j, blk.mix, cfg, h, pools_b)
        out_f = mix(kind, gi, j, blk32.mix, cfg32, h.float(), f32(before))
        ctrl = f32(before)
        if kind == "mamba":
            for k in states:
                ctrl[k][dropped[k]] = 0.0
        out_c = mix(kind, gi, j, blk32.mix, cfg32, h.float(), ctrl,
                    control=True)
        rel[kind].append(rel_per_token(torch, out_b, out_f, real))
        rel[f"{kind}_control"].append(rel_per_token(torch, out_c, out_f,
                                                    real))
        x = x + out_b
        h2 = rms_norm(blk.n2, x, eps)
        ffn_b = lm.ffn_apply(blk.ffn, cfg, h2)
        if isinstance(blk.ffn, MoE):
            moe_f = moe_apply(blk32.ffn, cfg32, h2.float())[0]
            moe_c = moe_apply(blk32.ffn, ctrl32, h2.float())[0]
            rel["moe"].append(rel_per_token(torch, ffn_b, moe_f, real))
            rel["moe_control"].append(rel_per_token(torch, moe_c, moe_f,
                                                    real))
            del moe_f, moe_c
        x = x + ffn_b
        # the float32 step, on its own stream and pools
        x32 = x32 + mix(kind, gi, j, blk32.mix, cfg32,
                        rms_norm(blk32.n1, x32, eps), pools_32)
        h2_32 = rms_norm(blk32.n2, x32, eps)
        if isinstance(blk.ffn, MoE):
            sets = (expert_sets(torch, blk.ffn, cfg, h2)
                    != expert_sets(torch, blk32.ffn, cfg32, h2_32)).any(-1)
            differ.append(sets.reshape(R, Tc)[real].float().mean().item())
        x32 = x32 + lm.ffn_apply(blk32.ffn, cfg32, h2_32)
        del blk32, before, ctrl, out_b, out_f, out_c
    last = torch.as_tensor(np.clip(n_reals - 1, 0, Tc - 1)).to(dev)
    rows = torch.arange(R, device=dev)

    def logits_of(mdl, c, xs):
        xs = rms_norm(mdl.final_norm, xs, eps)
        return unembed(mdl.embed, c, xs[rows, last]).float()
    emb32 = copy.deepcopy(model.embed).float()
    fin32 = copy.deepcopy(model.final_norm).float()
    head32 = type("Head", (), {"embed": emb32, "final_norm": fin32})
    outs = {"bf16 layers": logits_of(model, cfg, x),
            "f32": logits_of(head32, cfg32, x32)}
    del emb32, fin32, head32, x, x32, pools_32, pools_b
    span = time.perf_counter() - t
    for name in ("served", "control"):
        p = {k: v.clone() for k, v in pools0.items()}
        table = bt
        if name == "control" and states:
            for k in states:
                p[k][dropped[k]] = 0
        elif name == "control":
            table = bt_ctrl
        lg, _ = api.serve_step_paged(model, cfg, tokens, p, table, q_starts,
                                     n_reals, n_decode=n_dec,
                                     read_pps=read_pps)
        outs[name] = lg.float()
        del p
    _sync(torch, dev)
    keep = np.nonzero(n_reals > 0)[0]
    # pad rows write the scratch pages, whose duplicate writes land in no
    # defined order: only the real rows are the step's answer
    same = torch.equal(outs["served"][keep], outs["bf16 layers"][keep])
    dist = {k: [round(v, 4) for v in
                (outs[k] - outs["f32"]).abs().amax(-1)[keep].tolist()]
            for k in ("served", "control")}
    agree = (outs["served"][keep].argmax(-1)
             == outs["f32"][keep].argmax(-1)).float().mean().item()
    fmt = lambda v: ", ".join(f"{a:.3g}" for a in v)       # noqa: E731
    names = {"mamba": ("Mamba", "with its ssm and conv pages zeroed"),
             "attn": ("attention", "reading scratch for its newest page"),
             "moe": ("MoE", f"routing to top-{cfg.moe.top_k - 1}")}
    print(f"{label} layer step, per layer ({cfg.n_layers} layers, R={R} "
          f"Tc={Tc}), bf16 vs float32 max per-token relative diff: "
          + "; ".join(f"{names[k][0]} {max(rel[k]):.4g} (layers "
                      f"{fmt(rel[k])}), control "
                      + (f"{names[k][1]}" if k == "moe" else
                         f"(the lane at {int(q_starts[lane])} "
                         f"{names[k][1]})")
                      + f" least {min(rel[f'{k}_control']):.4g}"
                      for k in kinds) + f"; {span:.1f} s")
    print(f"{label} layer step, routing: share of real tokens whose top-"
          f"{cfg.moe.top_k} experts differ between the bf16 and float32 "
          f"steps, per MoE layer: {fmt(differ)}; mean "
          f"{float(np.mean(differ)):.4g}")
    ctrl_what = ("with its Mamba state zeroed" if states
                 else "reading scratch for its newest page in every layer")
    print(f"{label} layer step, whole: the bf16 layers' logits of the "
          f"{len(keep)} real rows equal api.serve_step_paged's bit for bit: "
          f"{same}; |f32| max "
          f"{outs['f32'][keep].abs().max().item():.3g}; per real row max abs"
          f" diff to f32: {json.dumps(dist)} (control: the lane at "
          f"{int(q_starts[lane])} {ctrl_what}); argmax agreement with f32 "
          f"{agree:.3f}")
    for kind in kinds:
        lk, lc = max(rel[kind]), min(rel[f"{kind}_control"])
        if not lk <= LAYER_REL_LIMIT < lc:
            raise AssertionError(
                f"{label} layer step: {kind} bf16 vs float32 {lk} must be "
                f"within {LAYER_REL_LIMIT}, and its control ({lc}) beyond")
    if not same:
        raise AssertionError(f"{label} layer step: the layers compared are "
                             "not the served step's")
    if tuple(outs["served"].shape) != (R, cfg.vocab_size) \
            or not torch.isfinite(outs["served"]).all():
        raise AssertionError(f"{label} layer step: logits of the wrong "
                             "shape or not finite")
    if not max(dist["served"]) < max(dist["control"]):
        raise AssertionError(
            f"{label} layer step: the served step's logits "
            f"({max(dist['served'])} from float32) must lie nearer than the "
            f"control's ({max(dist['control'])})")
    return {k: max(v) for k, v in rel.items()}


def layer_major_run(torch, np, cfg, model, dev, prompts, first_tokens):
    """The per-request path in float32 (the whole model in float32 does
    not fit the card): each prompt of ``prompts`` [(tokens, split)] chunk
    by chunk as ``per_request_run``, then one decode step of all prompts
    as lanes, fed ``first_tokens``, computed layer-major: every chunk and
    then the decode step through a float32 copy of layer 0, then of layer
    1, and so on. A layer reads only its own pages and state and the
    previous layer's output of the same tokens, and each prompt's chunks
    keep their order, so the order of work changes nothing but the memory
    it needs. Returns (each prompt's last-token prefill logits, the decode
    step's logits (B, V))."""
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.models import lm
    from repro_torch.serving.kv_cache import PagedStateRuntime
    from repro_torch.serving.scheduler import bucket_tokens
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")

    def cast(m):
        return copy.deepcopy(m).float()

    def emb(tk):
        return embed(model.embed, cfg, torch.as_tensor(tk).to(dev)).float()
    kv = PagedStateRuntime(c32, max_seq=1024, page_tokens=16, max_running=4,
                           prefix_cache=False, device=dev)
    pad = kv.pps + 256 // kv.page_tokens + 1
    chunks = []
    for rid, (prompt, split) in enumerate(prompts):
        kv.ensure_capacity(rid, len(prompt) + 1)
        bt = lm._device_tables("prefill", kv.block_tables_prefill(
            rid, pad_to=pad), kv.pools)
        pos = 0
        for c in split:
            tk = np.zeros((1, bucket_tokens(c)), np.int32)
            tk[0, :c] = prompt[pos:pos + c]
            chunks.append([rid, pos, c, emb(tk), bt])
            pos += c
    metas = [attn.step_meta([pos], [c], 0, x.shape[1], dev,
                            page=lm._own_pages_only(c32, kv.pools))
             for _, pos, c, x, _ in chunks]
    lanes = list(range(len(prompts)))
    dec_bt = lm._device_tables("decode", kv.block_tables(lanes), kv.pools)
    dec_pos = np.asarray([len(p) for p, _ in prompts], np.int64)
    x_dec = emb(np.asarray(first_tokens, np.int64).reshape(-1, 1))
    for blk, (gi, j, kind) in zip(model.blocks, lm.sublayers(cfg)):
        b = cast(blk)
        for ch, meta in zip(chunks, metas):
            _, pos, c, x, bt = ch
            if kind == "mamba":
                def attend(mix, h):
                    return lm._mamba_mix(mix, c32, h, kv.pools,
                                         bt["ssm"][gi, j:j + 1],
                                         bt["conv"][gi, j:j + 1], n_real=c)
            else:
                def attend(mix, h):
                    return attn.attention_prefill_chunk(
                        mix, c32, h, kv.pools["kv"], bt["kv"][gi, j], pos,
                        read_pps=kv.pps, impl="ref", meta=meta)[0]
            ch[3] = lm._layer(b, c32, x, attend)
        if kind == "mamba":
            def attend(mix, h):
                return lm._mamba_mix(mix, c32, h, kv.pools,
                                     dec_bt["ssm"][gi, j],
                                     dec_bt["conv"][gi, j], decode=True)
        else:
            def attend(mix, h):
                return attn.attention_decode_paged(
                    mix, c32, h, kv.pools["kv"], dec_bt["kv"][gi, j],
                    dec_pos, impl="ref")[0]
        x_dec = lm._layer(b, c32, x_dec, attend)
        del b
    final, head = cast(model.final_norm), cast(model.embed)

    def logits(x):
        return unembed(head, c32, rms_norm(final, x, cfg.rmsnorm_eps))
    prefill = {}
    for rid, _, c, x, _ in chunks:             # each prompt's last chunk
        prefill[rid] = logits(x[:, c - 1])[0].float()
    return [prefill[rid] for rid in lanes], logits(x_dec[:, 0]).float()


def phase_jamba_per_request(torch, np, cfg, model, dev):
    """Phase 5's prompts and decode steps through the per-request entry
    points at full width (phase 23; counts reset just before, read after:
    rows 2, 3 and 5 must launch). Against float32 (``layer_major_run``):
    each prompt's last-token prefill logits no further than twice the
    plain bf16 path's distance; the first decode step's logits of the
    plain path with every lane's ssm pages zeroed just before it (a
    dropped state) further than twice the plain path's. A drop between
    prefill chunks is printed, not asserted: at random weights dt is
    ~softplus(-4.6), so a state decays within a chunk of hundreds of
    tokens. Beside it, the same prompts through the fused engine (FCFS):
    walls and agreeing greedy tokens (reported, not asserted)."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(10)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), split)
               for n, split in PROMPTS.items()]
    _sync(torch, dev)
    build.reset_launch_counts()
    run = per_request_run(torch, np, cfg, model, dev, prompts, "kernel",
                          decode_steps=DECODE_STEPS)
    launches = build.launch_counts()
    print("jamba per-request (api.prefill_chunk_paged / "
          "api.decode_step_paged): "
          + _walls(np, "prefill chunk wall", run["chunk_s"]) + "; "
          + _walls(np, "decode step wall", run["step_s"])
          + f"; kernel launches {json.dumps(launches, sort_keys=True)}")
    if not all(launches.get(k, 0) > 0 for k in (
            "paged_prefill_attention_pool", "paged_attention_pool",
            "append_kv")):
        raise AssertionError("jamba per-request: rows 2, 3 and 5 must "
                             "launch")
    if not all(len(t) == DECODE_STEPS + 1 and all(0 <= v < cfg.vocab_size
                                                  for v in t)
               for t in run["tokens"]):
        raise AssertionError("jamba per-request: wrong greedy tokens")
    del run["kv"]

    def drop(at):
        def hook(kind, kv, tokens, tables, pos, n_real):
            if kind == at and (kind == "decode" or pos > 0):
                slots = torch.as_tensor(tables["ssm"].reshape(-1).astype(
                    np.int64)).to(dev)
                kv.pools["ssm"][slots] = 0.0
        return hook
    ref = per_request_run(torch, np, cfg, model, dev, prompts, "ref",
                          decode_steps=1)
    f32, f32_step = layer_major_run(torch, np, cfg, model, dev, prompts,
                                    [t[0] for t in ref["tokens"]])
    torch.cuda.empty_cache()
    logits = {"kernel": run["logits"], "ref": ref["logits"],
              "drop between chunks": per_request_run(
                  torch, np, cfg, model, dev, prompts, "ref",
                  hook=drop("prefill"))["logits"]}
    dist = {k: [round((a - b).abs().max().item(), 4)
                for a, b in zip(v, f32)] for k, v in logits.items()}
    control = per_request_run(torch, np, cfg, model, dev, prompts, "ref",
                              decode_steps=1, hook=drop("decode"))
    step = {k: [round(v, 4) for v in (r["first_step_logits"] - f32_step)
                .abs().amax(-1).tolist()]
            for k, r in (("ref", ref), ("control", control))}
    limit, step_limit = 2 * max(dist["ref"]), 2 * max(step["ref"])
    print(f"jamba per-request, last-token prefill logits max abs diff to "
          f"f32 (layer-major) per prompt {list(PROMPTS)}: "
          f"{json.dumps(dist)}; limit {limit:.4g}; first decode step: "
          f"{json.dumps(step)} (control: every lane's ssm pages zeroed "
          f"before it); limit {step_limit:.4g}")
    if not max(dist["kernel"]) <= limit:
        raise AssertionError(
            f"jamba per-request prefill: the kernel path's logits "
            f"({max(dist['kernel'])} from float32) must be within twice the "
            f"plain bf16 path's ({limit})")
    if not step_limit < max(step["control"]):
        raise AssertionError(
            f"jamba per-request: the dropped-state control's first decode "
            f"step ({max(step['control'])} from float32) must lie beyond "
            f"twice the plain path's ({step_limit})")
    tokens, step_s, mixed, _ = fused_fcfs_run(torch, np, cfg, model, dev,
                                              prompts, "jamba")
    agree = [sum(a == b for a, b in zip(x, y))
             for x, y in zip(tokens, run["tokens"])]
    print(f"jamba fused (ServingEngine FCFS, same prompts): "
          f"{len(step_s)} steps; "
          + _walls(np, "step wall with prompt chunks", step_s[mixed]) + "; "
          + _walls(np, "decode-only step wall", step_s[~mixed])
          + f"; greedy tokens agreeing with the per-request path per prompt"
          f" {list(PROMPTS)}: {agree} of {DECODE_STEPS + 1} each")
    return launches


JAMBA_ROWS = ("paged_attention_pool", "paged_prefill_attention_pool",
              "paged_mixed_attention_pool", "append_kv", "gather_pages",
              "scatter_pages")                  # rows 2-7


def jamba_phases(torch, np, report, dev, t0):
    """jamba-v0.1-52b at its published widths, ``JAMBA_LAYERS`` deep
    (phases 20-25). Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    jcfg = get_config("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    lap, done = model_laps(torch, "jamba-v0.1-52b", t0)
    phase_jamba_kernels(torch, np, jcfg, report, dev)
    lap("rows 4-7")
    model = phase_jamba_model(torch, jcfg)
    lap("model")
    phase_moe_layer_step(torch, np, jcfg, model, dev, "jamba")
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {"jamba per-request": phase_jamba_per_request(
        torch, np, jcfg, model, dev)}
    lap("per-request")
    paths["jamba engine"], _ = phase_engine(
        torch, np, jcfg, model, dev, need=JAMBA_ROWS[2:], profile=True)
    one_writer_a_layer("jamba engine", paths["jamba engine"])
    lap("engine")
    paths["jamba round trip"] = phase_roundtrip(torch, np, jcfg, model, dev,
                                                "jamba")
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


# -- internvl2-1b, the LoRA adapter cache, gemma-7b ---------------------------
def vlm_prefix(torch, cfg, dev, seed):
    """A VLM's seeded (1, P, d) prefix block on the device in the compute
    dtype (std 0.02, the token embeddings' scale); None for a text
    model."""
    if not cfg.n_prefix_embeds:
        return None
    g = torch.Generator(device=dev).manual_seed(seed)
    return (0.02 * torch.randn((1, cfg.n_prefix_embeds, cfg.d_model),
                               generator=g, device=dev)).to(
        cfg.torch_compute_dtype())


def kv_leg_shape(cfg, leg):
    """Rows 6-7 at a model's ``kv`` leg (``gather_leg_shapes``' form): a
    park of ~800 tokens, 50 pages of 16 tokens a layer, (2, K, 16, hd)
    pages in the compute dtype."""
    return {leg: ((2, cfg.n_kv_heads, 16, cfg.resolved_head_dim),
                  cfg.torch_compute_dtype(), cfg.n_layers * 50, 0)}


def attention_rows(torch, np, cfg, report, label):
    """Rows 1-5 at a model's attention shapes (bf16, 16-token pages, 64
    pages a request, the engine's LOCAL pool): the bf16 paged kernels and
    the page writer at its head dim use no local memory; row 4 at the
    main path's packed step and at the decode-only step
    (``attention_case``), rows 1-3 with split == pool and mixed ==
    per-request bit for bit (``per_request_kernels``), row 5 in the step
    form and the decode form (``step_writer_case``, ``append_case``, each
    beside ``index_put_``). Adds a ``label`` record to each kernel's
    entry."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    K, H, hd = cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    info = pa_ops.tc_kernel_info(hd)
    writer = pa_ops.writer_kernel_info(hd)
    print(f"{label}: bf16 paged attention kernels at hd {hd}, {H} heads on "
          f"{K} (G {H // K}): " + "; ".join(
              f"{n} {r['registers']} registers, local {r['local_bytes']} B, "
              f"shared {r['smem_bytes']} B" for n, r in info.items())
          + "; page writer " + "; ".join(
              f"{dt} {r['registers']} registers, local {r['local_bytes']} B"
              for dt, r in writer.items()))
    if any(r["local_bytes"] for r in list(info.values())
           + list(writer.values())):
        raise AssertionError(f"{label}: a paged kernel at hd {hd} uses "
                             "local memory")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    g = torch.Generator(device=dev).manual_seed(17)
    page = 16
    read_pps = 1024 // page
    P = 4 * cfg.n_layers * read_pps + 1          # the engine's LOCAL pool
    pool = torch.randn((P, 2, K, page, hd), generator=g, device=dev,
                       dtype=torch.bfloat16)
    q_starts, _, n_dec, _ = main_path_plan()
    cases = {"paged_mixed_attention_pool": dict(
        attention_case(torch, np, pool, rng, g, main_path_plan(), H,
                       read_pps),
        decode_only=attention_case(torch, np, pool, rng, g,
                                   decode_only_plan(), H, read_pps))}
    cases.update(per_request_kernels(torch, np, pool, rng, g, H, read_pps))
    cases["append_kv"] = dict(
        step_writer_case(torch, np, pool, rng, g, read_pps),
        decode_only=append_case(torch, np, pool, rng, g, q_starts[:n_dec],
                                read_pps))
    for name, case in cases.items():
        rec = {k: v for k, v in case.items()
               if k not in ("name", "route", "source", "replaces")}
        next(k for k in report if k["name"] == name)[label] = rec
        for sub in [rec] + [rec[k] for k in ("decode_only", "mid_page")
                            if k in rec]:
            print(f"kernel {name} {label} {sub['shape']} (hd {hd}, {H} "
                  f"heads on {K}): err {sub['max_abs_err']:.3g} kernel "
                  f"{sub['ms']:.4f} ms plain {sub['plain_ms']:.4f} ms bound "
                  f"{sub['bound_ms'] * 1e3:.3f} us ({sub['bound_by']}) "
                  f"library {sub['library_ms']}")
    del pool


def phase_dense_model(torch, cfg, seed, want, extra=0):
    """A dense, VLM or MoE (without MLA) model at its published widths
    from a seeded CUDA generator: the reference's ``param_count()`` must
    be ``want`` and the module holds that plus its final norm's
    ``d_model`` scales and ``extra`` more (gemma3's qk-norm scales, which
    the formula leaves out too)."""
    from repro_torch.models import lm
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name} model: published widths ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}); param_count() {cfg.param_count():,} (the "
          f"reference's formula); the module holds {n:,} (+ {cfg.d_model} "
          f"final_norm scales, + {extra} more), {nbytes / 2 ** 30:.2f} GiB; "
          f"torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB; built in "
          f"{time.perf_counter() - t:.1f} s")
    if cfg.param_count() != want or n != want + cfg.d_model + extra:
        raise AssertionError(f"{cfg.name} model: wrong parameter count")
    return model


def phase_chunked_prefix(torch, np, cfg, model, dev):
    """A VLM prompt of 300 positions (the prefix's 256 rows, 44 text
    tokens) through the per-request entry points in one chunk and in
    chunks of 100 (the prefix over three chunks): the last token's logits
    within ``LAYER_REL_LIMIT`` of each other relative to the one-chunk
    logits' norm (the bf16 GEMMs tile the two chunk shapes differently);
    a control with a zero prefix beyond it."""
    P = cfg.n_prefix_embeds
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, P + 44)
    prompt[:P] = 0
    prefix = vlm_prefix(torch, cfg, dev, 8)
    c = (P + 44) // 3
    chunks = (c, c, P + 44 - 2 * c)
    one, _ = roundtrip_run(torch, np, cfg, model, dev, prompt, (P + 44,), 0,
                           False, prefix)
    logs = {"split": roundtrip_run(torch, np, cfg, model, dev, prompt,
                                   chunks, 0, False, prefix)[0][-1],
            "control": roundtrip_run(torch, np, cfg, model, dev, prompt,
                                     chunks, 0, False,
                                     torch.zeros_like(prefix))[0][-1]}
    want = one[-1].float()
    rel = {k: float((v.float() - want).norm() / want.norm())
           for k, v in logs.items()}
    same = torch.equal(logs["split"], one[-1])
    print(f"{cfg.name} chunked prefix: a {P}-row prefix + 44 tokens in "
          f"chunks of {'/'.join(map(str, chunks))} against one chunk: "
          f"last-token "
          f"logits norm-relative diff {rel['split']:.4g} (bit-identical "
          f"{same}); control with a zero prefix {rel['control']:.4g}; limit "
          f"{LAYER_REL_LIMIT}")
    if not (torch.isfinite(want).all() and rel["split"] <= LAYER_REL_LIMIT
            < rel["control"]):
        raise AssertionError(f"{cfg.name} chunked prefix: the split prefix "
                             f"must give the one-chunk logits within "
                             f"{LAYER_REL_LIMIT}, the zero prefix not")


def packed_alike_agreement(inflight, at_snapshot, runs):
    """The restored run against the original for every request in flight
    at the snapshot. A token made at steps of one packed (R, Tc) shape in
    both runs has logits within ``LAYER_REL_LIMIT`` of the original's
    (norm-relative), up to the first token where the streams part (past
    it the two are fed other tokens). A request that was decoding at the
    snapshot (its
    prompt's K/V all in the snapshot) must give the original's tokens up
    to its first token made at steps packed differently: until then its
    every K/V row and logits row comes from the same arithmetic. After
    that the two streams may part at a near-tie (random weights; the bf16
    GEMMs tile other shapes differently), reported. Returns a record."""
    (orig, made, shapes, logits), (rest, made2, shapes2, logits2) = runs
    rec = dict(requests=len(inflight), equal=0, tokens=0, agree=0,
               same_shape=0, bit_identical=0, same_rel=0.0, parted=[])
    for rid in inflight:
        a, b = orig[rid], rest[rid]
        rec["tokens"] += len(a)
        rec["agree"] += sum(x == y for x, y in zip(a, b))
        rec["equal"] += int(a == b)
        alike = [shapes[made[rid][p]] == shapes2[made2[rid][p]]
                 for p in range(at_snapshot[rid], len(a))]
        part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        last = len(a) - 1 if part is None else part
        for p in range(at_snapshot[rid], last + 1):
            if not alike[p - at_snapshot[rid]]:
                continue
            l1, l2 = logits[(rid, p)], logits2[(rid, p)]
            rel = float((l1 - l2).norm() / l1.norm())
            rec["same_shape"] += 1
            rec["bit_identical"] += int(bool((l1 == l2).all()))
            rec["same_rel"] = max(rec["same_rel"], rel)
            if rel > LAYER_REL_LIMIT:
                raise AssertionError(
                    f"restore: rid {rid} position {p}: logits {rel:.4f} "
                    f"apart at steps packed alike (limit {LAYER_REL_LIMIT})")
        if part is None:
            continue
        first_other = at_snapshot[rid] + next(
            (i for i, ok in enumerate(alike) if not ok), len(alike))
        rec["parted"].append(dict(rid=rid, position=part,
                                  first_other_shape=first_other))
        if at_snapshot[rid] > 0 and part < first_other:
            raise AssertionError(
                f"restore: rid {rid} parts at position {part} before any "
                f"of its tokens was made at steps packed differently")
    return rec


def phase_vlm_snapshot(torch, np, cfg, model, dev):
    """Phase 6's VLM requests snapshotted mid-stream (after 12 steps): the
    snapshot holds each in-flight request's prefix block on the host as
    raw bf16 words; the original runs to its end, the snapshot is restored
    into a fresh runtime and run to its end. Every request in flight at
    the snapshot finishes, with the original's tokens wherever the two
    runs packed its steps alike (``packed_alike_agreement``)."""
    from repro_torch.serving.engine import ServingEngine
    eng, _, reqs = make_engine(np, cfg, model, dev,
                               host_pages=REQUEST_HOST_PAGES)
    made, shapes = {}, {}
    drive(eng, made, shapes, max_steps=12)
    snap = eng.snapshot()
    live = snap["running"] + snap["waiting"]
    at_snapshot = {d["rid"]: len(d["generated"]) for d in live}
    inflight = sorted(at_snapshot)
    if not live or not all(isinstance(d["prefix_embeds"], np.ndarray)
                           and d["prefix_embeds"].dtype == np.int16
                           for d in live):
        raise AssertionError(f"{cfg.name} snapshot: in-flight requests' "
                             "prefix blocks are not raw bf16 words")
    logits: dict = {}
    drive(eng, made, shapes, logits)
    original = {r.rid: list(r.generated) for r in eng.finished}
    del eng, reqs
    release(torch)
    eng2 = ServingEngine.restore(cfg, model, snap, device=dev,
                                 kv=make_runtime(cfg, dev,
                                                 REQUEST_HOST_PAGES))
    made2, shapes2, logits2 = {}, {}, {}
    drive(eng2, made2, shapes2, logits2)
    restored = {r.rid: list(r.generated) for r in eng2.finished}
    if not all(len(restored.get(rid, ())) == len(original[rid])
               for rid in inflight):
        raise AssertionError(f"{cfg.name} snapshot: the restored run did "
                             "not finish every request in flight")
    rec = packed_alike_agreement(inflight, at_snapshot, (
        (original, made, shapes, logits), (restored, made2, shapes2,
                                           logits2)))
    print(f"{cfg.name} snapshot at step {snap['metrics']['steps']}: "
          f"{len(inflight)} requests in flight with their prefix blocks; "
          f"restore agreement {json.dumps(rec)}")
    del eng2
    release(torch)


ENGINE_ROWS = ("paged_mixed_attention_pool", "append_kv", "gather_pages",
               "scatter_pages")                 # rows 4-7, the fused path


def internvl2_phases(torch, np, report, dev, t0):
    """internvl2-1b at its published width (phases 26-31). Returns {path:
    launch counts}."""
    from repro_torch.configs import get_config
    icfg = get_config("internvl2-1b")
    lap, done = model_laps(torch, "internvl2-1b", t0)
    attention_rows(torch, np, icfg, report, "internvl2")
    leg_rows(torch, np, kv_leg_shape(icfg, "internvl2_kv"), report, dev)
    lap("rows 1-7")
    model = phase_dense_model(torch, icfg, 12, 493_752_448)
    phase_layer_step(torch, np, icfg, model, dev, prefix=True)
    phase_chunked_prefix(torch, np, icfg, model, dev)
    lap("model, layer step, chunked prefix")
    paths = {}
    paths["internvl2-1b engine"], _ = phase_engine(
        torch, np, icfg, model, dev, need=ENGINE_ROWS)
    lap("engine")
    paths["internvl2-1b round trip"] = phase_roundtrip(
        torch, np, icfg, model, dev, "internvl2-1b")
    phase_vlm_snapshot(torch, np, icfg, model, dev)
    lap("round trip, snapshot")
    del model
    release(torch)
    done()
    return paths


LORA_ADAPTERS = 8
LORA_RANK = 16
LORA_FETCHES = (0, 0, 4, 6, 4, 1, 7, 0)    # misses, hits, re-fetches


def phase_lora(torch, np, report, dev):
    """The AQUA adapter cache at qwen1.5-0.5b's width (phase 32): rows 6-7
    at the adapter page (``leg_rows``); 8 rank-16 adapters (3,145,728 B,
    24 pages of 65,536 bf16 each) parked in a cache of ``capacity_local``
    2 beside a same-card REMOTE lease of 100 pages, smaller than them all,
    so the first four sit on the donor, the fifth on both tiers and the
    rest on HOST. Every adapter's pages read back equal its raveled leaves
    bit for bit; along ``LORA_FETCHES`` a hit meters nothing and a miss
    meters its adapter's bytes (no tail here) as one message per tier its
    pages lie on, with misses served from both tiers. The cold fetch's
    gather from the donor is timed beside its plain version,
    ``index_select`` and its bound. ``apply_lora`` with B = 0 gives the
    unmerged model's logits bit for bit, an adapter with B != 0 moves
    them, and the model is left unchanged. Returns the launches of the
    puts and fetches."""
    from repro_torch.configs import get_config
    from repro_torch.core.aqua_tensor import HOST, REMOTE, TIER_NAMES
    from repro_torch.kernels import build
    from repro_torch.kernels.kv_gather import ops as kv_ops
    from repro_torch.kernels.kv_gather import ref as kv_ref
    from repro_torch.models import lm
    from repro_torch.serving import lora
    qcfg = get_config("qwen1.5-0.5b")
    leg_rows(torch, np, {"lora": ((65536,), qcfg.dtype(), 24, 0)}, report,
             dev)
    g = torch.Generator(device=dev).manual_seed(13)
    adapters = []
    for i in range(LORA_ADAPTERS):
        ad = lora.init_adapter(g, qcfg, rank=LORA_RANK)
        if i:                               # all but adapter 0: B != 0
            for k in ("q_b", "v_b"):
                ad[k] = (0.02 * torch.randn(ad[k].shape, generator=g,
                                            device=dev)).to(qcfg.dtype())
        adapters.append(ad)
    nbytes = lora.adapter_bytes(adapters[0])
    cache = lora.AdapterCache(capacity_local=2, page_elems=65536,
                              dtype=qcfg.dtype(), device=dev)
    page_bytes = cache.aqua.page_bytes
    n_pages = -(-nbytes // page_bytes)
    cache.aqua.add_remote_lease("donor0", 4 * n_pages + 4)
    meter = cache.aqua.meter

    def snap():
        return (meter.bytes_fabric + meter.bytes_host,
                meter.messages_fabric + meter.messages_host)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t = time.perf_counter()
    for aid, ad in enumerate(adapters):
        cache.put(aid, ad)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t
    tiers = {aid: sorted({TIER_NAMES[int(x)] for x in cache.aqua.page_table[
        cache.pages_of(aid), 0]}) for aid in range(LORA_ADAPTERS)}
    same = all(torch.equal(cache.aqua.read(cache.pages_of(aid)),
                           cache.blob(ad)) for aid, ad in enumerate(adapters))
    print(f"lora: {LORA_ADAPTERS} rank-{LORA_RANK} adapters of {nbytes} B "
          f"({n_pages} pages of {page_bytes} B) parked in {put_s * 1e3:.1f} "
          f"ms; tiers {json.dumps(tiers)}; metered {snap()[0]:.0f} B in "
          f"{snap()[1]} messages; pages read back equal the raveled leaves "
          f"bit for bit: {same}")
    if not same or nbytes != 3_145_728 or snap()[0] != (
            LORA_ADAPTERS * n_pages * page_bytes):
        raise AssertionError("lora: the parked pages differ from the "
                             "adapters' leaves or the puts' bytes are off")
    log, cold = [], set()
    for aid in LORA_FETCHES:
        before, hit = snap(), aid in cache.hits_resident
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = cache.fetch(aid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        db, dm = snap()[0] - before[0], snap()[1] - before[1]
        log.append(dict(aid=aid, hit=hit, bytes=db, messages=dm,
                        tiers=tiers[aid], wall_ms=round(wall * 1e3, 3)))
        ok = got is adapters[aid] and (
            (db, dm) == (0, 0) if hit else
            nbytes <= db <= nbytes + page_bytes and dm == len(tiers[aid]))
        if not ok:
            raise AssertionError(f"lora: fetch of adapter {aid} metered "
                                 f"{db} B in {dm} messages (hit {hit})")
        if not hit:
            cold.update(tiers[aid])
    launches = build.launch_counts()
    print(f"lora: fetches {json.dumps(log)}; resident "
          f"{cache.hits_resident}; cold fetches from {sorted(cold)}; "
          f"launches {json.dumps(launches, sort_keys=True)}")
    if not {TIER_NAMES[REMOTE], TIER_NAMES[HOST]} <= cold:
        raise AssertionError("lora: cold fetches did not come from both the "
                             "donor and the host")

    # -- the cold fetch's gather from the donor, timed ---------------------
    slots = cache.aqua.page_table[cache.pages_of(0), 1]
    pool = cache.aqua.remote_pools["donor0"]
    ids = torch.as_tensor(slots.astype(np.int32)).to(dev)
    ids64 = ids.long()
    if not torch.equal(kv_ops.gather_pages(pool, ids),
                       kv_ref.gather_pages_ref(pool, ids)):
        raise AssertionError("lora: the fetch's gather differs from its "
                             "plain version")
    ms, plain_ms = interleaved(lambda: kv_ref.gather_pages_ref(pool, ids),
                               lambda: kv_ops.gather_pages(pool, ids), 50)
    lib = against_library(np, lambda: torch.index_select(pool, 0, ids64),
                          lambda: kv_ops.gather_pages(pool, ids), 50)
    b, by = bound_ms(2 * n_pages * page_bytes + 4 * n_pages)
    rec = dict(shape=f"lora fetch: {n_pages} pages of {page_bytes} B from "
                     f"the donor's {pool.shape[0]}", max_abs_err=0.0,
               tolerance=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib["library_median_ms"],
               vs_library=lib)
    next(k for k in report if k["name"] == "gather_pages")["lora_fetch"] = rec
    print(f"kernel gather_pages {rec['shape']}: kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b * 1e3:.3f} us ({by}) library "
          f"{rec['library_ms']:.4f} ms; vs library: {json.dumps(lib)}")
    del cache, pool

    # -- apply_lora: identity at B = 0, moved at B != 0 --------------------
    model = lm.init_params(qcfg, torch.Generator(device=dev).manual_seed(14),
                           dev)
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        0, qcfg.vocab_size, (1, 128))).to(dev)
    wq0 = model.blocks[0].mix.wq.w.clone()

    def logits(m):
        out = lm.forward(m, qcfg, toks, impl="ref")[0].float()
        torch.cuda.synchronize()
        return out
    base = logits(model)
    ident = torch.equal(logits(lora.apply_lora(model, qcfg, adapters[0])),
                        base)
    moved = (logits(lora.apply_lora(model, qcfg, adapters[1]))
             - base).abs().max().item()
    kept = torch.equal(model.blocks[0].mix.wq.w, wq0)
    print(f"lora: apply_lora at full width (128 tokens): B = 0 gives the "
          f"unmerged logits bit for bit: {ident}; adapter 1 (B != 0) moves "
          f"them by up to {moved:.4g}; the model left unchanged: {kept}")
    if not (ident and moved > 1e-3 and kept):
        raise AssertionError("lora: the merge is not the identity at B = 0, "
                             "moves nothing at B != 0, or changed the model")
    del model
    release(torch)
    return launches


GEMMA_ROWS = ("paged_attention", "paged_attention_pool",
              "paged_prefill_attention_pool", "paged_mixed_attention_pool",
              "append_kv", "gather_pages", "scatter_pages")   # rows 1-7


def gemma_phases(torch, np, report, dev, t0):
    """gemma-7b at its published width (phases 33-38). Returns {path:
    launch counts}."""
    from repro_torch.configs import get_config
    gcfg = get_config("gemma-7b")
    lap, done = model_laps(torch, "gemma-7b", t0)
    attention_rows(torch, np, gcfg, report, "gemma")
    leg_rows(torch, np, kv_leg_shape(gcfg, "gemma_kv"), report, dev)
    lap("rows 1-7")
    model = phase_dense_model(torch, gcfg, 15, 8_537_677_824)
    lap("model")
    phase_layer_step(torch, np, gcfg, model, dev, whole_f32=False)
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {}
    (paths["gemma-7b per-request"],
     paths["gemma-7b split-pool drive"]) = phase_per_request(
        torch, np, gcfg, model, dev, whole_f32=False)
    lap("per-request")
    # a lease that holds every parked request, 8 x 28 layers x 50 pages of
    # 262,144 B (2.9 GB; 2 GiB would spill legs to the host)
    paths["gemma-7b engine"], _ = phase_engine(
        torch, np, gcfg, model, dev, need=ENGINE_ROWS, profile=True,
        lease_bytes=4 * 1024 ** 3)
    lap("engine")
    paths["gemma-7b round trip"] = phase_roundtrip(torch, np, gcfg, model,
                                                   dev, "gemma-7b")
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


# -- the paper's models (aqua-llama2-13b, aqua-codellama-34b, aqua-opt-30b),
# dbrx-132b, minicpm-2b ------------------------------------------------------
DBRX_LAYERS = 8                     # 50.86 GiB, room beside a float32 copy
#                                     of one MoE layer (~12.1 GiB); 10 layers
#                                     are 63.0 GiB of weights alone


def dbrx_phases(torch, np, report, dev, t0):
    """dbrx-132b at its published widths, ``DBRX_LAYERS`` of 40 layers
    (phases 39-44). Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    full = get_config("dbrx-132b")
    cfg = full.replace(n_layers=DBRX_LAYERS)
    lap, done = model_laps(torch, "dbrx-132b", t0)
    attention_rows(torch, np, cfg, report, "dbrx")
    lap("rows 1-5")
    print(f"dbrx-132b: {DBRX_LAYERS} of the published {full.n_layers} "
          f"layers ({full.param_count():,} parameters, "
          f"{full.param_count() * 2 / 2 ** 30:.2f} GiB in bf16 whole)")
    model = phase_dense_model(torch, cfg, 16, 27_305_803_776)
    lap("model")
    phase_moe_layer_step(torch, np, cfg, model, dev, "dbrx")
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {}
    (paths["dbrx-132b per-request"],
     paths["dbrx-132b split-pool drive"]) = phase_per_request(
        torch, np, cfg, model, dev, whole_f32=False)
    release(torch)
    lap("per-request")
    paths["dbrx-132b engine"], _ = phase_engine(
        torch, np, cfg, model, dev, need=ENGINE_ROWS, profile=True)
    one_writer_a_layer("dbrx-132b engine", paths["dbrx-132b engine"])
    release(torch)          # the engines' pools wait for the collector
    lap("engine")
    paths["dbrx-132b round trip"] = phase_roundtrip(torch, np, cfg, model,
                                                    dev, "dbrx-132b")
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


def llama2_phases(torch, np, report, dev, t0):
    """aqua-llama2-13b at its published width (phases 45-50). Returns
    {path: launch counts}."""
    from repro_torch.configs import get_config
    cfg = get_config("aqua-llama2-13b")
    lap, done = model_laps(torch, cfg.name, t0)
    attention_rows(torch, np, cfg, report, "llama2")
    leg_rows(torch, np, kv_leg_shape(cfg, "llama2_kv"), report, dev)
    lap("rows 1-7")
    model = phase_dense_model(torch, cfg, 17, 13_015_859_200)
    lap("model")
    phase_layer_step(torch, np, cfg, model, dev, whole_f32=False)
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {}
    (paths["aqua-llama2-13b per-request"],
     paths["aqua-llama2-13b split-pool drive"]) = phase_per_request(
        torch, np, cfg, model, dev, whole_f32=False)
    release(torch)
    lap("per-request")
    # every parked request's pages: 8 x 40 layers x 50 pages of 327,680 B
    # (5.24 GB)
    paths["aqua-llama2-13b engine"], _ = phase_engine(
        torch, np, cfg, model, dev, need=ENGINE_ROWS,
        lease_bytes=6 * 1024 ** 3)
    one_writer_a_layer("aqua-llama2-13b engine",
                       paths["aqua-llama2-13b engine"])
    release(torch)          # the engines' pools wait for the collector
    lap("engine")
    paths["aqua-llama2-13b round trip"] = phase_roundtrip(
        torch, np, cfg, model, dev, cfg.name)
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


def codellama_phases(torch, np, report, dev, t0):
    """aqua-codellama-34b at its published width (phases 51-55): 62.85 GiB
    of weights, whose reads bound a decode-only step at 20.1 ms. Returns
    {path: launch counts}."""
    from repro_torch.configs import get_config
    cfg = get_config("aqua-codellama-34b")
    lap, done = model_laps(torch, cfg.name, t0)
    attention_rows(torch, np, cfg, report, "codellama")
    lap("rows 1-5")
    model = phase_dense_model(torch, cfg, 18, 33_744_224_256)
    lap("model")
    phase_layer_step(torch, np, cfg, model, dev, whole_f32=False)
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {}
    paths["aqua-codellama-34b engine"], _ = phase_engine(
        torch, np, cfg, model, dev, need=ENGINE_ROWS, profile=True)
    one_writer_a_layer("aqua-codellama-34b engine",
                       paths["aqua-codellama-34b engine"])
    release(torch)          # the engines' pools wait for the collector
    lap("engine")
    paths["aqua-codellama-34b round trip"] = phase_roundtrip(
        torch, np, cfg, model, dev, cfg.name)
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


def opt_phases(torch, np, report, dev, t0):
    """aqua-opt-30b at its published width (phases 56-60): the non-gated
    gelu MLP, 458,752 B kv pages and a LOCAL pool of 12,289 of them, past
    2^31 bf16 elements. Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    cfg = get_config("aqua-opt-30b")
    lap, done = model_laps(torch, cfg.name, t0)
    leg_rows(torch, np, kv_leg_shape(cfg, "opt_kv"), report, dev)
    # rows 1-5 over the engine's LOCAL pool, 5.64 GB: table entries drawn
    # from every slot, a quarter of them past element 2^31 (slot 9,363 on)
    attention_rows(torch, np, cfg, report, "opt")
    lap("rows 1-7")
    model = phase_dense_model(torch, cfg, 19, 30_316_396_544)
    lap("model")
    phase_layer_step(torch, np, cfg, model, dev, whole_f32=False)
    torch.cuda.empty_cache()
    lap("layer step")
    paths = {}
    # every parked request's pages: 8 x 48 layers x 50 pages of 458,752 B
    # (8.81 GB)
    paths["aqua-opt-30b engine"], _ = phase_engine(
        torch, np, cfg, model, dev, need=ENGINE_ROWS,
        lease_bytes=9 * 1024 ** 3)
    one_writer_a_layer("aqua-opt-30b engine", paths["aqua-opt-30b engine"])
    release(torch)          # the engines' pools wait for the collector
    lap("engine")
    # the request's 20 pages x 48 layers (440 MB)
    paths["aqua-opt-30b round trip"] = phase_roundtrip(
        torch, np, cfg, model, dev, cfg.name, lease_bytes=1 << 29)
    lap("round trip")
    del model
    release(torch)
    done()
    return paths


def minicpm_phase(torch, np, dev, t0):
    """minicpm-2b at its published width (phase 61): its count and phase
    6's engine run. Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    cfg = get_config("minicpm-2b")
    lap, done = model_laps(torch, cfg.name, t0)
    model = phase_dense_model(torch, cfg, 20, 2_724_878_592)
    launches, _ = phase_engine(torch, np, cfg, model, dev, need=ENGINE_ROWS)
    one_writer_a_layer("minicpm-2b engine", launches)
    release(torch)
    lap("model, engine")
    del model
    release(torch)
    done()
    return {"minicpm-2b engine": launches}


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
TRAIN_RUNS: dict = {}               # label -> the last run's step summary


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
    call must do and move (``flash_attention/ops.py:cost``): 2 products
    forward and 5 backward of 2 FLOP per visible (query, key) pair and
    head dim per query head; q, k, v (and o, dO) read once, o (dq, dk, dv)
    written once, lse and D in float32."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    B, Sq, Sk, H, K, hd, causal, window = shape
    kw = dict(causal=causal, window=window, itemsize=itemsize)
    return (*fa_ops.cost(B, Sq, Sk, H, K, hd, **kw),
            *fa_ops.cost(B, Sq, Sk, H, K, hd, backward=True, **kw))


def library_attention_ms(torch, q, k, v, do, iters, window=0,
                         causal=True):
    """The yardstick: ``scaled_dot_product_attention`` (causal with
    Sq == Sk, or bidirectional at any Sq, Sk; a window as an explicit
    boolean mask; fewer KV heads than query heads through ``enable_gqa``)
    on the same inputs, forward alone and, given ``do``, forward +
    backward (else None), device ms per call. Timed here only; the port
    never calls it."""
    from torch.nn import functional as F
    from repro_torch.kernels.flash_attention.ref import attention_mask
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(is_causal=causal)
    if window > 0:
        kw = dict(attn_mask=attention_mask(q.shape[1], k.shape[1], causal,
                                           window, q.device))
    if q.shape[2] != k.shape[2]:
        kw["enable_gqa"] = True

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    if do is None:
        return device_ms(fwd, iters), None
    dot = do.transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, **kw)
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

    print(f"train step (batch 1, seq {TRAIN_SEQ}): attention per layer, "
          f"kernel vs plain per token max {max(rel['kernel']):.4g} (limit "
          f"{LAYER_REL_LIMIT}), control (layer {control_layer} loses its "
          f"diagonal key) min {min(rel['control']):.4g}")
    print(f"train step: launches {json.dumps(launches, sort_keys=True)}")
    check_step_grads("train step", loss_k, g_k, loss_r, g_r, loss_c, g_c)
    del g_k, g_r, g_c
    if not max(rel["kernel"]) <= LAYER_REL_LIMIT < min(rel["control"]):
        raise AssertionError(f"train step attention: kernel {rel['kernel']} "
                             f"control {rel['control']}")
    if launches.get("flash_attention", 0) != cfg.n_layers or launches.get(
            "flash_attention_bwd", 0) < cfg.n_layers:
        raise AssertionError(f"train step launches {launches}: want "
                             f"{cfg.n_layers} forward, >= {cfg.n_layers} "
                             "backward")
    return launches


def phase_train_run(torch, np, cfg, dev, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, *, remat=False,
                    label="train", seed=3, ranges=False):
    """``train_loop.train`` for ``steps`` steps at full width (module
    docstring, phases 13, 64, 65 and 67), then one profiled step (its
    ``moe`` and ``mamba_scan`` ranges with ``ranges``). Returns the run's
    launches."""
    from repro_torch.kernels import build
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule
    from repro_torch.training.train_loop import TrainConfig, train
    dcfg = DataConfig(seed=0, batch=batch, seq_len=seq)
    ocfg = AdamWConfig(lr=cosine_schedule(3e-4, warmup=1, total=steps))
    tcfg = TrainConfig(steps=steps, impl="kernel", remat=remat)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cuda = dev.type == "cuda"
    n_params = cfg.param_count()
    if label != "train":
        print(f"{label} run: {cfg.n_layers} layers, {n_params:,} parameters"
              f", training state {n_params * TRAIN_STATE_BYTES / 2 ** 30:.2f}"
              f" GiB at {TRAIN_STATE_BYTES} B a parameter (bf16 param and "
              f"grad, float32 master, mu and nu); remat {remat}")
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
    model_flop, active = train_model_flop(cfg, batch, seq)
    p50 = float(np.percentile(steady, 50))
    print(f"{label} run: {steps} steps, batch {batch} x {seq}, losses "
          f"{[round(l, 4) for l in losses]}")
    print(f"{label} run: step time (steps 2-{steps}) p50 "
          f"{p50 * 1e3:.2f} ms p99 {np.percentile(steady, 99) * 1e3:.2f} ms;"
          f" first step {secs[0] * 1e3:.2f} ms; {tokens / p50:.1f} tokens/s;"
          f" peak memory {peak:.2f} GiB")
    print(f"{label} run: launches per step "
          f"{json.dumps({k: v / steps for k, v in launches.items()})}"
          f"; model FLOP per step {model_flop:.4g} (6 x {active} active "
          f"params x {tokens} tokens + attention "
          f"{model_flop - 6 * active * tokens:.4g}), "
          f"{model_flop / BF16_FLOPS * 1e3:.2f} ms at the bf16 peak: "
          f"model-FLOP share {model_flop / (p50 * BF16_FLOPS):.4f} of the "
          f"p50 step")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label} run losses {losses}: must be finite "
                             "and fall")
    TRAIN_RUNS[label] = dict(p50_ms=p50 * 1e3, tokens_per_s=tokens / p50,
                             peak_gib=peak, launches_per_step={
                                 k: v / steps for k, v in launches.items()})
    if cuda:
        profile_train_step(torch, cfg, dcfg, ocfg, tcfg, out, steps, label,
                           ranges)
    del out
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


def profile_train_step(torch, cfg, dcfg, ocfg, tcfg, out, step,
                       label="train", ranges=False):
    """One more steady step of the trained model under ``torch.profiler``
    (CPU and CUDA activities): device time by kernel name (top 10), the
    flash kernels' sum against the step, the device's idle share (1 - the
    union of device activity over the step's wall) and the kernels it
    launched; with ``ranges``, the launch calls and host syncs inside the
    ``moe`` / ``mamba_scan`` ranges and the device time of the kernels
    that start inside them (forward and remat recomputation: autograd runs
    the backward outside any range). Prints "not measured" where the trace
    holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_loop import make_train_step
    step_fn = make_train_step(cfg, ocfg, tcfg)
    batch = make_batch(dcfg, cfg, step)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        if ranges:
            stack.enter_context(profile_ranges(torch))
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        t = time.perf_counter()
        step_fn(out["params"], out["opt"], batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    launches = build.launch_counts()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and e.time_range.elapsed_us() > 0 and e.name not in RANGES]
    if not device:
        print(f"{label} profile: one step {wall_us / 1e3:.2f} ms wall; "
              "device time by kernel, flash share and idle share: not "
              "measured (the trace holds no device events)")
        return
    summary = device_time_summary(
        [(e.name, e.time_range.start, e.time_range.end) for e in device],
        wall_us)
    summary["kernel_launches"] = launches
    if ranges:
        summary.update(host_calls(prof))
        for name in RANGES:
            spans = [(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and e.name == name]
            if spans:
                summary[f"{name}_device_ms"] = sum(
                    e.time_range.elapsed_us() for e in device
                    if any(lo <= e.time_range.start <= hi
                           for lo, hi in spans)) / 1e3
    print(f"{label} profile: " + json.dumps(summary))
    if ranges and summary.get(f"{MOE_RANGE}_host_syncs", 0):
        raise AssertionError(f"{label}: {summary[f'{MOE_RANGE}_host_syncs']}"
                             " host syncs inside the MoE's range")


# -- training beyond the dense family (phases 62-67) -------------------------
WKV_BWD_SRC = "src/repro_torch/csrc/wkv6_bwd.cu"
# (B, T) of the WKV backward at rwkv6-3b's training shape, and with a short
# last chunk
WKV_TRAIN_SHAPES = {"train": (4, 2048), "short_tail": (4, 2047)}
WKV_BWD_LIMITS = {"float32": (1e-3, 5e-4),    # rtol, atol: the state's
                  "bfloat16": 2e-2}           # of the plain norm (flash's),
#                                               per chunk of 32 tokens
RWKV_TRAIN_LAYERS = 32              # rwkv6-3b's whole depth: 57.11 GiB state
RWKV_CONTROL_SEGMENT = 256          # the control drops the state this often
RWKV_CHECK_LAYERS = 4               # the per-parameter check's depth: at
#                                     random init the whole depth's
#                                     gradients part with any rounding
DEEPSEEK_TRAIN_LAYERS = 3           # 2,173,972,480 params, 32.39 GiB state
SHORT_RUN_STEPS = 5                 # rwkv6-3b's, deepseek's and
#                                     internvl2's runs
JAMBA_TRAIN_SEQ = 1024              # the Mamba scan's autograd keeps ~1 GB
#                                     of doubling products a 128-token chunk
TRAIN_STATE_BYTES = 16              # bf16 param + grad, f32 master, mu, nu


def wkv_bwd_bound(B, T, H, hd, io_bytes):
    """Least time of one WKV backward call: the bytes it must move (r, k,
    v, dy read and dr, dk, dv written in the compute dtype; w read and dw
    written, the state and dstate_out read and dstate written, u read and
    du written, in float32) over the memory rate, against the algorithm's
    float32 operations over 67 TFLOP/s and its exponentials (one a causal
    pair and key dim) over the special-function units' rate
    (``rwkv6_wkv/ops.py:work``). The scratch a kernel keeps between
    passes is not counted. Returns (ms, bound_by, parts)."""
    return wkv_parts(B, T, H, hd, io_bytes, backward=True)


def wkv_bwd_inputs(torch, g, B, T, H, hd, wmax, dtype, dev):
    """``wkv_inputs`` in ``dtype``, and dy (B,T,H,hd) in it, dstate_out
    (B,H,hd,hd) float32, both standard normal."""
    r, k, v, w, u, s0 = wkv_inputs(torch, g, B, T, H, hd, wmax, dev)
    dy = torch.randn((B, T, H, hd), generator=g, device=dev)
    dso = torch.randn((B, H, hd, hd), generator=g, device=dev)
    return [r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0, dy.to(dtype),
            dso]


def wkv_bwd_ratio(torch, got, want, dname):
    """The largest error over the six gradients as a share of its limit:
    float32 ``limit_ratio`` at rtol 1e-3 / atol 5e-4; bf16 the distance
    over the plain gradient's norm, over 2e-2, taken per chunk of 32
    tokens for dr, dk, dv and dw (so one chunk's fault is not averaged
    away over 64) and whole for du and dstate."""
    if dname == "float32":
        return max(limit_ratio(a, b, *WKV_BWD_LIMITS[dname])
                   for a, b in zip(got, want))

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()
    T = got[0].shape[1]
    worst = max(rel(a[:, t0:t0 + 32], b[:, t0:t0 + 32])
                for a, b in zip(got[:4], want[:4]) for t0 in range(0, T, 32))
    worst = max([worst] + [rel(a, b) for a, b in zip(got[4:], want[4:])])
    return worst / WKV_BWD_LIMITS[dname]


def wkv_bwd_control(torch, wkv_ref, args, want):
    """The plain backward with one chunk's dS' dropped: the chunks up to
    the middle one walked again from a zero exit-state gradient, the later
    chunks' gradients kept (du takes no dS')."""
    T = args[0].shape[1]
    end = (T // 32 // 2 + 1) * 32
    head = [a[:, :end].contiguous() for a in args[:4]]
    dy = args[6][:, :end].contiguous()
    part = wkv_ref.wkv6_backward_plain(*head, args[4], args[5], dy,
                                       torch.zeros_like(args[7]))
    return ([torch.cat([p, w[:, end:]], 1) for p, w in zip(part[:4],
                                                          want[:4])]
            + [want[4], part[5]])


def wkv_bwd_pass_ratios(torch, wkv_ops, wkv_ref, args, dname):
    """Each pass of the backward alone against its plain twin on ``args``
    (the chunk pass from the twins' states and state gradients): {pass:
    error/limit}, the state passes at the float32 limits (their arithmetic
    is float32 in either dtype), the chunk pass by ``wkv_bwd_ratio``."""
    r, k, v, w, u, s0, dy, ds = args
    states = wkv_ref.wkv6_bwd_states_plain(k, v, w, s0).contiguous()
    dstates, dstate = wkv_ref.wkv6_bwd_dstates_plain(r, w, dy, ds)
    dstates = dstates.contiguous()
    lim = WKV_BWD_LIMITS["float32"]
    out = {"states": limit_ratio(wkv_ops.wkv6_bwd_states(*args), states,
                                 *lim)}
    got = wkv_ops.wkv6_bwd_dstates(*args)
    out["dstates"] = max(limit_ratio(a, b, *lim)
                         for a, b in zip(got, (dstates, dstate)))
    part = wkv_ref.wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states, dstates)
    out["chunk"] = wkv_bwd_ratio(
        torch, wkv_ops.wkv6_bwd_chunk(r, k, v, w, u, s0, dy, states,
                                      dstates),
        list(part[:4]) + [part[4].sum((0, 2))], dname)
    return out


def kernel_ms_by_name(torch, fn, kernels, calls=20):
    """Device ms a call of ``fn`` spends in each kernel of ``kernels``
    ({label: a substring of the kernel's name}), from ``calls`` calls under
    one profiler session (after a warm-up call): each kernel's summed time
    over its own number of events, so an event the trace drops at the
    window's edge costs no kernel its number. None where the trace holds
    no event of some kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {label: [] for label in kernels}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for label, part in kernels.items():
            if part in e.name:
                us[label].append(e.time_range.elapsed_us())
    if not all(us.values()):
        return None
    return {label: sum(v) / len(v) / 1e3 for label, v in us.items()}


def wkv_bwd_pass_ms(torch, wkv_ops, args, calls=20):
    """Device ms of each pass's kernel per ``wkv6_bwd`` call, by kernel
    name (``kernel_ms_by_name``)."""
    return kernel_ms_by_name(
        torch, lambda: wkv_ops.wkv6_bwd(*args),
        {name: f"{name}_kernel" for name in wkv_ops.BWD_PASSES}, calls)


def phase_wkv_bwd_kernel(torch, np, cfg, report):
    """The WKV backward kernel against ``wkv6_backward_plain`` on the card
    (module docstring, phase 62)."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    for hd in (32, 64):
        for name, info in wkv_ops.wkv6_bwd_kernel_info(hd).items():
            print(f"wkv6_bwd kernel hd {hd}: {name} {json.dumps(info)}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    hd = cfg.ssm.rwkv_head_dim
    H = cfg.d_model // hd
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = {}
    for name, (B, T) in WKV_TRAIN_SHAPES.items():
        for dname, dt in dtypes.items():
            ratios, controls, errs, same = [], [], [], True
            passes = {}
            for wmax in WKV_DECAYS:
                args = wkv_bwd_inputs(torch, g, B, T, H, hd, wmax, dt, dev)
                for n, x in wkv_bwd_pass_ratios(torch, wkv_ops, wkv_ref,
                                                args, dname).items():
                    passes[n] = max(passes.get(n, 0.0), x)
                got = wkv_ops.wkv6_bwd(*args)
                again = wkv_ops.wkv6_bwd(*args)
                want = wkv_ref.wkv6_backward_plain(*args)
                ctrl = wkv_bwd_control(torch, wkv_ref, args, want)
                torch.cuda.synchronize()
                same &= all(torch.equal(a, b) for a, b in zip(got, again))
                if not all(bool(torch.isfinite(t).all()) for t in got):
                    raise AssertionError(f"wkv6_bwd {name} {dname}: not "
                                         "finite")
                ratios.append(wkv_bwd_ratio(torch, got, want, dname))
                controls.append(wkv_bwd_ratio(torch, ctrl, want, dname))
                errs.append(max((a.float() - b.float()).abs().max().item()
                                for a, b in zip(got, want)))
                del got, again, want, ctrl, args
            cases[f"{name} {dname}"] = dict(
                shape=f"B={B} T={T} H={H} hd={hd} {dname} r/k/v/dy",
                limit_ratio=max(ratios), control_ratio=min(controls),
                max_abs_err=max(errs), bit_identical=same,
                pass_limit_ratios=passes)
            print(f"kernel wkv6_bwd B={B} T={T} H={H} hd={hd} {dname}: "
                  f"error/limit {max(ratios):.3g} (decays up to "
                  f"{max(WKV_DECAYS)}; limit {WKV_BWD_LIMITS[dname]}); "
                  f"control (one chunk's dS' dropped) {min(controls):.3g}; "
                  f"max abs err {max(errs):.3g}; two launches bit-identical "
                  f"{same}; each pass against its twin, error/limit "
                  + ", ".join(f"{n} {x:.3g}" for n, x in passes.items()))
            if not (max(ratios) <= 1.0 < min(controls) and same
                    and max(passes.values()) <= 1.0):
                raise AssertionError(
                    f"wkv6_bwd {name} {dname}: error/limit {max(ratios)} "
                    f"must be <= 1, the control's {min(controls)} above "
                    f"it, two launches equal ({same}), each pass within "
                    f"its limit ({passes})")
    # times at the training shape, bf16, strong decay: plain, kernel,
    # kernel, plain (the plain backward and autograd through the chunked
    # form issue thousands of launches a call: host-paced event timing)
    B, T = WKV_TRAIN_SHAPES["train"]
    args = wkv_bwd_inputs(torch, g, B, T, H, hd, max(WKV_DECAYS),
                          torch.bfloat16, dev)
    p1 = ms_timer(lambda: wkv_ref.wkv6_backward_plain(*args), 2)
    k1 = device_ms(lambda: wkv_ops.wkv6_bwd(*args), 10)
    k2 = device_ms(lambda: wkv_ops.wkv6_bwd(*args), 10)
    p2 = ms_timer(lambda: wkv_ref.wkv6_backward_plain(*args), 2)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    leaves = [a.detach().requires_grad_() for a in args[:6]]

    def autograd_chunked():
        y, s = wkv_ref.wkv6_chunked(*leaves)
        return torch.autograd.grad([y, s], leaves, [args[6], args[7]])
    fwd_ms = ms_timer(lambda: wkv_ref.wkv6_chunked(*args[:6]), 2)
    fb_ms = ms_timer(autograd_chunked, 2)
    pass_ms = wkv_bwd_pass_ms(torch, wkv_ops, args)
    b, by, parts = wkv_bwd_bound(B, T, H, hd, 2)
    print(f"kernel wkv6_bwd B={B} T={T} H={H} hd={hd} bf16: kernel "
          f"{ms:.4f} ms, plain backward {plain_ms:.4f} ms, autograd through "
          f"wkv6_chunked {fb_ms:.4f} ms forward + backward ({fwd_ms:.4f} "
          f"forward alone); bound {b:.4f} ms ({by}: bytes "
          f"{parts['bytes']:.4f}, f32 {parts['f32']:.4f}, exp "
          f"{parts['exp']:.4f} ms), {b / ms:.4f} of it; per pass, mean of 20 "
          f"profiled calls (ms): "
          f"{json.dumps(pass_ms) if pass_ms else 'not measured'}")
    del args, leaves
    main = cases["train bfloat16"]
    report.append(dict(
        name="wkv6_bwd", route="cuda", source=WKV_BWD_SRC,
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:81",
        replaces_note="no Pallas backward: the reference differentiates "
        "wkv6_chunked (src/repro/layers/rwkv6.py:92) with jax.grad",
        shape=main["shape"], max_abs_err=main["max_abs_err"],
        limit_ratio=max(c["limit_ratio"] for c in cases.values()),
        control_ratio=min(c["control_ratio"] for c in cases.values()),
        tolerance="float32 rtol 1e-3 atol 5e-4; bf16 2e-2 of the plain norm",
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        bound_parts_ms=parts, library_ms=None,
        autograd_chunked_ms=fb_ms, autograd_chunked_forward_ms=fwd_ms,
        pass_ms=pass_ms or "not measured", cases=cases))


def grad_rel(gs, ref):
    """Per parameter: the distance of ``gs`` to ``ref`` over ``ref``'s
    norm."""
    return {n: ((gs[n].float() - ref[n].float()).norm()
                / ref[n].float().norm().clamp_min(1e-30)).item() for n in ref}


def check_step_grads(label, loss_k, gk, loss_r, g_r, loss_c, gc):
    """Phase 12's check on a train step: the kernel path's loss within
    ``LOSS_ABS_LIMIT`` of the plain path's and every gradient within
    ``GRAD_REL_LIMIT`` of the plain one's norm; the control's worst
    gradient beyond. ``gk`` / ``gc``: the kernel's and the control's
    gradients, or (``g_r`` None) their ``grad_rel`` distances already."""
    import math
    if g_r is not None:
        gk, gc = grad_rel(gk, g_r), grad_rel(gc, g_r)
    worst = sorted(gk.items(), key=lambda kv: -kv[1])[:3]
    finite = all(math.isfinite(v) for v in gk.values())
    print(f"{label}: loss kernel {loss_k:.6f} plain {loss_r:.6f} (|d| "
          f"{abs(loss_k - loss_r):.3g}, limit {LOSS_ABS_LIMIT}) control "
          f"{loss_c:.6f} (|d| {abs(loss_c - loss_r):.3g})")
    print(f"{label}: gradients kernel vs plain, relative norm, worst "
          f"{[(n, float(f'{r:.3g}')) for n, r in worst]} (limit "
          f"{GRAD_REL_LIMIT}); control worst {max(gc.values()):.4g} "
          f"({max(gc, key=gc.get)})")
    if not (finite and abs(loss_k - loss_r) <= LOSS_ABS_LIMIT
            and max(gk.values()) <= GRAD_REL_LIMIT < max(gc.values())):
        raise AssertionError(f"{label}: loss {loss_k} vs {loss_r}, "
                             f"gradients {worst}, control {max(gc.values())}"
                             f", finite {finite}")


@contextlib.contextmanager
def wkv_calls_held(torch, records):
    """Within the block every WKV forward and backward launch is held
    against its plain version on the same inputs (``wkv6_plain``,
    ``wkv6_backward_plain``): each call's error over its limit is appended
    to ``records["fwd"]`` / ``records["bwd"]``."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    fwd, bwd = wkv_ops._forward, wkv_ops.wkv6_bwd

    def held_fwd(*args):
        got = fwd(*args)
        records["fwd"].append(wkv_ratio(got, wkv_ref.wkv6_plain(*args)))
        return got

    def held_bwd(*args):
        got = bwd(*args)
        dname = str(args[0].dtype).split(".")[-1]
        records["bwd"].append(wkv_bwd_ratio(
            torch, got, wkv_ref.wkv6_backward_plain(*args), dname))
        return got
    wkv_ops._forward, wkv_ops.wkv6_bwd = held_fwd, held_bwd
    try:
        yield
    finally:
        wkv_ops._forward, wkv_ops.wkv6_bwd = fwd, bwd


def phase_rwkv_train_step(torch, np, cfg, model, dev):
    """rwkv6-3b's train step at batch 1 x 2048 with remat (module
    docstring, phase 63). Returns the kernel step's launches."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked, wkv6_plain
    from repro_torch.layers import rwkv6 as rwkv
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.models import api, lm
    from repro_torch.models.losses import shifted_xent
    from repro_torch.training.data import DataConfig, make_batch
    batch = make_batch(DataConfig(seed=0, batch=1, seq_len=TRAIN_SEQ), cfg, 0)
    tokens = batch["tokens"].to(dev)
    seg = RWKV_CONTROL_SEGMENT

    def path(c, impl):
        return lambda m, b: api.loss_fn(m, c, b, remat=True, impl=impl)

    @contextlib.contextmanager
    def plain_wkv(fn):
        saved, rwkv.wkv6_plain = rwkv.wkv6_plain, fn
        try:
            yield
        finally:
            rwkv.wkv6_plain = saved

    # 1. whole depth in bf16: every WKV call held against its plain version
    # in context; the loss; the gradients beside the plain path's own
    # spread (chunks of 64 in place of 32)
    label = (f"rwkv6-3b train step (batch 1, seq {TRAIN_SEQ}, "
             f"{cfg.n_layers} layers, {cfg.param_count():,} parameters, "
             "remat, bf16)")
    records = {"fwd": [], "bwd": []}
    build.reset_launch_counts()
    with wkv_calls_held(torch, records):
        loss_k, g_k = train_step_grads(torch, model, batch,
                                       path(cfg, "kernel"))
    _sync(torch, dev)
    launches = build.launch_counts()
    loss_r, g_r = train_step_grads(torch, model, batch, path(cfg, "ref"))
    with plain_wkv(lambda *a: wkv6_chunked(*a, chunk=64)):
        loss_64, g_64 = train_step_grads(torch, model, batch,
                                         path(cfg, "ref"))
    _sync(torch, dev)
    gk, g64 = grad_rel(g_k, g_r), grad_rel(g_64, g_r)
    del g_k, g_r, g_64
    med = {n: float(np.median(list(g.values()))) for n, g in
           (("kernel", gk), ("chunk 64", g64))}
    print(f"{label}: launches {json.dumps(launches, sort_keys=True)}; every"
          f" WKV call against its plain version on the same inputs: "
          f"forward error/limit max {max(records['fwd']):.3g} over "
          f"{len(records['fwd'])} calls, backward {max(records['bwd']):.3g} "
          f"over {len(records['bwd'])}")
    print(f"{label}: loss kernel {loss_k:.6f} plain {loss_r:.6f} (|d| "
          f"{abs(loss_k - loss_r):.3g}, limit {LOSS_ABS_LIMIT}), plain with "
          f"chunks of 64 {loss_64:.6f}; gradients against the plain path's,"
          f" relative norm, median / worst: kernel {med['kernel']:.3g} / "
          f"{max(gk.values()):.3g} ({max(gk, key=gk.get)}), the plain path "
          f"with chunks of 64 {med['chunk 64']:.3g} / "
          f"{max(g64.values()):.3g} ({max(g64, key=g64.get)}): at random "
          "init the whole depth's gradients part with any rounding, not "
          "held per parameter here")
    if not (max(records["fwd"]) <= 1.0 and max(records["bwd"]) <= 1.0
            and abs(loss_k - loss_r) <= LOSS_ABS_LIMIT):
        raise AssertionError(f"{label}: WKV calls {max(records['fwd'])} / "
                             f"{max(records['bwd'])}, loss {loss_k} vs "
                             f"{loss_r}")
    if launches.get("wkv6_bwd", 0) != cfg.n_layers or launches.get(
            "wkv6", 0) < cfg.n_layers:
        raise AssertionError(f"rwkv train step launches {launches}: want "
                             f"{cfg.n_layers} wkv6_bwd, >= {cfg.n_layers} "
                             "wkv6")
    release(torch)

    # 2. phase 12's per-parameter check at full width on the first
    # RWKV_CHECK_LAYERS layers in float32, where the gradients hold
    cfg32 = cfg.replace(n_layers=RWKV_CHECK_LAYERS, param_dtype="float32",
                        compute_dtype="float32")
    m32 = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(5),
                         dev)

    def dropped_state(r, k, v, w, u, state):
        ys = [wkv6_plain(r[:, t0:t0 + seg], k[:, t0:t0 + seg],
                         v[:, t0:t0 + seg], w[:, t0:t0 + seg], u,
                         torch.zeros_like(state))[0]
              for t0 in range(0, r.shape[1], seg)]
        return torch.cat(ys, 1), state

    def control_loss(m, b):
        # layer 0's WKV restarts from a zero state every 256 tokens (run
        # whole, so its patched WKV is not recomputed); the others as the
        # plain path, one checkpoint a layer
        x = embed(m.embed, cfg32, tokens)
        for layer, blk in enumerate(m.blocks):
            if layer == 0:
                with plain_wkv(dropped_state):
                    x, _ = lm._train_group([blk], cfg32, x, "ref")
            else:
                x, _ = checkpoint(lm._train_group, [blk], cfg32, x, "ref",
                                  use_reentrant=False)
        x = rms_norm(m.final_norm, x, cfg32.rmsnorm_eps)
        return shifted_xent(unembed(m.embed, cfg32, x), tokens)

    build.reset_launch_counts()
    loss_k, g_k = train_step_grads(torch, m32, batch, path(cfg32, "kernel"))
    _sync(torch, dev)
    launches32 = build.launch_counts()
    loss_r, g_r = train_step_grads(torch, m32, batch, path(cfg32, "ref"))
    loss_c, g_c = train_step_grads(torch, m32, batch, control_loss)
    _sync(torch, dev)
    label32 = (f"rwkv6-3b train step, float32, the first "
               f"{RWKV_CHECK_LAYERS} layers ({cfg32.param_count():,} "
               f"parameters)")
    print(f"{label32}: launches {json.dumps(launches32, sort_keys=True)}; "
          f"control: layer 0's state dropped every {seg} tokens")
    check_step_grads(label32, loss_k, g_k, loss_r, g_r, loss_c, g_c)
    del m32, g_k, g_r, g_c
    if launches32.get("wkv6_bwd", 0) != RWKV_CHECK_LAYERS:
        raise AssertionError(f"rwkv float32 train step launches "
                             f"{launches32}")
    return launches


def train_model_flop(cfg, batch, seq):
    """(model FLOP of one train step, active parameters): 6 x the active
    parameters (a MoE layer's top-k routed experts of its n, the shared
    ones) x the tokens, plus the attention's FLOP forward and backward
    (``flash_work`` for GQA; MLA with its q.k and v widths). The RWKV and
    Mamba recurrences' own FLOP are not counted."""
    tokens = batch * seq
    active = cfg.param_count()
    if cfg.encdec is not None:
        return encdec_model_flop(cfg, batch, seq)
    if cfg.moe is not None:
        m = cfg.moe
        glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
        per = glu * cfg.d_model * (m.d_ff_expert or cfg.d_ff)
        active -= sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) \
            * (m.n_experts - m.top_k) * per
    from repro_torch.models import lm
    attn = 0
    for i in range(cfg.n_layers):
        kind = lm.mixer_kind(cfg, i % lm.group_size(cfg))
        if kind == "attn":
            f, _, b, _ = flash_work((batch, seq, seq, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.resolved_head_dim,
                                     True, 0), 2)
            attn += f + b
        elif kind == "mla":
            ml = cfg.mla
            pairs = seq * (seq + 1) // 2
            f = 2 * batch * cfg.n_heads * pairs * (
                ml.qk_nope_head_dim + ml.qk_rope_head_dim + ml.v_head_dim)
            attn += f + 2.5 * f
    return 6 * active * tokens + attn, active


def encdec_flop_parts(cfg, batch, seq):
    """An encoder-decoder train step's model FLOP in parts: 6 x the
    encoder's parameters x its frames (``encoder``), 6 x the rest (the
    reference's formula less the encoder's part) x the decoder tokens
    (``decoder``), and the attention's FLOP forward and backward: the
    encoder's bidirectional, the decoder's causal and the
    cross-attention's (``attention``); with the parameter counts."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, K, E = cfg.n_heads, cfg.n_kv_heads, cfg.encdec.n_encoder_layers
    Te = cfg.encdec.encoder_seq_len
    glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
    enc = E * (4 * d * H * hd + glu * d * f + 2 * d)
    dec = cfg.param_count() - E * (4 * d * H * hd + 3 * d * f + 2 * d)
    attn = 0
    for n, sq, sk, causal in ((E, Te, Te, False), (cfg.n_layers, seq, seq,
                                                   True),
                              (cfg.n_layers, seq, Te, False)):
        fw, _, bw, _ = flash_work((batch, sq, sk, H, K, hd, causal, 0), 2)
        attn += n * (fw + bw)
    return dict(encoder=6 * enc * batch * Te, decoder=6 * dec * batch * seq,
                attention=attn, encoder_params=enc, decoder_params=dec)


def encdec_model_flop(cfg, batch, seq):
    """``train_model_flop`` of an encoder-decoder: the sum of
    ``encdec_flop_parts``, and the parameters."""
    p = encdec_flop_parts(cfg, batch, seq)
    return (p["encoder"] + p["decoder"] + p["attention"],
            p["encoder_params"] + p["decoder_params"])


def moe_drop_shares(torch, cfg, model, batch, shard_axes=None):
    """Per MoE layer, the share of (token, k) assignments the capacity
    dispatch drops on ``batch`` (one forward under ``no_grad``; with
    ``shard_axes`` the partitioned forward of a world of one, whose rank
    routes every row)."""
    from repro_torch.layers import moe as moe_mod
    from repro_torch.models import lm
    shares = []
    inner = lm.moe_apply

    def counted(p, c, h, **kw):
        if not kw.get("dropless", True):
            xt = h.reshape(-1, h.shape[-1])
            _, idx, _ = moe_mod.route(p, c, xt)
            _, keep = moe_mod.capacity_slots(
                idx, c.moe.n_experts, moe_mod.moe_capacity(c, xt.shape[0]))
            shares.append(1.0 - keep.float().mean().item())
        return inner(p, c, h, **kw)
    lm.moe_apply = counted
    try:
        with torch.no_grad():
            lm.forward(model, cfg, batch["tokens"],
                       prefix_embeds=batch.get("prefix_embeds"),
                       shard_axes=shard_axes)
    finally:
        lm.moe_apply = inner
    return shares


def phase_deepseek_train(torch, np, dev):
    """deepseek-v2-lite-16b at ``DEEPSEEK_TRAIN_LAYERS`` layers (module
    docstring, phase 65): the train step's check at batch 4 x 2048 (C 960
    for 8,192 tokens, 64 experts, top 6), the drop share per layer, then a
    5-step run profiled with the MoE inside its range. Returns the run's
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.layers.moe import moe_capacity
    from repro_torch.models import api, lm
    from repro_torch.models.losses import shifted_xent
    from repro_torch.training.data import DataConfig, make_batch
    cfg = get_config("deepseek-v2-lite-16b").replace(
        n_layers=DEEPSEEK_TRAIN_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(8)
    model = lm.init_params(cfg, gen, dev)
    batch = make_batch(DataConfig(seed=0, batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ), cfg, 0)
    batch = {k: v.to(dev) for k, v in batch.items()}
    C = moe_capacity(cfg, TRAIN_BATCH * TRAIN_SEQ)
    shares = moe_drop_shares(torch, cfg, model, batch)
    print(f"deepseek-v2-lite-16b train ({cfg.n_layers} layers, "
          f"{cfg.param_count():,} parameters, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}): capacity {C} of {TRAIN_BATCH * TRAIN_SEQ} tokens x "
          f"top {cfg.moe.top_k} over {cfg.moe.n_experts} experts; dropped "
          f"assignments per layer {[round(s, 4) for s in shares]}")
    ctrl = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               top_k=cfg.moe.top_k - 1))

    def control_loss(m, b):
        # layer 0's MoE routes to top-(k-1)
        x = embed(m.embed, cfg, b["tokens"])
        aux = 0.0
        for layer, blk in enumerate(m.blocks):
            x, a = lm._train_group([blk], ctrl if layer == 0 else cfg, x,
                                   "ref")
            aux = aux + a
        x = rms_norm(m.final_norm, x, cfg.rmsnorm_eps)
        return shifted_xent(unembed(m.embed, cfg, x), b["tokens"]) \
            + cfg.moe.aux_loss_coef * aux / max(
                cfg.n_layers // cfg.moe.moe_every, 1)

    losses = {}
    for name, fn in (("kernel", lambda m, b: api.loss_fn(m, cfg, b,
                                                         impl="kernel")),
                     ("ref", lambda m, b: api.loss_fn(m, cfg, b,
                                                      impl="ref")),
                     ("control", control_loss)):
        losses[name] = train_step_grads(torch, model, batch, fn)
        _sync(torch, dev)
    check_step_grads("deepseek-v2-lite-16b train step", *losses["kernel"],
                     *losses["ref"], *losses["control"])
    del model, losses
    release(torch)
    return phase_train_run(torch, np, cfg, dev, steps=SHORT_RUN_STEPS,
                           label="deepseek-v2-lite-16b train", seed=9,
                           ranges=True)


@contextlib.contextmanager
def forced_route(torch, moe_mod, expert_idx):
    """Within the block ``moe.route`` keeps its softmax, renormalised gates
    and aux loss but takes the experts ``expert_idx`` (N, K) instead of
    its own top-k."""
    inner = moe_mod.route

    def route(p, cfg, xt):
        m = cfg.moe
        probs = torch.softmax(xt.float() @ p.router.w.float(), dim=-1)
        gates = probs.gather(1, expert_idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        ce = moe_mod.expert_counts(expert_idx, m.n_experts).float() / (
            xt.shape[0] * m.top_k)
        return (gates, expert_idx,
                m.n_experts * torch.sum(probs.mean(dim=0) * ce))
    moe_mod.route = route
    try:
        yield
    finally:
        moe_mod.route = inner


def phase_jamba_train_layers(torch, np, dev):
    """jamba-v0.1-52b's three kinds of sub-layer at full width, forward and
    backward at batch 1 x ``JAMBA_TRAIN_SEQ`` in bf16 against a float32
    copy (module docstring, phase 66). Returns the attention sub-layer's
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.layers import attention as attn
    from repro_torch.layers import mamba as mamba_mod
    from repro_torch.layers.core import RMSNorm, linear, rms_norm
    from repro_torch.layers import moe as moe_mod
    from repro_torch.layers.moe import MoE, moe_apply
    cfg = get_config("jamba-v0.1-52b")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    ctrl32 = cfg32.replace(moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.top_k - 1))
    gen = torch.Generator(device=dev).manual_seed(10)
    d, eps = cfg.d_model, cfg.rmsnorm_eps
    x = torch.randn((1, JAMBA_TRAIN_SEQ, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    up = torch.randn((1, JAMBA_TRAIN_SEQ, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    di = mamba_mod._dims(cfg)[0]

    def mamba_h(mix, c, h, control=False):
        # (the control's copy has its last sixteenth of inner channels
        # dropped at out_proj)
        st = mamba_mod.init_mamba_state(c, h.shape[0], h.dtype, h.device)
        return mamba_mod.mamba_forward(mix, c, h, st)[0]

    def attn_h(mix, c, h, control=False):
        if not control:
            return attn.attention_full(
                mix, c, h, impl="kernel" if h.dtype == torch.bfloat16
                else "ref")
        B, T, _ = h.shape
        pos = torch.arange(T, device=h.device)[None, :]
        q, k, v = attn._project_qkv(mix, c, h, pos)
        ctx = flash_control(torch, q, k, v, True, 0)
        return linear(mix.wo, ctx.reshape(B, T, -1))

    routed = {}

    def moe_h(mix, c, h, control=False):
        # the float32 copy takes the bf16 run's experts: capacity dispatch
        # keeps the first C assignments of each expert in token order, so
        # one near-tie routed otherwise moves every later slot of two
        # experts; the experts' arithmetic is what is held here (the
        # routing's own agreement is printed)
        if control:
            return moe_apply(mix, ctrl32, h, dropless=False)[0]
        which = "bf16" if h.dtype == torch.bfloat16 else "f32"
        with torch.no_grad():
            routed[which] = moe_mod.route(mix, c, h.reshape(-1, d))[1]
        if which == "bf16":
            return moe_apply(mix, c, h, dropless=False)[0]
        with forced_route(torch, moe_mod, routed["bf16"]):
            return moe_apply(mix, c, h, dropless=False)[0]

    kinds = (("mamba", lambda: mamba_mod.Mamba(cfg, dev, gen), mamba_h),
             ("attention", lambda: attn.Attention(cfg, dev, gen), attn_h),
             ("moe", lambda: MoE(cfg, dev, gen), moe_h))
    launches = {}
    for kind, make, fn in kinds:
        t = time.perf_counter()
        mods = {"bf16": torch.nn.ModuleDict(
            {"norm": RMSNorm(d, cfg.dtype(), dev), "mix": make()})}
        mods["f32"] = copy.deepcopy(mods["bf16"]).float()
        mods["control"] = mods["f32"]
        if kind == "mamba":
            mods["control"] = copy.deepcopy(mods["f32"])
            with torch.no_grad():
                mods["control"]["mix"].out_proj.w[di - di // 16:] = 0

        def run(which, c, xin, control=False):
            m = mods[which]
            params = dict(m.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            leaf = xin.detach().requires_grad_()
            h = fn(m["mix"], c, rms_norm(m["norm"], leaf, eps), control)
            grads = torch.autograd.grad(leaf + h, [leaf, *params.values()],
                                        up.to(xin.dtype))
            return h.detach(), dict(zip(["x", *params], grads))

        build.reset_launch_counts()
        h_b, g_b = run("bf16", cfg, x)
        _sync(torch, dev)
        launches[kind] = build.launch_counts()
        h_f, g_f = run("f32", cfg32, x.float())
        real = torch.ones(JAMBA_TRAIN_SEQ, dtype=torch.bool, device=dev)
        out_rel = rel_per_token(torch, h_b[0], h_f[0], real)
        g_rel = grad_rel(g_b, g_f)
        del g_b
        h_c, g_c = run("control", cfg32, x.float(), control=True)
        c_rel = rel_per_token(torch, h_c[0], h_f[0], real)
        gc_rel = grad_rel(g_c, g_f)
        del g_c, g_f
        worst = max(g_rel, key=g_rel.get)
        if kind == "moe":
            same = (routed["f32"].sort(-1).values
                    == routed["bf16"].sort(-1).values).all(-1)
            print(f"jamba moe sub-layer: the float32 copy's own top-"
                  f"{cfg.moe.top_k} experts differ from the bf16 run's on "
                  f"{1 - same.float().mean().item():.4f} of the tokens; "
                  f"the float32 copy is run on the bf16 run's experts")
        print(f"jamba {kind} sub-layer train (batch 1 x {JAMBA_TRAIN_SEQ}, "
              f"bf16 vs a float32 copy): output per token {out_rel:.4g} "
              f"(limit {LAYER_REL_LIMIT}), control {c_rel:.4g}; gradients "
              f"worst {g_rel[worst]:.4g} ({worst}; limit {GRAD_REL_LIMIT}), "
              f"control worst {max(gc_rel.values()):.4g}; launches "
              f"{json.dumps(launches[kind], sort_keys=True)}; "
              f"{time.perf_counter() - t:.1f} s")
        if not (out_rel <= LAYER_REL_LIMIT < c_rel
                and g_rel[worst] <= GRAD_REL_LIMIT < max(gc_rel.values())):
            raise AssertionError(
                f"jamba {kind} sub-layer train: output {out_rel} (control "
                f"{c_rel}), gradients {g_rel[worst]} (control "
                f"{max(gc_rel.values())})")
        del mods, h_f, h_b, h_c
        release(torch)
    if not (launches["attention"].get("flash_attention", 0) > 0
            and launches["attention"].get("flash_attention_bwd", 0) > 0):
        raise AssertionError(f"jamba attention sub-layer launches "
                             f"{launches['attention']}")
    return launches["attention"]


# -- the dense KV-cache path: gemma3-12b and aqua-mistral-7b (phases 68-71)
# (B, Sq, Sk, H, K, hd, causal, window): row 9 at the prefill shapes of
# phases 69-70, gemma3's local and global layers and mistral's
DENSE_FLASH = {"gemma3-12b local": (2, 3000, 3000, 16, 8, 256, True, 1024),
               "gemma3-12b global": (2, 3000, 3000, 16, 8, 256, True, 0),
               "aqua-mistral-7b": (1, 4608, 4608, 32, 8, 128, True, 4096)}
# arch -> (seed, param_count(), batch, seq, prompt, decode steps, the
# cache's bytes, a cache of seq slots on every layer); prompts past the
# window, so the local rings roll
DENSE_RUNS = {"gemma3-12b": (69, 11_765_391_360, 2, 4096, 3000, 64,
                             1_207_959_552, 3_221_225_472),
              "aqua-mistral-7b": (70, 7_241_728_000, 1, 8192, 4608, 64,
                                  536_870_912, 1_073_741_824)}
# phase 71 in float32: the layers of one gemma3 group (5 local, 1 global)
# and 4 of mistral's, a prompt past the window, then decode steps
GATE_RUNS = {"gemma3-12b": (6, 1100, 16), "aqua-mistral-7b": (4, 4200, 8)}
# decode vs forward logits in float32, distance over the row's norm: the
# two orders of one float32 computation (the flash kernel over the prompt,
# the einsum over the ring) differ by ~1e-6 at these widths
GATE_REL = 1e-4


def phase_dense_flash(torch, report):
    """Row 9 at the dense cache path's prefill shapes, bf16 (phase 68):
    against its plain version within FLASH_TOL with the diagonal-masked
    control beyond, two launches bit-identical, device times (plain,
    kernel, kernel, plain) beside the library attention under the same
    mask and the bound. Adds ``dense_cache`` records to the
    ``flash_attention`` entry."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    g = torch.Generator(device="cuda").manual_seed(68)
    tol = FLASH_TOL["bfloat16"]
    recs = {}
    for label, shape in DENSE_FLASH.items():
        causal, window = shape[6], shape[7]
        kw = dict(causal=causal, window=window)
        q, k, v = flash_inputs(torch, g, shape, torch.bfloat16)[:3]
        o = fa_ops.flash_attention_fwd(q, k, v, **kw)[0]
        same = torch.equal(o, fa_ops.flash_attention_fwd(q, k, v, **kw)[0])
        want = fa_ref.flash_attention_ref(q, k, v, **kw)
        err = (o.float() - want.float()).abs().max().item()
        del o
        ctrl = flash_control(torch, q, k, v, causal, window)
        c_err = (ctrl.float() - want.float()).abs().max().item()
        del want, ctrl
        if not (same and err <= tol < c_err):
            raise AssertionError(f"flash attention at {label} {shape}: "
                                 f"error {err} (control {c_err}, limit "
                                 f"{tol}), bit-identical {same}")
        ms, plain = interleaved(
            lambda: fa_ref.flash_attention_ref(q, k, v, **kw),
            lambda: fa_ops.flash_attention_fwd(q, k, v, **kw), 10,
            plain_iters=3)
        lib = library_attention_ms(torch, q, k, v, None, 10,
                                   window=window)[0]
        flop, nbytes, _, _ = flash_work(shape, 2)
        bound, by = bound_ms(nbytes, flop)
        pairs = flop // (4 * shape[0] * shape[3] * shape[5])
        name = (f"B={shape[0]} T={shape[1]} H={shape[3]} K={shape[4]} "
                f"hd={shape[5]} window={window} bfloat16")
        recs[label] = dict(shape=name, max_abs_err=err, control=c_err,
                           tolerance=tol, bit_identical=same, ms=ms,
                           plain_ms=plain, bound_ms=bound, bound_by=by,
                           library_ms=lib, causal_pairs=pairs * shape[0])
        print(f"flash {label} {name}: err {err:.3g} (limit {tol}, control "
              f"{c_err:.3g}), two launches bit-identical {same}; kernel "
              f"{ms:.4f} ms plain {plain:.4f} bound {bound:.4f} ({by}; "
              f"{pairs * shape[0]:,} causal pairs in the window) library "
              f"{lib:.4f}; {flop / (ms * 1e9):.1f} TFLOP/s")
        del q, k, v
    next(k for k in report if k["name"] == "flash_attention")[
        "dense_cache"] = recs


def cache_bytes(cache):
    return sum(t.numel() * t.element_size() for c in cache.values()
               for t in c)


def ring_positions(T, slots):
    """The position each of a ring's slots holds after a T-token prefill:
    the last p < T with p % slots == j."""
    return [T - 1 - ((T - 1 - j) % slots) for j in range(slots)]


def profile_call(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activities): -> (its result, {its wall, the device kernels launched,
    device busy ms, idle share, device ms by kind, top-5 kernels}), the
    device numbers "not measured" where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    device = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.time_range.elapsed_us() > 0]
    if not device:
        return out, {"wall_ms": wall_us / 1e3, "device": "not measured"}
    summary = device_time_summary(device, wall_us)
    return out, {
        "wall_ms": summary["step_wall_ms"],
        "kernels": sum(1 for name, _, _ in device
                       if not name.startswith(("Memcpy", "Memset"))),
        "device_busy_ms": summary["device_busy_ms"],
        "idle_share": summary["idle_share"],
        "by_kind_ms": summary["by_kind_ms"],
        "top5_ms": summary["top10_ms"][:5]}


def dense_layer_check(torch, cfg, model, dev, tokens, check_token, seq):
    """The main path's prefill of ``tokens`` (B,T) and one decode step of
    ``check_token`` (B,) at position T, driven layer by layer with the
    functions ``lm.prefill`` and ``lm.decode_step`` call, on a cache of
    its own: at each layer, on the same input (and, decoding, the same
    cache in float32), the attention and the MLP against a float32 copy of
    the layer, per token relative to the copy's largest output; each local
    ring holds the K/V of the positions ``ring_positions`` names, exactly.
    Controls: layer 0's float32 copy attending with no window on the
    prefill (beyond LAYER_REL_LIMIT on a local layer). Returns (the
    prefill's last logits, the decode step's, {check: per-layer list},
    the control)."""
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, mlp, rms_norm, unembed
    from repro_torch.models import api, lm
    B, T = tokens.shape
    eps = cfg.rmsnorm_eps
    gs = lm.group_size(cfg)
    cache = api.init_decode_state(cfg, B, seq, device=dev)
    pos = torch.full((B,), T, dtype=torch.long, device=dev)
    x = embed(model.embed, cfg, tokens)
    xd = embed(model.embed, cfg, check_token[:, None])
    rel = {"prefill attention": [], "prefill mlp": [],
           "decode attention": [], "decode mlp": []}
    control, rings = None, 0
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, gs)
        w = lm.layer_window(cfg, i)
        c = lm._at(cache[f"sub{i}"], g)
        mix32 = copy.deepcopy(blk.mix).float()
        ffn32 = copy.deepcopy(blk.ffn).float()
        h = rms_norm(blk.n1, x, eps)
        out, (k, v) = attn.attention_full(blk.mix, cfg, h, window=w,
                                          return_kv=True)
        attn.fill_kv_cache(c, k, v, w)
        want = attn.attention_full(mix32, cfg, h.float(), window=w)
        rel["prefill attention"].append(rel_per_token(torch, out, want, ...))
        if w and T > c.k.shape[1]:
            held = ring_positions(T, c.k.shape[1])
            if layer == 0:
                k = attn.attention_full(blk.mix, cfg, h, window=w,
                                        return_kv=True)[1][0]
                control = rel_per_token(torch, out, attn.attention_full(
                    mix32, cfg, h.float(), window=0), ...)
            if not torch.equal(c.k, k[:, held]):
                raise AssertionError(f"{cfg.name} layer {layer}: a ring slot "
                                     "does not hold its position's K")
            rings += 1
        del k, v, want
        x = x + out
        h = rms_norm(blk.n2, x, eps)
        f = mlp(blk.ffn, cfg, h)
        rel["prefill mlp"].append(rel_per_token(torch, f, mlp(
            ffn32, cfg, h.float()), ...))
        x = x + f
        c32 = attn.KVCache(c.k.float(), c.v.float())
        h = rms_norm(blk.n1, xd, eps)
        out = attn.attention_decode(blk.mix, cfg, h, c, pos, window=w)[0]
        want = attn.attention_decode(mix32, cfg, h.float(), c32, pos,
                                     window=w)[0]
        rel["decode attention"].append(rel_per_token(torch, out, want, ...))
        xd = xd + out
        h = rms_norm(blk.n2, xd, eps)
        f = mlp(blk.ffn, cfg, h)
        rel["decode mlp"].append(rel_per_token(torch, f, mlp(
            ffn32, cfg, h.float()), ...))
        xd = xd + f
        del mix32, ffn32, c32, out, want, f, h
    x = rms_norm(model.final_norm, x, eps)
    prefill_logits = unembed(model.embed, cfg, x[:, -1])
    xd = rms_norm(model.final_norm, xd, eps)
    decode_logits = unembed(model.embed, cfg, xd[:, 0])
    print(f"{cfg.name} layer check: {rings} local rings hold positions "
          f"T - 1 - ((T - 1 - j) mod slots) exactly (T {T})")
    return prefill_logits, decode_logits, rel, control


def phase_dense_run(torch, np, cfg, model, dev, run):
    """Phases 69-70 on a built model: the cache from
    ``api.init_decode_state`` (each sub-layer's slots, its bytes against
    ``run``'s and a full cache's), ``dense_layer_check``, then the main
    path: ``api.prefill`` of seeded prompts past the window and
    ``api.decode_step`` for ``run``'s steps (greedy after a seeded first
    token), launch counts reset just before each and read just after. The
    prefill's logits and the first step's equal the layer check's bit for
    bit. Returns {path: launch counts}."""
    from repro_torch.kernels import build
    from repro_torch.models import api
    _, _, B, seq, T, steps, want_bytes, full_bytes = run
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = api.init_decode_state(cfg, B, seq, device=dev)
    slots = {sub: c.k.shape[2] for sub, c in cache.items()}
    nbytes = cache_bytes(cache)
    itemsize = cache["sub0"].k.element_size()
    full = 2 * cfg.n_layers * B * seq * K * hd * itemsize
    print(f"{cfg.name} cache: B {B}, seq {seq}, slots by sub-layer {slots}; "
          f"{nbytes:,} B against {full:,} B for {seq} slots on every layer")
    if (nbytes, full) != (want_bytes, full_bytes):
        raise AssertionError(f"{cfg.name} cache: {nbytes} / {full} B, not "
                             f"{want_bytes} / {full_bytes}")
    g = torch.Generator(device=dev).manual_seed(seq + T)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                           device=dev)
    first = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev)
    t = time.perf_counter()
    lp, ld, rel, control = dense_layer_check(torch, cfg, model, dev, tokens,
                                             first, seq)
    worst = {name: max(v) for name, v in rel.items()}
    print(f"{cfg.name} layer check ({time.perf_counter() - t:.1f} s): worst "
          f"per-token distance to the float32 copies {json.dumps(worst)} "
          f"(limit {LAYER_REL_LIMIT}); control (layer 0, no window) "
          f"{control:.4g}")
    if max(worst.values()) > LAYER_REL_LIMIT or not control > \
            LAYER_REL_LIMIT:
        raise AssertionError(f"{cfg.name} layer check: {worst}, control "
                             f"{control}")
    paths = {}
    _sync(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t = time.perf_counter()
    logits, cache = api.prefill(model, cfg, tokens, cache)
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t
    paths[f"{cfg.name} prefill"] = build.launch_counts()
    build.reset_launch_counts()
    walls, tok, step_logits = [], first, None
    for s in range(steps):
        t = time.perf_counter()
        out, cache = api.decode_step(model, cfg, cache, tok,
                                     np.full(B, T + s))
        _sync(torch, dev)
        walls.append(time.perf_counter() - t)
        if s == 0:
            step_logits = out
        tok = out.argmax(-1)
    paths[f"{cfg.name} decode"] = build.launch_counts()
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(out).all())
    same = torch.equal(logits, lp) and torch.equal(step_logits, ld)
    flash = paths[f"{cfg.name} prefill"].get("flash_attention", 0)
    print(f"{cfg.name} main path: prefill of {B} x {T} tokens "
          f"{prefill_s * 1e3:.1f} ms ({B * T / prefill_s:,.0f} tokens/s), "
          f"{flash} flash_attention launches; {steps} decode steps p50 "
          f"{np.percentile(walls, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(walls, 99) * 1e3:.2f} ms ("
          f"{B * steps / sum(walls):,.1f} tokens/s), launches "
          f"{paths[f'{cfg.name} decode']}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; logits "
          f"finite {finite}, equal to the layer check's {same}")
    if not (finite and same and flash == cfg.n_layers):
        raise AssertionError(f"{cfg.name} main path: finite {finite}, equal "
                             f"to the layer check {same}, {flash} flash "
                             f"launches for {cfg.n_layers} layers")
    # one more decode step and a prefill into a fresh cache, profiled
    # (not counted): where the device time goes, and how idle it is
    _, dec_prof = profile_call(torch, lambda: api.decode_step(
        model, cfg, cache, tok, np.full(B, T + steps)))
    fresh = api.init_decode_state(cfg, B, seq, device=dev)
    _, pre_prof = profile_call(torch, lambda: api.prefill(model, cfg, tokens,
                                                          fresh))
    del fresh
    print(f"{cfg.name} profiled decode step: {json.dumps(dec_prof)}")
    print(f"{cfg.name} profiled prefill: {json.dumps(pre_prof)}")
    return paths


def phase_dense_gate(torch, np, cfg, dev, prompt, steps, seed):
    """Phase 71, the reference's gate (``test_arch_smoke.py:52``) on the
    card: ``cfg`` (full width, cut in depth, float32) with seeded weights;
    a prompt past the window prefilled, then ``steps`` decode steps, each
    step's logits (and the prefill's) against the training forward's at
    the same position within GATE_REL of the row's norm; a control
    decoding its first step at pos + 1 beyond. Returns the forward's and
    the prefill's launch counts."""
    from repro_torch.kernels import build
    from repro_torch.models import api, lm
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    T = prompt + steps
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                           device=dev)
    build.reset_launch_counts()
    with torch.no_grad():
        full = api.forward(model, cfg, tokens)[0][0]
    cache = api.init_decode_state(cfg, 1, T, device=dev)
    lg, cache = api.prefill(model, cfg, tokens[:, :prompt], cache)
    counts = build.launch_counts()

    def rel(got, p):
        return ((got[0] - full[p]).norm() / full[p].norm()).item()
    errs = [rel(lg, prompt - 1)]
    ctrl_cache = {k: type(c)(*(t.clone() for t in c))
                  for k, c in cache.items()}
    ctrl = rel(api.decode_step(model, cfg, ctrl_cache, tokens[:, prompt],
                               prompt + 1)[0], prompt)
    del ctrl_cache
    for p in range(prompt, T):
        lg, cache = api.decode_step(model, cfg, cache, tokens[:, p], p)
        errs.append(rel(lg, p))
    slots = {sub: c.k.shape[2] for sub, c in cache.items()}
    print(f"{cfg.name} float32 gate ({cfg.n_layers} layers, slots "
          f"{slots}): prefill of {prompt} then {steps} decode steps, worst "
          f"distance to the forward {max(errs):.3g} of the row's norm "
          f"(limit {GATE_REL}); control at pos + 1 {ctrl:.3g}")
    if not max(errs) <= GATE_REL < ctrl:
        raise AssertionError(f"{cfg.name} float32 gate: {errs}, control "
                             f"{ctrl}")
    del model, cache, full
    return counts


def dense_cache_phases(torch, np, report, dev, t0):
    """Phases 68-71 (``dense KV-cache path`` prints their spans). Returns
    {path: launch counts}."""
    from repro_torch.configs import get_config
    lap, done = model_laps(torch, "dense KV-cache path", t0)
    phase_dense_flash(torch, report)
    lap("row 9 at the prefill shapes")
    paths = {}
    for arch, run in DENSE_RUNS.items():
        cfg = get_config(arch)
        extra = 2 * cfg.n_layers * cfg.resolved_head_dim \
            if cfg.use_qk_norm else 0
        model = phase_dense_model(torch, cfg, run[0], run[1], extra)
        lap(f"{arch} model")
        paths.update(phase_dense_run(torch, np, cfg, model, dev, run))
        lap(f"{arch} check, prefill and decode")
        del model
        release(torch)
    for arch, (layers, prompt, steps) in GATE_RUNS.items():
        cfg = get_config(arch).replace(n_layers=layers,
                                       param_dtype="float32",
                                       compute_dtype="float32")
        paths[f"{arch} float32 gate"] = phase_dense_gate(
            torch, np, cfg, dev, prompt, steps, 71)
        release(torch)
        lap(f"{arch} float32 gate")
    done()
    return paths


# -- the link legs, the paper's figures on the simulator, the placer -------
LINK_PAGES = 2048                   # each pool: 671,088,640 B of kv pages
LINK_SIZES = tuple(2 ** k for k in range(12))    # 1 .. 2,048 pages
LINK_REPEATS = 5                    # timed round trips a size after a warm one
LINK_LEGS = {"host out": (("gather_pages", 1), ("scatter_pages", 0)),
             "host in": (("gather_pages", 0), ("scatter_pages", 1)),
             "slab out": (("gather_pages", 1), ("scatter_pages", 1)),
             "slab in": (("gather_pages", 1), ("scatter_pages", 1))}
SLAB_LINK = "same-card slab, not NVLink"


def wall_s(torch, fn):
    """One call of ``fn`` wall to wall, ``torch.cuda.synchronize()`` on both
    sides: a tier move is host work and device work."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def link_move(torch, aq, leg, lps):
    """One timed tier move of ``lps`` through the runtime's own moves,
    with its meter and launch-count deltas: ``host out`` offloads to HOST,
    ``slab out`` to the REMOTE slab, ``* in`` is ``ensure_local``."""
    from repro_torch.core.aqua_tensor import HOST, REMOTE
    from repro_torch.kernels import build
    meter = aq.meter
    keys = ("bytes_fabric", "bytes_host", "messages_fabric", "messages_host")
    before = [getattr(meter, k) for k in keys]
    c0 = build.launch_counts()
    if leg.endswith("out"):
        prefer = HOST if leg.startswith("host") else REMOTE
        secs = wall_s(torch, lambda: aq.offload(lps, prefer=prefer))
    else:
        secs = wall_s(torch, lambda: aq.ensure_local(lps))
    c1 = build.launch_counts()
    launched = {k: c1.get(k, 0) - c0.get(k, 0)
                for k in ("gather_pages", "scatter_pages")}
    return secs, {k: getattr(meter, k) - b
                  for k, b in zip(keys, before)}, launched


def check_link_move(leg, n, page_bytes, moved, launched):
    """The bookkeeping of one move: its bytes are ``n`` whole pages on the
    leg's link, in one message, through one gather and/or one scatter."""
    link = "host" if leg.startswith("host") else "fabric"
    other = "fabric" if link == "host" else "host"
    want = {f"bytes_{link}": float(n * page_bytes), f"messages_{link}": 1,
            f"bytes_{other}": 0.0, f"messages_{other}": 0}
    if moved != want:
        raise AssertionError(f"link legs: {leg} of {n} pages metered "
                             f"{moved}, not {want}")
    if launched != dict(LINK_LEGS[leg]):
        raise AssertionError(f"link legs: {leg} of {n} pages launched "
                             f"{launched}, not {dict(LINK_LEGS[leg])}")


def phase_link_legs(torch, np, dev, card):
    """Phase 72: the HOST leg and the same-card REMOTE slab leg measured
    through ``AquaTensor``'s own moves at aqua-llama2-13b's kv pages
    (2, 40, 16, 128) bf16 = 327,680 B, on a runtime whose LOCAL pool,
    REMOTE slab and pinned host pool each hold 2,048 pages. At each of 1,
    2, 4, ..., 2,048 pages: one warm round trip, then ``LINK_REPEATS``
    timed ones (median), each move wall to wall; every round trip
    bit-identical and each move metered as its pages' bytes in one
    message. Beside them a pinned ``copy_`` of the same bytes each way
    (the PCIe ceiling) and, for the slab, the HBM bound 2 x bytes / 3.35
    TB/s. The pooled host samples (both directions) are fitted with
    ``fit_link_model`` into ``calibrate_profile(H100_SXM, host_samples=)``;
    the slab samples are fitted too and reported as a same-card slab, not
    NVLink (never fed to the profile's fabric).
    Returns (the calibrated profile, launch counts, a record)."""
    from repro_torch.configs import get_config
    from repro_torch.core.aqua_tensor import AquaTensor, TransferMeter
    from repro_torch.core.perfmodel import (H100_SXM, calibrate_profile,
                                            fit_link_model)
    from repro_torch.kernels import build
    cfg = get_config("aqua-llama2-13b")
    shape = (2, cfg.n_kv_heads, 16, cfg.resolved_head_dim)
    dtype = cfg.torch_compute_dtype()
    aq = AquaTensor(n_logical=LINK_PAGES, page_shape=shape,
                    local_slots=LINK_PAGES, host_slots=LINK_PAGES,
                    dtype=dtype, meter=TransferMeter(hw=H100_SXM),
                    device=dev, name="kv")
    aq.add_remote_lease("slab0", LINK_PAGES)
    page_bytes = aq.page_bytes
    if page_bytes != 327_680 or \
            aq.host_pool.is_pinned() != (dev.type == "cuda"):
        raise AssertionError(f"link legs: pages of {page_bytes} B, pinned "
                             f"host pool {aq.host_pool.is_pinned()}")
    lps = aq.allocate(LINK_PAGES)
    g = torch.Generator(device=dev).manual_seed(72)
    data = torch.randn((LINK_PAGES,) + shape, generator=g, device=dev,
                       dtype=torch.float32).to(dtype)
    aq.write_local(lps, data)
    dev_buf = torch.empty_like(data)
    pinned = torch.empty(data.shape, dtype=dtype,
                         pin_memory=dev.type == "cuda")
    launches = {"gather_pages": 0, "scatter_pages": 0}
    build.reset_launch_counts()
    rows, samples = [], {"host": [], "slab": []}
    for n in LINK_SIZES:
        sel = lps[:n]
        nbytes = n * page_bytes
        secs = {leg: [] for leg in LINK_LEGS}
        for rep in range(LINK_REPEATS + 1):
            for out, back in (("host out", "host in"),
                              ("slab out", "slab in")):
                for leg in (out, back):
                    t, moved, launched = link_move(torch, aq, leg, sel)
                    check_link_move(leg, n, page_bytes, moved, launched)
                    for k in launches:
                        launches[k] += launched[k]
                    if rep:
                        secs[leg].append(t)
                if aq.tier_counts()["local"] != LINK_PAGES or not \
                        torch.equal(aq.read(sel), data[:n]):
                    raise AssertionError(f"link legs: {out}/{back} round "
                                         f"trip of {n} pages not "
                                         f"bit-identical")
        ceil = {"d2h": [], "h2d": []}
        for rep in range(LINK_REPEATS + 1):
            d2h = wall_s(torch, lambda: pinned[:n].copy_(dev_buf[:n],
                                                         non_blocking=True))
            h2d = wall_s(torch, lambda: dev_buf[:n].copy_(pinned[:n],
                                                          non_blocking=True))
            if rep:
                ceil["d2h"].append(d2h)
                ceil["h2d"].append(h2d)
        med = {leg: float(np.median(v)) for leg, v in secs.items()}
        med.update({f"pinned {k}": float(np.median(v))
                    for k, v in ceil.items()})
        hbm_s = 2 * nbytes / HBM_BYTES_PER_S
        for leg in ("host out", "host in"):
            samples["host"].append((float(nbytes), med[leg]))
        for leg in ("slab out", "slab in"):
            samples["slab"].append((float(nbytes), med[leg]))
        rows.append(dict(pages=n, bytes=nbytes, hbm_bound_s=hbm_s,
                         **{k.replace(" ", "_") + "_s": v
                            for k, v in med.items()}))
        print(f"link legs: {n} pages, {nbytes} B; median of "
              f"{LINK_REPEATS} (ms, GB/s): "
              + "; ".join(f"{k} {1e3 * v:.4f} ({nbytes / v / 1e9:.3f})"
                          for k, v in med.items())
              + f"; slab HBM bound {1e3 * hbm_s:.4f} ms; on {card}")
    host = fit_link_model(samples["host"], "pcie5-measured")
    slab = fit_link_model(samples["slab"], SLAB_LINK)
    if host is None or slab is None:
        raise AssertionError(f"link legs: no fit (host {host}, slab {slab})")
    calibrated = calibrate_profile(H100_SXM, host_samples=samples["host"])
    if calibrated.host_link != host or calibrated.fabric != H100_SXM.fabric:
        raise AssertionError(f"link legs: calibrated profile {calibrated} "
                             f"is not H100_SXM with the host fit")
    for leg, link in (("host", host), ("slab", slab)):
        xs = np.asarray([x for x, _ in samples[leg]])
        ys = np.asarray([y for _, y in samples[leg]])
        err = np.abs(link.latency + xs / link.peak_bw - ys) / ys
        print(f"link fit {leg}: {len(xs)} samples ({len(LINK_SIZES)} sizes "
              f"x 2 directions) -> {link.name}: peak_bw "
              f"{link.peak_bw:.6e} B/s, latency {link.latency:.6e} s; fit "
              f"error median {np.median(err):.4f} max {err.max():.4f}; on "
              f"{card}")
    pinned_bw = max(rows[-1]["bytes"] / rows[-1][f"pinned_{d}_s"]
                    for d in ("d2h", "h2d"))
    print(f"link legs: the host leg's fitted bandwidth is "
          f"{host.peak_bw / pinned_bw:.4f} of a pinned copy_ at "
          f"{LINK_SIZES[-1]:,} pages "
          f"({pinned_bw / 1e9:.3f} GB/s); H100_SXM's datasheet host link "
          f"{H100_SXM.host_link.peak_bw / 1e9:.1f} GB/s, "
          f"{H100_SXM.host_link.latency:.1e} s; the calibrated profile "
          f"{calibrated.name}: host_link {calibrated.host_link}, fabric "
          f"{calibrated.fabric.name} (datasheet, unchanged); launches "
          f"{json.dumps(launches)}")
    record = dict(card=card, page_bytes=page_bytes, rows=rows,
                  host_fit=dataclasses.asdict(host),
                  slab_fit=dataclasses.asdict(slab),
                  calibrated=calibrated.name)
    print(f"link legs record: {json.dumps(record)}")
    del aq, data, dev_buf, pinned
    release(torch)
    return calibrated, launches, record


def pctl(xs, q):
    """Quantile by sorted-index clamp, as the reference's benchmarks."""
    xs = sorted(xs)
    return float(xs[min(int(q * len(xs)), len(xs) - 1)])


def fig9_requests(np, seed, n=80, rate=5.0):
    """``test_aqua_core.py``'s ``_mkreqs(5.0)``: 80 Poisson requests."""
    from repro_torch.core.simulator import Request
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / rate, n))
    return [Request(i, float(arr[i]), int(rng.integers(400, 1600)),
                    int(rng.integers(150, 500))) for i in range(n)]


def phase_paper_sim(np, profiles, card):
    """Phase 73: the simulator at the paper's figures under each profile
    (numpy on the host). Fig. 9 / 1b: aqua-codellama-34b on 80 Poisson
    requests at 5 a second (seed 0), vllm over host against cfs over the
    fabric and over host, and the Fig. 1b pair on seed 1; TTFT p50/p90 and
    RCT p50 with their ratios. Fig. 7: aqua-opt-30b decoding at an
    8,000-token context, fabric over host. Asserts what the reference
    asserts on ``A100_NVLINK`` and that every run finishes every request.
    Returns {profile: ratios}."""
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import ModelCost
    from repro_torch.core.simulator import (ServingSimulator,
                                            long_prompt_tokens_per_s)
    ccfg, ocfg = get_config("aqua-codellama-34b"), get_config("aqua-opt-30b")
    cmc, omc = ModelCost.from_config(ccfg), ModelCost.from_config(ocfg)
    cwb, owb = ccfg.param_count() * 2, ocfg.param_count() * 2
    out = {}
    for hw in profiles:
        t = time.perf_counter()
        res = {}
        for seed, sched, tier in ((0, "vllm", "host"), (0, "cfs", "fabric"),
                                  (0, "cfs", "host"), (1, "cfs", "host"),
                                  (1, "cfs", "fabric")):
            sim = ServingSimulator(hw, cmc, weight_bytes=cwb,
                                   kv_capacity_bytes=80e9 - cwb - 2e9,
                                   scheduler=sched, offload_tier=tier,
                                   max_running=20)
            r = sim.run(fig9_requests(np, seed))
            if not all(q.finish is not None for q in r.requests):
                raise AssertionError(f"paper sim {hw.name}: {sched}/{tier} "
                                     f"seed {seed} left requests unfinished")
            res[(seed, sched, tier)] = dict(
                ttft_p50=pctl(r.ttfts(), 0.5), ttft_p90=pctl(r.ttfts(), 0.9),
                rct_p50=pctl(r.rcts(), 0.5))
        free = 80e9 - owb - 12e9
        th = {tier: long_prompt_tokens_per_s(
            hw, omc, ctx_tokens=8000, free_hbm_bytes=free,
            weight_bytes=owb, tier=tier) for tier in ("host", "fabric")}
        v, a, h = (res[(0, "vllm", "host")], res[(0, "cfs", "fabric")],
                   res[(0, "cfs", "host")])
        ratios = dict(
            fig9_ttft_p50_vllm_over_cfs_fabric=v["ttft_p50"] / a["ttft_p50"],
            fig9_ttft_p90_vllm_over_cfs_fabric=v["ttft_p90"] / a["ttft_p90"],
            fig1b_rct_p50_cfs_host_over_fabric_seed0=h["rct_p50"]
            / a["rct_p50"],
            fig1b_rct_p50_cfs_host_over_fabric_seed1=(
                res[(1, "cfs", "host")]["rct_p50"]
                / res[(1, "cfs", "fabric")]["rct_p50"]),
            fig7_fabric_over_host=th["fabric"] / th["host"])
        out[hw.name] = dict(runs={f"seed{k[0]} {k[1]}/{k[2]}": x
                                  for k, x in res.items()},
                            fig7_tokens_per_s=th, ratios=ratios,
                            host_link=dataclasses.asdict(hw.host_link),
                            fabric=dataclasses.asdict(hw.fabric))
        print(f"paper sim {hw.name} (host link {hw.host_link.peak_bw:.4e} "
              f"B/s + {hw.host_link.latency:.3e} s, fabric "
              f"{hw.fabric.peak_bw:.4e} B/s + {hw.fabric.latency:.3e} s): "
              + "; ".join(f"{k} TTFT p50 {x['ttft_p50']:.4f} p90 "
                          f"{x['ttft_p90']:.4f} RCT p50 {x['rct_p50']:.4f} s"
                          for k, x in out[hw.name]["runs"].items())
              + f"; Fig. 7 tokens/s host {th['host']:.4f} fabric "
              f"{th['fabric']:.4f}; ratios {json.dumps(ratios)}; "
              f"{time.perf_counter() - t:.2f} s on the host of {card}")
        if hw.name == "a100-nvlink":
            if not (a["ttft_p90"] < v["ttft_p90"] / 2.0
                    and a["ttft_p50"] < v["ttft_p50"] / 1.8):
                raise AssertionError("paper sim: Fig. 9's TTFT gate fails "
                                     "on A100_NVLINK")
            if not ratios["fig1b_rct_p50_cfs_host_over_fabric_seed1"] > 1.0:
                raise AssertionError("paper sim: Fig. 1b's RCT gate fails "
                                     "on A100_NVLINK")
            if not 4.0 < ratios["fig7_fabric_over_host"] < 8.0:
                raise AssertionError("paper sim: Fig. 7's 4-8x gate fails "
                                     "on A100_NVLINK")
    return out


PLACER_MODELS = (("llm-llama2-13b", -25.0, "consumer"),
                 ("img-sd", 30.0, "producer"),
                 ("llm-mistral", -20.0, "consumer"),
                 ("aud-gen", 25.0, "producer"))
PLACER_REQUESTS = 6                 # 4 running, 2 parked between slices
PLACER_LEASE = 4 * 1024 ** 3        # the engine's grant from its producer
# after the reclaim every park lands on HOST; a slice boundary parks before
# it restores: up to 4 requests x 40 layers x 50 pages (800 tokens / 16)
PLACER_HOST_PAGES = 8192


def phase_placer_serve(torch, np, dev, card):
    """Phase 74, the twin of ``examples/serve_cfs.py`` at full width:
    AQUA-PLACER (``solver="bnb"``) places an LLM consumer, an image
    producer, a second LLM and an audio producer on 2 servers of 2 GPUs;
    its pairs go to a ``Coordinator(strict_pairing=True)``; a
    ``BatchInformer`` offers the paired producer's spare memory; a
    ``ServingEngine`` for aqua-llama2-13b at full width and depth (CFS,
    REMOTE offload, the coordinator's 4 GiB grant, ``audit=True``)
    serves ``PLACER_REQUESTS`` seeded requests through rows 1-7; at the
    first step that leaves pages on the lease the producer reclaims. The
    reclaim must complete, no page stay on REMOTE, every request finish
    and the auditor stay clean (an audit every step, one more at the end).
    Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    from repro_torch.core.aqua_tensor import REMOTE
    from repro_torch.core.control_loop import BatchInformer
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.faults import InvariantAuditor
    from repro_torch.core.placer import ModelSpec, place
    from repro_torch.kernels import build
    cfg = get_config("aqua-llama2-13b")
    placement = place([ModelSpec(*m) for m in PLACER_MODELS], n_servers=2,
                      gpus_per_server=2, gpu_mem=80.0, solver="bnb")
    pairs = dict(placement.pairs)
    consumer = PLACER_MODELS[0][0]
    producer = pairs[consumer]
    print(f"placer: servers {json.dumps(placement.servers())}, pairs "
          f"{placement.pairs}, objective {placement.objective}, solver "
          f"{placement.solver} in {1e3 * placement.solve_time:.3f} ms")
    if len(placement.pairs) != 2 or any(
            sorted(n.split("-")[0] for n in ms) not in (["img", "llm"],
                                                        ["aud", "llm"])
            for ms in placement.servers().values()):
        raise AssertionError("placer: not one consumer beside one producer "
                             "a server")
    coord = Coordinator(strict_pairing=True)
    coord.set_pairing(pairs)
    BatchInformer(producer, coord, total_bytes=80e9,
                  working_set_bytes=50e9).inform_stats()
    model = phase_dense_model(torch, cfg, 17, 13_015_859_200)
    eng, kv, reqs = make_engine(np, cfg, model, dev,
                                host_pages=PLACER_HOST_PAGES,
                                coordinator=coord,
                                want_remote_bytes=PLACER_LEASE, audit=True,
                                name=consumer, n_req=PLACER_REQUESTS)
    print(f"placer: offers after the grant {json.dumps(coord.stats())}")
    plane = kv.planes["kv"].aqua
    if list(plane.remote_capacity) != [producer]:
        raise AssertionError(f"placer: lease from "
                             f"{list(plane.remote_capacity)}, not the "
                             f"paired producer {producer}")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t = time.perf_counter()
    reclaim_at = None
    while (eng.waiting or eng.running) and eng.metrics.steps < 5000:
        eng.step()
        if reclaim_at is None and (plane.page_table[:, 0] == REMOTE).any():
            reclaim_at = eng.metrics.steps
            coord.request_reclaim(producer)
    eng.run(0)                      # the final respond of ServingEngine.run
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = build.launch_counts()
    m, meter = eng.metrics, kv.meter
    tiers = kv.stats()["tiers"]
    InvariantAuditor().audit(kv, engine=eng)
    print(f"placer serve: {cfg.name} {len(reqs)} requests, {m.steps} steps, "
          f"{wall:.3f} s wall; reclaim of {producer} requested at step "
          f"{reclaim_at}, complete {coord.reclaim_status(producer)}; "
          f"preemptions {m.preemptions} restores {m.restores}; fabric "
          f"{meter.messages_fabric} messages {meter.bytes_fabric:.0f} B, "
          f"host {meter.messages_host} messages {meter.bytes_host:.0f} B; "
          f"tiers {json.dumps(tiers, sort_keys=True)}; audits "
          f"{eng.auditor.audits}; launches "
          f"{json.dumps(launches, sort_keys=True)}; on {card}")
    if reclaim_at is None or not coord.reclaim_status(producer):
        raise AssertionError("placer serve: the reclaim never completed")
    if tiers["remote"] != 0 or plane.remote_pools:
        raise AssertionError(f"placer serve: {tiers['remote']} pages left "
                             f"on REMOTE")
    if len(eng.finished) != len(reqs) or not all(
            len(r.generated) == r.max_new_tokens
            and all(0 <= x < cfg.vocab_size for x in r.generated)
            for r in reqs):
        raise AssertionError("placer serve: not every request finished "
                             "with its tokens in the vocab")
    if eng.auditor.audits != m.steps:
        raise AssertionError(f"placer serve: {eng.auditor.audits} audits in "
                             f"{m.steps} steps")
    if not all(launches.get(k, 0) > 0 for k in ENGINE_ROWS):
        raise AssertionError(f"placer serve: the run never launched some of "
                             f"{list(ENGINE_ROWS)}")
    one_writer_a_layer("placer serve", launches)
    del eng, kv, reqs, model
    release(torch)
    return {"placer serve": launches}


def link_and_policy_phases(torch, np, dev, card, t0):
    """Phases 72-74: the link legs measured and fitted, the paper's
    figures on the simulator under A100_NVLINK, H100_SXM and the
    calibrated profile, and the placer -> coordinator -> engine -> reclaim
    path at full width. Returns {path: launch counts}."""
    from repro_torch.core.perfmodel import A100_NVLINK, H100_SXM
    lap, done = model_laps(torch, "link legs, paper sim, placer", t0)
    calibrated, link_launches, _ = phase_link_legs(torch, np, dev, card)
    lap("link legs")
    phase_paper_sim(np, (A100_NVLINK, H100_SXM, calibrated), card)
    lap("paper sim")
    paths = {"link legs": link_launches}
    paths.update(phase_placer_serve(torch, np, dev, card))
    lap("placer serve")
    done()
    return paths


# -- whisper-tiny and windowed training (phases 75-78) ----------------------
# label -> ((B, Sq, Sk, H, K, hd, causal, window), the backward too):
# whisper-tiny's attention at its serving shapes (B 4: the encoder, the
# cross-attention at prefill and at decode) and its training shapes (B 8,
# 448 decoder tokens over 1,500 frames)
WHISPER_FLASH = {
    "encoder": ((4, 1500, 1500, 6, 6, 64, False, 0), False),
    "cross prefill": ((4, 4, 1500, 6, 6, 64, False, 0), False),
    "cross decode": ((4, 1, 1500, 6, 6, 64, False, 0), False),
    "train encoder": ((8, 1500, 1500, 6, 6, 64, False, 0), True),
    "train decoder": ((8, 448, 448, 6, 6, 64, True, 0), True),
    "train cross": ((8, 448, 1500, 6, 6, 64, False, 0), True)}
# the windowed train steps' attention (phase 78)
WINDOWED_FLASH = {
    "gemma3-12b local": ((1, 2048, 2048, 16, 8, 256, True, 1024), True),
    "gemma3-12b global": ((1, 2048, 2048, 16, 8, 256, True, 0), True),
    "aqua-mistral-7b": ((1, 4608, 4608, 32, 8, 128, True, 4096), True)}
WHISPER_SERVE = (76, 4, 4, 448)     # seed, batch, prompt, positions
WHISPER_TRAIN = (77, 8, 448)        # seed, batch, decoder tokens
# arch -> (layers, tokens, seed): one gemma3 group (5 local, 1 global) at
# 2,048 tokens, 2 of mistral's layers at 4,608, past its window of 4,096
WINDOWED_TRAIN = {"gemma3-12b": (6, 2048, 78),
                  "aqua-mistral-7b": (2, 4608, 79)}
WINDOWED_STEPS = 5
# the windowed steps' float32 gate, kernel against plain: the loss
# (absolute) and every gradient (distance over the plain one's norm). Its
# control drops layer 0's window, which at mistral's shape moves the
# gradients by ~5e-3 of their norm (a d 512 proxy on the CPU): below phase
# 12's bf16 limits, so the float32 gate is where a window is held
F32_LOSS_LIMIT, F32_GRAD_LIMIT = 1e-4, 1e-3


def heaviest_key_control(torch, q, k, v, causal, window):
    """The plain version with each query row's heaviest visible key (its
    largest score) masked as well: at 1,500 near-uniform keys the diagonal
    key alone moves a row's output below the bf16 limit. Differentiable."""
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         attention_mask)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    qg = q.float().reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / hd ** 0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s = s.scatter(-1, s.detach().argmax(-1, keepdim=True), NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", probs, v).reshape(B, Sq, H, hd)


def flash_shape_case(torch, g, label, shape, backward, recs):
    """One shape of phases 75 and 78, in float32 and bf16: the forward
    within FLASH_TOL of its plain version and, with ``backward``, dq / dk /
    dv within FLASH_BWD_REL of the plain formula's norm, the heaviest-key
    control beyond both; then, in bf16, device times (plain, kernel,
    kernel, plain) beside the library attention and the bound. Adds the
    records to ``recs["fwd"]`` / ``recs["bwd"]`` under ``label``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, Sq, Sk, H, K, hd, causal, window = shape
    kw = dict(causal=causal, window=window)
    name = (f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} causal={causal} "
            f"window={window}")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    errs = {}
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        q, k, v, do = flash_inputs(torch, g, shape, dt)
        o = fa_ops.flash_attention_fwd(q, k, v, **kw)[0]
        want = fa_ref.flash_attention_ref(q, k, v, **kw)
        ctrl = heaviest_key_control(torch, q, k, v, causal, window)
        e = dict(fwd=(o.float() - want.float()).abs().max().item(),
                 fwd_control=(ctrl.float() - want.float()).abs().max()
                 .item())
        finite = bool(torch.isfinite(o).all())
        ok = e["fwd"] <= FLASH_TOL[dname] < e["fwd_control"]
        del o, want, ctrl
        if backward:
            ro, rlse = fa_ref.flash_attention_fwd_ref(q, k, v, **kw)
            got = fa_ops.flash_attention_bwd(q, k, v, ro, rlse, do, **kw)
            ref = fa_ref.flash_attention_bwd_ref(q, k, v, ro, rlse, do, **kw)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            c_grads = torch.autograd.grad(heaviest_key_control(
                torch, *leaves, causal, window), leaves, do)
            e["bwd"] = max(rel(a, b) for a, b in zip(got, ref))
            e["bwd_control"] = min(rel(a, b) for a, b in zip(c_grads, ref))
            finite = finite and all(bool(torch.isfinite(t).all())
                                    for t in got)
            ok = ok and e["bwd"] <= FLASH_BWD_REL[dname] < e["bwd_control"]
            del ro, rlse, got, ref, leaves, c_grads
        errs[dname] = e
        print(f"flash {label} {name} {dname}: "
              + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
              + f" (limits fwd {FLASH_TOL[dname]}, bwd "
              f"{FLASH_BWD_REL[dname]}: the errors within, the controls "
              f"beyond)")
        if not (finite and ok):
            raise AssertionError(f"flash attention {label} {name} {dname}:"
                                 f" {e}, finite {finite}")
    # q, k, v, do are the bf16 inputs from here on
    f_flop, f_bytes, b_flop, b_bytes = flash_work(shape, 2)
    ms_f, plain_f = interleaved(
        lambda: fa_ref.flash_attention_ref(q, k, v, **kw),
        lambda: fa_ops.flash_attention_fwd(q, k, v, **kw), 10, plain_iters=3)
    lib_f, lib_fb = library_attention_ms(torch, q, k, v,
                                         do if backward else None, 10,
                                         window=window, causal=causal)
    bf, byf = bound_ms(f_bytes, f_flop)
    recs["fwd"][label] = dict(
        shape=name, max_abs_err=errs["bfloat16"]["fwd"],
        max_abs_err_float32=errs["float32"]["fwd"],
        control=errs["bfloat16"]["fwd_control"],
        tolerance=FLASH_TOL["bfloat16"], ms=ms_f, plain_ms=plain_f,
        bound_ms=bf, bound_by=byf, library_ms=lib_f)
    line = (f"flash {label} {name} bf16: forward kernel {ms_f:.4f} ms plain "
            f"{plain_f:.4f} bound {bf:.4f} ({byf}) library {lib_f:.4f}; "
            f"{f_flop / (ms_f * 1e9):.1f} TFLOP/s")
    if backward:
        o, lse = fa_ops.flash_attention_fwd(q, k, v, **kw)
        ms_b, plain_b = interleaved(
            lambda: fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
            lambda: fa_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw), 10,
            plain_iters=3)
        bb, byb = bound_ms(b_bytes, b_flop)
        recs["bwd"][label] = dict(
            shape=name, max_abs_err=errs["bfloat16"]["bwd"],
            max_abs_err_float32=errs["float32"]["bwd"],
            control=errs["bfloat16"]["bwd_control"],
            error_kind="dq/dk/dv distance relative to the plain formula's "
            "norm", tolerance=FLASH_BWD_REL["bfloat16"], ms=ms_b,
            plain_ms=plain_b, bound_ms=bb, bound_by=byb,
            library_ms=lib_fb - lib_f)
        line += (f"; backward kernel {ms_b:.4f} ms plain {plain_b:.4f} "
                 f"bound {bb:.4f} ({byb}) library fwd+bwd minus fwd "
                 f"{lib_fb - lib_f:.4f}; {b_flop / (ms_b * 1e9):.1f} "
                 f"TFLOP/s")
        del o, lse
    print(line)
    del q, k, v, do


def phase_flash_shapes(torch, report, shapes, key, seed):
    """Row 9 at ``shapes`` (phase 75: whisper's; phase 78: the windowed
    steps'), each through ``flash_shape_case``; the records go under
    ``key`` in the ``flash_attention`` and ``flash_attention_bwd``
    entries."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    recs = {"fwd": {}, "bwd": {}}
    for label, (shape, backward) in shapes.items():
        flash_shape_case(torch, g, label, shape, backward, recs)
    for name, part in (("flash_attention", "fwd"),
                       ("flash_attention_bwd", "bwd")):
        next(k for k in report if k["name"] == name)[key] = recs[part]


def refuses(what, make):
    """``make()`` must raise ``ValueError``: the engines take no model
    whose context has no page plane."""
    try:
        make()
    except ValueError as e:
        print(f"{what} refuses it: {e}")
        return
    raise AssertionError(f"{what} accepted a model it cannot page")


def row_rel(torch, got, want):
    """The largest, over the batch rows, distance of ``got`` (B, V) to
    ``want`` over ``want``'s row norm."""
    return ((got.float() - want.float()).norm(dim=-1)
            / want.float().norm(dim=-1)).max().item()


def phase_whisper_serve(torch, np, cfg, dev):
    """Phase 76: whisper-tiny served at full width and depth through the
    dense cache, its engines' refusals, and the float32 gate. Returns
    {path: launch counts}."""
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagedStateRuntime
    seed, B, P, S = WHISPER_SERVE
    Te, d = cfg.encdec.encoder_seq_len, cfg.d_model
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"whisper-tiny model: {n:,} parameters (the reference's formula "
          f"{cfg.param_count():,}: it counts three d x d_ff matrices an "
          "encoder MLP and no final norm)")
    refuses("ServingEngine", lambda: ServingEngine(cfg, model, device=dev))
    refuses("PagedStateRuntime", lambda: PagedStateRuntime(
        cfg, max_seq=S, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = (0.02 * torch.randn((B, Te, d), generator=g, device=dev)).to(
        cfg.torch_compute_dtype())
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    cache = api.init_decode_state(cfg, B, S, device=dev)
    nbytes = {k: sum(t.numel() * t.element_size() for t in c)
              for k, c in cache.items()}
    # a warm-up prefill into a cache of its own (not timed, not counted)
    api.prefill(model, cfg, tokens[:, :P],
                api.init_decode_state(cfg, B, S, device=dev), enc_embeds=enc)
    paths = {}
    _sync(torch, dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t = time.perf_counter()
    logits, cache = api.prefill(model, cfg, tokens[:, :P], cache,
                                enc_embeds=enc)
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t
    paths["whisper-tiny prefill"] = build.launch_counts()
    build.reset_launch_counts()
    tok, walls = logits.argmax(-1), []
    for p in range(P, S - 1):
        t = time.perf_counter()
        out, cache = api.decode_step(model, cfg, cache, tok, p)
        _sync(torch, dev)
        walls.append(time.perf_counter() - t)
        tok = out.argmax(-1)
    paths["whisper-tiny decode"] = build.launch_counts()
    # the last position, profiled (not counted)
    (out, cache), prof = profile_call(torch, lambda: api.decode_step(
        model, cfg, cache, tok, S - 1))
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(out).all())
    steps = len(walls)
    flash_p = paths["whisper-tiny prefill"].get("flash_attention", 0)
    flash_d = paths["whisper-tiny decode"].get("flash_attention", 0)
    print(f"whisper-tiny cache: B {B}, {S} self slots, {Te} cross slots; "
          f"{json.dumps(nbytes)} B")
    print(f"whisper-tiny main path: prefill of {B} x {P} tokens over {Te} "
          f"frames {prefill_s * 1e3:.2f} ms ({flash_p} flash launches); "
          f"{steps} decode steps p50 {np.percentile(walls, 50) * 1e3:.2f} "
          f"ms p99 {np.percentile(walls, 99) * 1e3:.2f} ms "
          f"({B * steps / sum(walls):,.1f} tokens/s), launches "
          f"{paths['whisper-tiny decode']}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; logits "
          f"finite {finite}")
    print(f"whisper-tiny profiled decode step (position {S - 1}): "
          f"{json.dumps(prof)}")
    n_attn = cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    if not (finite and flash_p == n_attn
            and flash_d == cfg.n_layers * steps):
        raise AssertionError(f"whisper-tiny main path: finite {finite}, "
                             f"{flash_p} / {flash_d} flash launches, want "
                             f"{n_attn} / {cfg.n_layers * steps}")
    del cache
    paths["whisper-tiny float32 gate"] = phase_whisper_gate(
        torch, cfg, model, dev, enc, tokens)
    return paths


def phase_whisper_gate(torch, cfg, model, dev, enc, tokens):
    """Phase 76's gate on a float32 copy of the model: the prefill's last
    logits and each teacher-forced decode step's against the training
    forward's at the same position, within GATE_REL of the row's norm; a
    control decoding the first step with the cross cache zeroed beyond.
    Returns the prefill's and the steps' launch counts."""
    from repro_torch.kernels import build
    from repro_torch.models import api
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    m32 = copy.deepcopy(model).float()
    enc32, (B, S), P = enc.float(), tokens.shape, WHISPER_SERVE[2]
    with torch.no_grad():
        full = api.forward(m32, cfg32, tokens, enc_embeds=enc32)[0]
    build.reset_launch_counts()
    cache = api.init_decode_state(cfg32, B, S, device=dev)
    lg, cache = api.prefill(m32, cfg32, tokens[:, :P], cache,
                            enc_embeds=enc32)
    errs = [row_rel(torch, lg, full[:, P - 1])]
    ctrl = {k: type(c)(*(t.clone() for t in c)) for k, c in cache.items()}
    for t in ctrl["cross"]:
        t.zero_()
    control = row_rel(torch, api.decode_step(m32, cfg32, ctrl,
                                             tokens[:, P], P)[0], full[:, P])
    del ctrl
    for p in range(P, S):
        lg, cache = api.decode_step(m32, cfg32, cache, tokens[:, p], p)
        errs.append(row_rel(torch, lg, full[:, p]))
    counts = build.launch_counts()
    print(f"whisper-tiny float32 gate: prefill of {P} then {S - P} decode "
          f"steps, worst distance to the forward {max(errs):.3g} of the "
          f"row's norm (limit {GATE_REL}); control (cross cache zeroed) "
          f"{control:.3g}")
    if not max(errs) <= GATE_REL < control:
        raise AssertionError(f"whisper-tiny float32 gate: worst "
                             f"{max(errs)}, control {control}")
    del m32, cache, full
    return counts


def phase_whisper_train_step(torch, np, cfg, dev):
    """Phase 77's check and compression: one train step through the
    kernels and the plain versions, the control, and ``compress_tree`` of
    the step's gradients on the card against CPU copies. Returns the
    step's launches."""
    from repro_torch.kernels import build
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, linear, rms_norm, unembed
    from repro_torch.models import api, encdec
    from repro_torch.models.losses import shifted_xent
    from repro_torch.training import compression
    from repro_torch.training.data import DataConfig, make_batch
    seed, B, T = WHISPER_TRAIN
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    batch = {k: v.to(dev) for k, v in make_batch(
        DataConfig(seed=0, batch=B, seq_len=T), cfg, 0).items()}
    eps = cfg.rmsnorm_eps

    def control_attention(mix, h):
        pos = torch.arange(h.shape[1], device=h.device)[None, :]
        q, k, v = attn._project_qkv(mix, cfg, h, pos)
        ctx = flash_control(torch, q, k, v, True, 0)
        return linear(mix.wo, ctx.reshape(h.shape[0], h.shape[1], -1))

    def control_loss(m, b):
        enc_out = encdec.encode(m, cfg, b["enc_embeds"], impl="ref")
        x = embed(m.embed, cfg, b["tokens"])
        for layer, blk in enumerate(m.dec_blocks):
            ck, cv = encdec.cross_kv(blk.cross, cfg, enc_out)
            h = rms_norm(blk.n1, x, eps)
            x = x + (control_attention(blk.self, h) if layer == 0 else
                     attn.attention_full(blk.self, cfg, h, impl="ref"))
            x = encdec._cross_and_mlp(blk, cfg, x, ck, cv, "ref")
        x = rms_norm(m.final_norm, x, eps)
        return shifted_xent(unembed(m.embed, cfg, x), b["tokens"])

    build.reset_launch_counts()
    loss_k, g_k = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="kernel"))
    _sync(torch, dev)
    launches = build.launch_counts()
    loss_r, g_r = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="ref"))
    loss_c, g_c = train_step_grads(torch, model, batch, control_loss)
    _sync(torch, dev)
    print(f"whisper-tiny train step ({B} x {T} tokens over "
          f"{cfg.encdec.encoder_seq_len} frames): launches "
          f"{json.dumps(launches, sort_keys=True)}")
    check_step_grads("whisper-tiny train step", loss_k, g_k, loss_r, g_r,
                     loss_c, g_c)
    del g_r, g_c
    n_attn = cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    if launches.get("flash_attention", 0) != n_attn or launches.get(
            "flash_attention_bwd", 0) < n_attn:
        raise AssertionError(f"whisper-tiny train step launches {launches}:"
                             f" want {n_attn} forward, >= {n_attn} "
                             "backward")
    # int8 compression of the step's gradients: the card's bits and the
    # CPU's, and error feedback within a scale
    err = compression.init_error_buffers(g_k)
    comps, errs = compression.compress_tree(g_k, err)
    # one call a timing: its ~8 launches a gradient fill the launch queue
    ms = device_ms(lambda: compression.compress_tree(g_k, err), 1)
    g_cpu = {k: t.cpu() for k, t in g_k.items()}
    comps_c, errs_c = compression.compress_tree(
        g_cpu, compression.init_error_buffers(g_cpu))

    def bits(t):
        return t.contiguous().view(torch.int32).cpu()
    same = all(torch.equal(comps[k].q.cpu(), comps_c[k].q)
               and torch.equal(bits(comps[k].scale), bits(comps_c[k].scale))
               and torch.equal(bits(errs[k]), bits(errs_c[k]))
               for k in g_k)
    ratio = max((errs[k].abs().max() / comps[k].scale).item() for k in g_k)
    n = sum(t.numel() for t in g_k.values())
    print(f"whisper-tiny compress_tree: {len(g_k)} gradients, {n:,} "
          f"values -> {n:,} B of int8 payload ({4 * n:,} B in float32); "
          f"card bit-equal to CPU {same}; worst |err| / scale {ratio:.4f} "
          f"(limit 1.01); {ms:.4f} ms on the card")
    if not (same and ratio <= 1.01):
        raise AssertionError(f"whisper-tiny compress_tree: bit-equal "
                             f"{same}, |err| / scale {ratio}")
    del g_k, comps, errs, comps_c, errs_c, g_cpu, model
    return launches


def windowed_train_check(torch, cfg, model, batch, label, limits):
    """Kernel against plain and the control (layer 0 attending with no
    window) on one train step: the loss within ``limits[0]`` and every
    gradient within ``limits[1]`` of the plain one's norm, the control's
    worst beyond ``limits[1]``. Returns the kernel step's launches."""
    from repro_torch.kernels import build
    from repro_torch.layers import attention as attn
    from repro_torch.layers.core import embed, rms_norm, unembed
    from repro_torch.models import api, lm
    from repro_torch.models.losses import shifted_xent
    gs = lm.group_size(cfg)

    def control_loss(m, b):
        x = embed(m.embed, cfg, b["tokens"])
        for layer, blk in enumerate(m.blocks):
            w = 0 if layer == 0 else lm.layer_window(cfg, layer % gs)
            x = lm._layer(blk, cfg, x, lambda mix, h: attn.attention_full(
                mix, cfg, h, window=w, impl="ref"))
        x = rms_norm(m.final_norm, x, cfg.rmsnorm_eps)
        return shifted_xent(unembed(m.embed, cfg, x), b["tokens"])

    build.reset_launch_counts()
    loss_k, g_k = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="kernel"))
    torch.cuda.synchronize()
    launches = build.launch_counts()
    loss_r, g_r = train_step_grads(torch, model, batch, lambda m, b:
                                   api.loss_fn(m, cfg, b, impl="ref"))
    rel_k = grad_rel(g_k, g_r)
    del g_k
    loss_c, g_c = train_step_grads(torch, model, batch, control_loss)
    rel_c = grad_rel(g_c, g_r)
    del g_c, g_r
    worst = sorted(rel_k.items(), key=lambda kv: -kv[1])[:3]
    print(f"{label}: loss kernel {loss_k:.6f} plain {loss_r:.6f} (|d| "
          f"{abs(loss_k - loss_r):.3g}, limit {limits[0]}) control "
          f"{loss_c:.6f}; gradients kernel vs plain, worst "
          f"{[(n, float(f'{r:.3g}')) for n, r in worst]} (limit "
          f"{limits[1]}); control (layer 0, no window) worst "
          f"{max(rel_c.values()):.4g} ({max(rel_c, key=rel_c.get)}); "
          f"launches {json.dumps(launches, sort_keys=True)}")
    return launches, (abs(loss_k - loss_r) <= limits[0]
                      and max(rel_k.values()) <= limits[1]), \
        max(rel_c.values())


def phase_windowed_train(torch, np, dev):
    """Phase 78's train steps: for each windowed arch at its width cut in
    depth, the bf16 step kernel against plain at phase 12's limits, 5
    timed kernel train steps, then the float32 gate with its control.
    Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 trainable_params)
    paths = {}
    for arch, (layers, T, seed) in WINDOWED_TRAIN.items():
        cfg = get_config(arch).replace(n_layers=layers)
        batch = {k: v.to(dev) for k, v in make_batch(
            DataConfig(seed=0, batch=1, seq_len=T), cfg, 0).items()}
        windows = [lm.layer_window(cfg, i % lm.group_size(cfg))
                   for i in range(layers)]
        model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), dev)
        print(f"{arch} windowed train step: {layers} layers (windows "
              f"{windows}), 1 x {T} tokens, "
              f"{sum(p.numel() for p in model.parameters()):,} parameters")
        launches, ok, ctrl = windowed_train_check(
            torch, cfg, model, batch, f"{arch} bf16 train step",
            (LOSS_ABS_LIMIT, GRAD_REL_LIMIT))
        if not ok:
            raise AssertionError(f"{arch} bf16 train step: kernel against "
                                 "plain beyond phase 12's limits")
        if launches.get("flash_attention", 0) != layers or launches.get(
                "flash_attention_bwd", 0) < layers:
            raise AssertionError(f"{arch} train step launches {launches}")
        paths[f"{arch} windowed train step"] = launches
        ocfg = AdamWConfig(lr=1e-5)
        step = make_train_step(cfg, ocfg, TrainConfig(impl="kernel"))
        opt = adamw_init(trainable_params(model), ocfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for _ in range(WINDOWED_STEPS):
            t = time.perf_counter()
            model, opt, stats = step(model, opt, batch)
            losses.append(float(stats["loss"]))
            walls.append(time.perf_counter() - t)
        p50 = float(np.percentile(walls[1:], 50))
        print(f"{arch} windowed train run: {WINDOWED_STEPS} kernel steps, "
              f"losses {[round(x, 4) for x in losses]}, step p50 (steps "
              f"2-{WINDOWED_STEPS}) {p50 * 1e3:.2f} ms, first "
              f"{walls[0] * 1e3:.2f} ms, {T / p50:,.1f} tokens/s; peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{arch} windowed train run: {losses}")
        del model, opt, step
        release(torch)
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        m32 = lm.init_params(cfg32, torch.Generator(device=dev).manual_seed(
            seed), dev)
        launches, ok, ctrl = windowed_train_check(
            torch, cfg32, m32, batch, f"{arch} float32 gate",
            (F32_LOSS_LIMIT, F32_GRAD_LIMIT))
        if not (ok and ctrl > F32_GRAD_LIMIT):
            raise AssertionError(f"{arch} float32 gate: kernel within "
                                 f"{ok}, control {ctrl} (limit "
                                 f"{F32_GRAD_LIMIT})")
        paths[f"{arch} windowed float32 gate"] = launches
        del m32
        release(torch)
    return paths


def whisper_and_windowed_phases(torch, np, report, dev, t0):
    """Phases 75-78. Returns {path: launch counts}."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    lap, done = model_laps(torch, "whisper and windowed training", t0)
    phase_flash_shapes(torch, report, WHISPER_FLASH, "whisper", 75)
    lap("row 9 at whisper's shapes")
    paths = phase_whisper_serve(torch, np, cfg, dev)
    release(torch)
    lap("whisper-tiny served")
    paths["whisper-tiny train step"] = phase_whisper_train_step(
        torch, np, cfg, dev)
    release(torch)
    lap("whisper-tiny train step")
    paths["whisper-tiny train"] = phase_train_run(
        torch, np, cfg, dev, batch=WHISPER_TRAIN[1], seq=WHISPER_TRAIN[2],
        label="whisper-tiny train", seed=WHISPER_TRAIN[0])
    print(f"whisper-tiny train run: model FLOP per step by part (the line "
          f"above folds the encoder's {cfg.encdec.encoder_seq_len} frames "
          f"into its attention term): " + json.dumps(encdec_flop_parts(
              cfg, WHISPER_TRAIN[1], WHISPER_TRAIN[2])))
    release(torch)
    lap("whisper-tiny train run")
    phase_flash_shapes(torch, report, WINDOWED_FLASH, "windowed_train", 78)
    lap("row 9 at the windowed training shapes")
    paths.update(phase_windowed_train(torch, np, dev))
    lap("windowed train steps")
    done()
    return paths


# -- the scale-up domain (phases 79-81) ------------------------------------
MESH_REPEATS = 5                    # timed round trips a size after a warm one
MESH_ENGINE_REQUESTS = 6            # phase 74's serve: 4 running, 2 parked
MESH_ENGINE_LEASE = 4 * 1024 ** 3   # phase 74's grant, leased directly here


def mesh_devices(torch):
    """The domain's entries: two distinct cards where there are two, else
    ``[cuda:0, cuda:0]`` — one H100 is one device, so the "peer" is the
    same card and a leg is a same-HBM copy plus rows 6 and 7, not
    NVLink."""
    n = torch.cuda.device_count()
    devs = [torch.device("cuda:0"), torch.device(f"cuda:{1 if n >= 2 else 0}")]
    peer = ("a second card" if n >= 2 else
            "the same card (a same-HBM copy plus rows 6 and 7, not NVLink)")
    print(f"mesh domain: serving {devs[0]}, donor entry {devs[1]}: the peer "
          f"is {peer}")
    return devs


def mesh_move(torch, aq, dom, out, lps):
    """One timed move through the domain: its wall, meter, leg-count and
    launch-count deltas."""
    from repro_torch.core.aqua_tensor import REMOTE
    c0 = dom.collectives
    if out:
        t, moved, launched = link_move(torch, aq, "slab out", lps)
    else:
        t, moved, launched = link_move(torch, aq, "slab in", lps)
    if dom.collectives - c0 != 1:
        raise AssertionError(f"mesh legs: a move of {len(lps)} pages put "
                             f"{dom.collectives - c0} legs on the wire")
    if out and not (aq.page_table[lps, 0] == REMOTE).all():
        raise AssertionError("mesh legs: pages not on the donor slab")
    return t, moved, launched


def phase_mesh_legs(torch, np, dev, card):
    """Phase 79: phase 72's ``AquaTensor`` (aqua-llama2-13b kv pages, 2,048
    a pool) with ``mesh=`` a ``MeshTierDomain`` over ``mesh_devices``, and
    beside it phase 72's same-card slab (no mesh) holding the same pages.
    At each of 1, 2, 4, ..., 2,048 pages: one warm round trip, then
    ``MESH_REPEATS`` timed ones through each (median), the two alternating
    in one loop; every round trip bit-identical, each move one leg on the
    wire (``collectives``), one fabric message of its pages' bytes, one
    gather (row 6) and one scatter (row 7). Then the domain's own leg
    samples fitted: ``calibrated_profile(H100_SXM)``.
    Returns (launch counts of the mesh moves, the domain: phase 80's
    engine serves over it, its legs' samples at every size beside the
    engine's own)."""
    from repro_torch.configs import get_config
    from repro_torch.core.aqua_tensor import AquaTensor, TransferMeter
    from repro_torch.core.perfmodel import H100_SXM
    from repro_torch.distributed.mesh_tiers import MeshTierDomain
    cfg = get_config("aqua-llama2-13b")
    shape = (2, cfg.n_kv_heads, 16, cfg.resolved_head_dim)
    dtype = cfg.torch_compute_dtype()
    dom = MeshTierDomain(devices=mesh_devices(torch))
    tensors = {}
    for label, mesh in (("mesh", dom), ("slab", None)):
        aq = AquaTensor(n_logical=LINK_PAGES, page_shape=shape,
                        local_slots=LINK_PAGES, host_slots=1, dtype=dtype,
                        meter=TransferMeter(hw=H100_SXM), device=dev,
                        name="kv", mesh=mesh)
        aq.add_remote_lease("donor0", LINK_PAGES)
        tensors[label] = aq
    page_bytes = tensors["mesh"].page_bytes
    if page_bytes != 327_680 or tensors["mesh"].remote_pools[
            "donor0"].shape[0] != LINK_PAGES + 1:
        raise AssertionError(f"mesh legs: pages of {page_bytes} B")
    g = torch.Generator(device=dev).manual_seed(79)
    data = torch.randn((LINK_PAGES,) + shape, generator=g, device=dev,
                       dtype=torch.float32).to(dtype)
    lps = {k: aq.allocate(LINK_PAGES) for k, aq in tensors.items()}
    for k, aq in tensors.items():
        aq.write_local(lps[k], data)
    launches = {"gather_pages": 0, "scatter_pages": 0}
    rows = []
    for n in LINK_SIZES:
        secs = {f"{k} {d}": [] for k in tensors for d in ("out", "in")}
        for rep in range(MESH_REPEATS + 1):
            for k, aq in tensors.items():
                sel = lps[k][:n]
                for d in ("out", "in"):
                    if k == "mesh":
                        t, moved, launched = mesh_move(torch, aq, dom,
                                                       d == "out", sel)
                        for key in launches:
                            launches[key] += launched[key]
                    else:
                        t, moved, launched = link_move(torch, aq,
                                                       f"slab {d}", sel)
                    check_link_move(f"slab {d}", n, page_bytes, moved,
                                    launched)
                    if rep:
                        secs[f"{k} {d}"].append(t)
                if not torch.equal(aq.read(sel), data[:n]):
                    raise AssertionError(f"mesh legs: {k} round trip of {n} "
                                         f"pages not bit-identical")
        med = {leg: float(np.median(v)) for leg, v in secs.items()}
        rows.append(dict(pages=n, bytes=n * page_bytes,
                         **{k.replace(" ", "_") + "_s": v
                            for k, v in med.items()}))
        print(f"mesh legs: {n} pages, {n * page_bytes} B; median of "
              f"{MESH_REPEATS} moves (ms): "
              + "; ".join(f"{k} {1e3 * v:.4f}" for k, v in med.items())
              + f"; mesh/slab out {med['mesh out'] / med['slab out']:.3f} "
              f"in {med['mesh in'] / med['slab in']:.3f}; on {card}")
    fitted = dom.calibrated_profile(H100_SXM)
    samples = dom.samples["fabric"]
    if fitted is H100_SXM:
        raise AssertionError(f"mesh legs: {len(samples)} samples gave no fit")
    xs = np.asarray([x for x, _ in samples])
    ys = np.asarray([y for _, y in samples])
    link = fitted.fabric
    err = np.abs(link.latency + xs / link.peak_bw - ys) / ys
    print(f"mesh legs: {dom.collectives} legs on the wire, "
          f"{len(samples)} warm samples (the first of each bucket unsampled)"
          f"; calibrated_profile(H100_SXM) -> {fitted.name}: fabric peak_bw "
          f"{link.peak_bw:.6e} B/s, latency {link.latency:.6e} s (datasheet "
          f"{H100_SXM.fabric.peak_bw:.6e} B/s, {H100_SXM.fabric.latency:.1e}"
          f" s); fit error median {np.median(err):.4f} max {err.max():.4f}; "
          f"launches {json.dumps(launches)}; on {card}")
    print(f"mesh legs record: {json.dumps(dict(card=card, rows=rows))}")
    del tensors, data
    release(torch)
    return launches, dom


def request_page_digests(torch, kv, rid, weights):
    """Per-page digests of a request's pages on every plane, read off the
    LOCAL pool by plain indexing (no kernel launch, no leg): each page's
    32-bit words times fixed odd weights, summed in int64 (wrapping)."""
    from repro_torch.core.aqua_tensor import LOCAL
    out = {}
    for name, plane in kv.planes.items():
        lps = [int(lp) for lp in plane.flat(rid)]
        rows = plane.aqua.page_table[lps]
        if not (rows[:, 0] == LOCAL).all():
            raise AssertionError(f"mesh engine: request {rid}'s {name} "
                                 f"pages are not resident at its end")
        pages = plane.aqua.local_pool[torch.as_tensor(rows[:, 1],
                                                      device=kv.device)]
        words = pages.contiguous().view(len(lps), -1).view(torch.int32)
        w = weights[: words.shape[1]]
        out[name] = (words.long() * w).sum(dim=1).cpu()
    return out


def mesh_engine_run(torch, np, cfg, model, dev, mesh, hw, weights):
    """Phase 74's serve of ``MESH_ENGINE_REQUESTS`` requests on a 4 GiB
    lease (CFS, REMOTE offload, ``audit=True``), over ``mesh`` when given,
    priced on ``hw``; each request's pages digested as it retires.
    Returns (engine, runtime, requests, step seconds, launches, digests)."""
    from repro_torch.kernels import build
    eng, kv, reqs = make_engine(np, cfg, model, dev,
                                host_pages=PLACER_HOST_PAGES,
                                lease_bytes=MESH_ENGINE_LEASE, audit=True,
                                n_req=MESH_ENGINE_REQUESTS, mesh=mesh, hw=hw)
    kv.meter.hw = hw                # the runtime's meter prices the legs
    digests = {}
    plain_release = kv.release

    def release_digested(rid):
        digests[rid] = request_page_digests(torch, kv, rid, weights)
        plain_release(rid)
    kv.release = release_digested
    torch.cuda.synchronize()
    build.reset_launch_counts()
    step_s = []
    while (eng.waiting or eng.running) and len(step_s) < 5000:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = build.launch_counts()
    m = eng.metrics
    if len(eng.finished) != len(reqs) or eng.auditor.audits != m.steps \
            or not (m.preemptions > 0 and m.restores > 0):
        raise AssertionError(f"mesh engine: {len(eng.finished)} of "
                             f"{len(reqs)} finished, {eng.auditor.audits} "
                             f"audits in {m.steps} steps, preemptions "
                             f"{m.preemptions} restores {m.restores}")
    return eng, kv, reqs, step_s, launches, digests


def phase_mesh_engine(torch, np, dev, card, dom):
    """Phase 80: phase 74's aqua-llama2-13b serve at full width and depth,
    run twice: without a mesh, and over phase 79's domain ``dom`` on the
    H100_SXM datasheet clock, after which ``calibrate_clock()`` fits the
    domain's link. The engine's own legs all fall in one bucket (a parked
    request's ~1,700 pages: 2,048), and a line needs two sizes, so the fit
    reads them beside phase 79's legs over the same domain at 1-2,048
    pages. The mesh run's greedy tokens and every request's final pages
    (digested as it retires) equal the plain run's; its legs on the wire
    equal its meter's fabric messages; ``calibrate_clock()`` returns True
    and installs the fitted link in ``eng.hw`` and the meter. Prints each
    run's step p50 and the simulated TTFT p50 (read relative only).
    Returns {path: launches}."""
    from repro_torch.configs import get_config
    from repro_torch.core.perfmodel import H100_SXM
    cfg = get_config("aqua-llama2-13b")
    model = phase_dense_model(torch, cfg, 17, 13_015_859_200)
    gw = torch.Generator(device="cpu").manual_seed(80)
    page_words = 2 * cfg.n_kv_heads * 16 * cfg.resolved_head_dim * torch.empty(
        (), dtype=cfg.torch_compute_dtype()).element_size() // 4
    weights = (torch.randint(1, 2 ** 62, (page_words,), generator=gw)
               | 1).to(dev)
    runs, launches = {}, {}
    legs0, samples0 = dom.collectives, len(dom.samples["fabric"])
    for label in ("no mesh", "mesh"):
        mesh = dom if label == "mesh" else None
        eng, kv, reqs, step_s, counts, digests = mesh_engine_run(
            torch, np, cfg, model, dev, mesh, H100_SXM, weights)
        m, meter = eng.metrics, kv.meter
        runs[label] = dict(
            tokens=[list(r.generated) for r in reqs], digests=digests,
            step_p50_ms=1e3 * float(np.percentile(step_s, 50)),
            ttft_p50_s=m.ttft_quantile(0.5), steps=m.steps)
        print(f"mesh engine: {label}: {len(reqs)} requests, {m.steps} steps, "
              f"step p50 {runs[label]['step_p50_ms']:.3f} ms, p99 "
              f"{1e3 * float(np.percentile(step_s, 99)):.3f} ms; simulated "
              f"TTFT p50 {runs[label]['ttft_p50_s']:.6f} s on {eng.hw.name}; "
              f"preemptions {m.preemptions} restores {m.restores}; fabric "
              f"{meter.messages_fabric} messages {meter.bytes_fabric:.0f} B"
              + (f"; legs on the wire {mesh.collectives - legs0}, warm "
                 f"samples {len(mesh.samples['fabric']) - samples0}"
                 if mesh else "")
              + f"; launches {json.dumps(counts, sort_keys=True)}; on {card}")
        if mesh is not None:
            legs = mesh.collectives - legs0
            if legs != meter.messages_fabric:
                raise AssertionError(f"mesh engine: {legs} legs "
                                     f"!= {meter.messages_fabric} priced "
                                     f"fabric messages")
            if not all(counts.get(k, 0) > 0 for k in ENGINE_ROWS):
                raise AssertionError(f"mesh engine: the run never launched "
                                     f"some of {list(ENGINE_ROWS)}")
            base = runs["no mesh"]
            if runs[label]["tokens"] != base["tokens"]:
                raise AssertionError(f"mesh engine: {label} tokens differ "
                                     f"from the run without a mesh")
            for rid, per_plane in base["digests"].items():
                got = runs[label]["digests"].get(rid)
                if got is None or any(not torch.equal(got[k], v)
                                      for k, v in per_plane.items()):
                    raise AssertionError(f"mesh engine: request {rid}'s "
                                         f"final pages differ ({label})")
        if label == "mesh":
            launches["mesh engine"] = counts
            if not eng.calibrate_clock():
                raise AssertionError("mesh engine: calibrate_clock() gave "
                                     "no fit")
            calibrated = eng.hw
            sizes = sorted({int(b) for b, _ in
                            dom.samples["fabric"][samples0:]})
            print(f"mesh engine: the fit read {len(dom.samples['fabric'])} "
                  f"samples: {samples0} of phase 79's legs, "
                  f"{len(dom.samples['fabric']) - samples0} of this run's "
                  f"(sizes {sizes} B)")
            if not (calibrated.name == f"{H100_SXM.name}-calibrated"
                    and kv.meter.hw is calibrated
                    and calibrated.fabric != H100_SXM.fabric):
                raise AssertionError("mesh engine: the fitted link is not "
                                     "installed in eng.hw and the meter")
            print(f"mesh engine: calibrate_clock() True -> {calibrated.name}"
                  f": fabric peak_bw {calibrated.fabric.peak_bw:.6e} B/s, "
                  f"latency {calibrated.fabric.latency:.6e} s (datasheet "
                  f"{H100_SXM.fabric.peak_bw:.6e} B/s, "
                  f"{H100_SXM.fabric.latency:.1e} s); installed in eng.hw "
                  f"and the meter")
        del eng, kv, reqs, mesh
        release(torch)
    print(f"mesh engine: step p50 ms no mesh "
          f"{runs['no mesh']['step_p50_ms']:.3f}, mesh "
          f"{runs['mesh']['step_p50_ms']:.3f}; simulated TTFT p50 s "
          f"{runs['no mesh']['ttft_p50_s']:.6f} / "
          f"{runs['mesh']['ttft_p50_s']:.6f}; tokens and final pages equal "
          f"in both runs; on {card}")
    del model
    release(torch)
    return launches


def phase_grad_allreduce(torch, np, dev, card):
    """Phase 81: ``compressed_psum`` over seeded float32 gradients at every
    parameter shape of qwen1.5-0.5b (full width), on an NCCL group of
    world size 1 built from a ``HashStore`` (no socket), for two rounds of
    error feedback: every mean and error buffer bit-equal to
    ``decompress(compress(g, err))`` on the card and to the same call on
    CPU copies. Prints ms a tree (CUDA events, the second round) and the
    bytes an all-reduce moves. Then ``reshard_for_mesh`` of the model's
    host-resident parameters onto ``make_debug_mesh(1)``, bytes a device
    and every leaf equal to its host copy."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.training import compression
    from repro_torch.training.elastic import reshard_for_mesh
    cfg = get_config("qwen1.5-0.5b")
    host_model = lm.LM(cfg, torch.device("cpu"))
    shapes = {n: tuple(p.shape) for n, p in host_model.named_parameters()}
    n_el = sum(int(np.prod(s)) for s in shapes.values())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    g = torch.Generator(device=dev).manual_seed(81)
    grads = {n: torch.randn(s, generator=g, device=dev) * 1e-3
             for n, s in shapes.items()}
    errs = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
    errs_cpu = {n: torch.zeros(s) for n, s in shapes.items()}

    def bits(t):
        return t.contiguous().view(torch.int32)
    ms = []
    for rnd in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = {n: compression.compressed_psum(grads[n], errs[n])
               for n in shapes}
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        for n in shapes:
            comp, want_err = compression.compress(grads[n], errs[n])
            comp_c, errs_cpu[n] = compression.compress(grads[n].cpu(),
                                                       errs_cpu[n])
            mean, new_err = out[n]
            if not (torch.equal(bits(mean),
                                bits(compression.decompress(comp)))
                    and torch.equal(bits(new_err), bits(want_err))
                    and torch.equal(bits(mean).cpu(), bits(
                        compression.decompress(comp_c)))
                    and torch.equal(bits(new_err).cpu(),
                                    bits(errs_cpu[n]))):
                raise AssertionError(f"grad all-reduce: {n} round {rnd} is "
                                     f"not bit-equal to compress/decompress")
            errs[n] = new_err
    dist.destroy_process_group()
    print(f"grad all-reduce: qwen1.5-0.5b, {len(shapes)} tensors, {n_el:,} "
          f"elements; compressed_psum a tree {ms[1]:.3f} ms (first round "
          f"{ms[0]:.3f} ms, NCCL world size 1); an all-reduce moves the "
          f"int32 sum, {4 * n_el:,} B, as a float32 one would ({4 * n_el:,} "
          f"B); the int8 payload is {n_el:,} B; bit-equal to "
          f"decompress(compress()) on the card and on CPU copies; on {card}")
    del grads, errs, errs_cpu, out
    mesh = make_debug_mesh(1)
    rules = ShardingRules(mesh, cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    placed = reshard_for_mesh(host_model, mesh, rules.param_spec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    per_dev = {}
    for n, p in host_model.named_parameters():
        leaf = placed[n]
        if leaf.device != mesh.devices.flat[0] or not torch.equal(
                leaf.cpu(), p.detach()):
            raise AssertionError(f"reshard: {n} not placed on the card")
        per_dev[str(leaf.device)] = per_dev.get(str(leaf.device), 0) + \
            leaf.numel() * leaf.element_size()
    sharded = sum(1 for n in shapes
                  if any(e is not None for e in rules.param_spec(
                      n, host_model.get_parameter(n))))
    print(f"reshard: qwen1.5-0.5b's {len(shapes)} host-resident parameters "
          f"onto make_debug_mesh(1) in {secs:.3f} s; bytes a device "
          f"{json.dumps(per_dev)}; {sharded} leaves carry a spec over a "
          f"size-1 axis; on {card}")
    del placed, host_model
    release(torch)


def mesh_phases(torch, np, dev, card, t0):
    """Phases 79-81: the mesh tier legs, the engine over the domain with
    its clock calibrated, and the int8 gradient all-reduce with the
    placement of a restored model. Returns {path: launch counts}."""
    lap, done = model_laps(torch, "mesh legs, mesh engine, grad all-reduce",
                           t0)
    leg_launches, dom = phase_mesh_legs(torch, np, dev, card)
    lap("mesh tier legs")
    paths = {"mesh tier legs": leg_launches}
    paths.update(phase_mesh_engine(torch, np, dev, card, dom))
    del dom
    lap("mesh engine")
    phase_grad_allreduce(torch, np, dev, card)
    lap("grad all-reduce")
    done()
    return paths


ROOFLINE_CELLS = (("qwen1.5-0.5b", "train_4k", 4),
                  ("qwen1.5-0.5b", "prefill_32k", 1),
                  ("qwen1.5-0.5b", "decode_32k", 8),
                  ("rwkv6-3b", "long_500k", 1))
ROOFLINE_WARMUP, ROOFLINE_RUNS = 2, 5
ROOFLINE_SLACK = 1.05               # a bound above 1.05 x p50: a wrong count
DRYRUN_ROWS = ("qwen1.5-0.5b", "rwkv6-3b")   # the whole dry run: > 120 s


def roofline_args(cfg, shape, B, args, model, seed, dev):
    """The cell's step arguments on the card, in ``build_cell``'s order:
    ``model`` for the meta model, AdamW's state from ``adamw_init``
    (train), a zeroed cache from ``init_decode_state`` (serving), every
    other input from ``api.instantiate`` (the reference's draws), on
    ``dev``."""
    from repro_torch.models import api
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import trainable_params
    if shape.kind == "train":
        return (model, adamw_init(trainable_params(model),
                                  AdamWConfig(lr=3e-4)),
                api.instantiate(args[2], seed, dev))
    cache = api.init_decode_state(cfg, B, shape.seq_len, device=dev)
    if shape.kind == "prefill":
        return (model, api.instantiate(args[1], seed, dev), cache,
                api.instantiate(args[3], seed + 1, dev))
    return (model, cache, api.instantiate(args[2], seed, dev),
            api.instantiate(args[3], seed + 1, dev))


def roofline_cell(torch, np, arch, shape_name, B, model, card):
    """One cell of phase 82: traced on meta at batch ``B``, then run on the
    card with ``model`` 2 + 5 times. Fails when the larger roofline term
    exceeds ``ROOFLINE_SLACK`` x the p50 or a kernel's launches differ
    from the trace's entries x 7. Returns (the cell's row, its launch
    counts)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig, get_config
    from repro_torch.core.perfmodel import H100_SXM
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_placeholder_mesh
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    t0 = time.perf_counter()
    fn, args, mem = dryrun.build_cell(arch, shape_name,
                                      make_placeholder_mesh("h100"),
                                      batch_override=B)
    trace = dryrun.trace_cell(fn, args)
    cost, temp = trace.cost(), trace.peak_bytes
    calls = roofline.kernel_calls(trace.records.values())
    t_trace = time.perf_counter() - t0
    real = roofline_args(cfg, shape, B, args, model, 82, "cuda")
    del args, trace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    for _ in range(ROOFLINE_WARMUP):
        fn(*real)
    ms = []
    for _ in range(ROOFLINE_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*real)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del real
    release(torch)
    runs = ROOFLINE_WARMUP + ROOFLINE_RUNS
    p50_s = float(np.percentile(ms, 50)) / 1e3
    rl = roofline.roofline_from_cost(
        cost, model_flops_per_device=roofline.model_flops(
            cfg, ShapeConfig(shape.name, shape.seq_len, B, shape.kind)),
        hw=H100_SXM)
    row = dict(arch=arch, shape=shape_name, batch=B, p50_ms=p50_s * 1e3,
               ms=ms, t_compute_ms=rl.t_compute * 1e3,
               t_memory_ms=rl.t_memory * 1e3, bottleneck=rl.bottleneck,
               flop_share=cost.flops / p50_s / H100_SXM.flops_peak,
               hbm_share=cost.bytes / p50_s / H100_SXM.hbm_bw,
               flops=cost.flops, bytes=cost.bytes,
               model_flops=rl.model_flops,
               args_gib=mem["argument_size_in_bytes"] / 2 ** 30,
               temp_gib=temp / 2 ** 30, peak_gib=peak / 2 ** 30,
               kernel_entries=dict(calls), launches=launches,
               trace_s=t_trace)
    print(f"roofline: {arch} {shape_name} B {B}: p50 {row['p50_ms']:.3f} "
          f"ms (runs {[round(x, 3) for x in ms]} ms after {ROOFLINE_WARMUP} "
          f"warm-up); t_compute {row['t_compute_ms']:.4f} ms, t_memory "
          f"{row['t_memory_ms']:.4f} ms, bottleneck {rl.bottleneck}; "
          f"achieved {row['flop_share']:.4f} of 989 TFLOP/s, "
          f"{row['hbm_share']:.4f} of 3.35 TB/s; trace FLOP "
          f"{cost.flops:.6e} (model FLOP {rl.model_flops:.6e}), bytes "
          f"{cost.bytes:.6e}; args + temp {row['args_gib']:.2f} + "
          f"{row['temp_gib']:.2f} GiB, max_memory_allocated "
          f"{row['peak_gib']:.2f} GiB; kernel entries {dict(calls)} x "
          f"{runs} runs, launches {launches}; traced in {t_trace:.1f} s; on "
          f"{card}")
    bound_s = max(rl.t_compute, rl.t_memory)
    if bound_s > ROOFLINE_SLACK * p50_s:
        raise AssertionError(f"roofline: {arch} {shape_name}: the bound "
                             f"{bound_s * 1e3:.4f} ms exceeds "
                             f"{ROOFLINE_SLACK} x the p50 "
                             f"{p50_s * 1e3:.4f} ms: the count is wrong")
    want = {k: v * runs for k, v in calls.items()}
    if launches != want:
        raise AssertionError(f"roofline: {arch} {shape_name}: launches "
                             f"{launches} != the trace's kernel entries x "
                             f"{runs} {want}")
    return row, launches


def dryrun_rows(archs):
    """The dry run's rows of ``archs`` on the ``h100`` mesh into a
    temporary directory -> (``report.summarize`` of them, seconds): phase
    82 runs it in a worker process while the card runs its cells."""
    import tempfile
    from repro_torch.analysis import report
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        for arch in archs:
            dryrun.main(["--mesh", "h100", "--arch", arch, "--out", out])
        return report.summarize(out), time.perf_counter() - t


def phase_roofline(torch, np, dev, card):
    """Phase 82: ``ROOFLINE_CELLS`` traced and run (``roofline_cell``),
    while the dry run's ``DRYRUN_ROWS`` on the ``h100`` mesh go into a
    temporary directory in a spawned worker process (``dryrun_rows``),
    then ``report.summarize`` of them. Returns {path: launches}."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    paths, rows, model, built = {}, [], None, None
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        dry = pool.submit(dryrun_rows, DRYRUN_ROWS)
        for arch, shape_name, B in ROOFLINE_CELLS:
            if built != arch:
                del model
                release(torch)
                gen = torch.Generator(device="cuda").manual_seed(82)
                model, built = lm.init_params(get_config(arch), gen,
                                              dev), arch
            row, launches = roofline_cell(torch, np, arch, shape_name, B,
                                          model, card)
            rows.append(row)
            paths[f"roofline {arch} {shape_name}"] = launches
        del model
        release(torch)
        print("roofline cells: " + json.dumps(
            [{k: v for k, v in r.items() if k != "ms"} for r in rows]))
        t = time.perf_counter()
        summary, seconds = dry.result()
    print(summary)
    print(f"dry run of the {list(DRYRUN_ROWS)} rows on the h100 mesh: "
          f"{seconds:.1f} s (host, in a worker process beside the cells; "
          f"{time.perf_counter() - t:.1f} s waited for after them)")
    return paths


# -- the partitioned serving step ---------------------------------------------
# (a) at world size 1 on NCCL: (arch, layers or 0 for all, batch, prompt,
# decode steps, FSDP)
PARTITION_RUNS = (("qwen1.5-0.5b", 0, 2, 2048, 16, False),
                  ("dbrx-132b", DBRX_LAYERS, 2, 512, 8, True),
                  # one dense and three MoE layers
                  ("deepseek-v2-lite-16b", 4, 2, 512, 8, False),
                  # one group: attention, Mamba, MoE
                  ("jamba-v0.1-52b", 8, 2, 512, 8, True),
                  ("rwkv6-3b", 0, 2, 512, 8, False),
                  # over 1,500 frames
                  ("whisper-tiny", 0, 2, 512, 8, False))
# the kernels each world-1 run must launch (besides launching what the
# unpartitioned run launches)
PARTITION_RUN_KERNELS = {"qwen1.5-0.5b": ("flash_attention",),
                         "dbrx-132b": ("flash_attention",),
                         "deepseek-v2-lite-16b": (),
                         "jamba-v0.1-52b": ("flash_attention",),
                         "rwkv6-3b": ("wkv6",),
                         "whisper-tiny": ("flash_attention",)}
# (b) rank 0 of pod256 at its own shapes under a fake group: (arch, shape,
# layers or 0 for all)
PARTITION_CELLS = (("qwen1.5-0.5b", "decode_32k", 0),
                   ("qwen1.5-0.5b", "prefill_32k", 0),
                   ("dbrx-132b", "decode_32k", DBRX_LAYERS),
                   ("deepseek-v2-lite-16b", "decode_32k", 4),
                   ("jamba-v0.1-52b", "decode_32k", 8),
                   ("rwkv6-3b", "long_500k", 0),
                   ("whisper-tiny", "decode_32k", 0))
PARTITION_MESH = "pod256"
PARTITION_MEM_SLACK = 0.05          # max_memory_allocated vs args + temp
# row 9 at the shapes the partitioned prefills give it: a rank of pod256
# in qwen1.5-0.5b's prefill_32k (its 2 rows of the batch, one head on one
# kv head), and dbrx-132b's world-1 prefill of (a) (2 x 512, 48 heads on 8)
PARTITION_FLASH = {
    "qwen1.5-0.5b pod256 rank prefill":
        ((2, 32768, 32768, 1, 1, 64, True, 0), False),
    "dbrx-132b world 1 prefill":
        ((2, 512, 512, 48, 8, 128, True, 0), False),
    # whisper-tiny on a rank of pod256: the one head its 24 wo rows touch,
    # its prefill_32k rows' encoder over 1,500 frames and its decode_32k
    # rows' cross-attention against them
    "whisper-tiny pod256 rank encoder":
        ((2, 1500, 1500, 1, 1, 64, False, 0), False),
    "whisper-tiny pod256 rank cross decode":
        ((8, 1, 1500, 1, 1, 64, False, 0), False)}
# the key-slice WKV (rwkv6-3b on a rank of pod256: 4 of each head's 64 key
# rows) at its prefill_32k and decode_32k rows: (B, T, H, K, V)
PARTITION_WKV = {"prefill": (2, 32768, 40, 4, 64),
                 "decode": (8, 1, 40, 4, 64)}
WKV_KEYSLICE_SRC = "src/repro_torch/csrc/wkv6_keyslice.cu"


def greedy_run(torch, np, api, model, cfg, tokens, steps, dev, **kw):
    """``api.prefill`` of ``tokens`` (with ``kw["prefill_kw"]``, an
    encoder-decoder's frames) into a fresh cache (sharded through
    ``kw["shard_cache"]`` when given), then ``steps`` greedy
    ``api.decode_step``s -> (every step's logits, the greedy tokens)."""
    shard = kw.pop("shard_cache", lambda c: c)
    extra = kw.pop("prefill_kw", {})
    B, T = tokens.shape
    cache = shard(api.init_decode_state(cfg, B, T + steps, device=dev))
    logits, cache = api.prefill(model, cfg, tokens, cache, **extra, **kw)
    outs, toks = [logits], [logits.argmax(-1)]
    for s in range(steps):
        logits, cache = api.decode_step(model, cfg, cache, toks[-1],
                                        np.full(B, T + s), **kw)
        outs.append(logits)
        toks.append(logits.argmax(-1))
    return outs, torch.stack(toks)


def partition_world1(torch, np, run, dev, card):
    """Phase 83(a), one config: the partitioned step on a (1, 1, 1) mesh
    over the NCCL group of world size 1 (every collective a group of one)
    against the unpartitioned step on the same weights: greedy tokens
    equal and every step's logits equal bit for bit (phases 69-70's rule
    for the dense cache), the same kernel launches as the unpartitioned
    run, those of ``PARTITION_RUN_KERNELS`` among them (a dense or MoE
    config's flash launches one a layer). Returns the partitioned run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh, rank_context
    from repro_torch.models import api
    arch, layers, B, T, steps, fsdp = run
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(83)
    model = api.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=dev)
    extra = {}
    if cfg.encdec is not None:
        extra["prefill_kw"] = {"enc_embeds": torch.randn(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model), generator=gen,
            device=dev).to(cfg.torch_compute_dtype())}
    mesh = Mesh(np.full((1, 1, 1), str(dev), dtype=object),
                ("pod", "data", "model"))
    rank = rank_context(mesh, device=dev)
    rules = ShardingRules(mesh, cfg, fsdp=fsdp)
    build.reset_launch_counts()
    t = time.perf_counter()
    want, want_tok = greedy_run(torch, np, api, model, cfg, tokens, steps,
                                dev, **dict(extra))
    _sync(torch, dev)
    t_plain = time.perf_counter() - t
    plain_launches = build.launch_counts()
    local = partition.shard_model(model, rules, rank)
    build.reset_launch_counts()
    t = time.perf_counter()
    got, got_tok = greedy_run(
        torch, np, api, local, cfg, tokens, steps, dev,
        shard_axes={"dp": rules.dp, "tp": "model", "mesh": mesh,
                    "ctx": rank},
        shard_cache=lambda c: partition.shard_cache(c, rules, rank, B),
        **dict(extra))
    _sync(torch, dev)
    t_part = time.perf_counter() - t
    launches = build.launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    worst = max(float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want))
    held = {n: p.data_ptr() == model.get_parameter(n).data_ptr()
            for n, p in local.named_parameters()}
    print(f"partition world 1: {arch} ({cfg.n_layers} layers, FSDP "
          f"{fsdp}), prefill {B} x {T} + {steps} greedy steps: tokens equal "
          f"{torch.equal(got_tok, want_tok)}, logits bit-equal {same} "
          f"(largest relative difference {worst:.3g}); launches {launches} "
          f"(unpartitioned {plain_launches}); {sum(held.values())} of "
          f"{len(held)} shards share the model's storage; partitioned "
          f"{t_part:.2f} s, unpartitioned {t_plain:.2f} s (host wall); on "
          f"{card}")
    need = PARTITION_RUN_KERNELS[arch]
    flash = launches.get("flash_attention", 0)
    per_layer = cfg.family in ("dense", "moe") and cfg.mla is None
    if not (same and torch.equal(got_tok, want_tok) and all(held.values())
            and launches == plain_launches
            and all(launches.get(k, 0) > 0 for k in need)
            and (flash == cfg.n_layers or not per_layer)):
        raise AssertionError(f"partition world 1: {arch}: tokens equal "
                             f"{torch.equal(got_tok, want_tok)}, logits "
                             f"bit-equal {same}, launches {launches} vs "
                             f"unpartitioned {plain_launches} (needs "
                             f"{list(need)}), {flash} flash launches for "
                             f"{cfg.n_layers} layers")
    del model, local, want, got
    release(torch)
    return launches


def trace_summary(fn, args):
    """``dryrun.trace_cell`` of a cell's step -> (its traced cost, peak
    temporary bytes, kernel entries by name, row 9's (q, k) signatures)."""
    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun
    trace = dryrun.trace_cell(fn, args)
    flash = sorted({json.dumps(r["ins"][:2]) for r in trace.records.values()
                    if r.get("kernel") == "flash_attention"})
    return (trace.cost(), trace.peak_bytes,
            dict(roofline.kernel_calls(trace.records.values())), flash)


def traced_partition_cell(arch, shape_name, layers):
    """``trace_summary`` of rank 0's step in a ``PARTITION_MESH`` cell,
    under a fake group of its own: phase 84 runs it in a worker process
    while the card runs (a) -> the summary and its seconds."""
    from repro_torch.distributed import partition
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_placeholder_mesh
    t0 = time.perf_counter()
    mesh = make_placeholder_mesh(PARTITION_MESH)
    with partition.fake_world(int(mesh.devices.size)):
        fn, args, _ = dryrun.build_cell(
            arch, shape_name, mesh,
            overrides={"n_layers": layers} if layers else None)
        out = trace_summary(fn, args)
    return out + (time.perf_counter() - t0,)


def partition_cell(torch, np, arch, shape_name, layers, card,
                   warmup=ROOFLINE_WARMUP, timed=ROOFLINE_RUNS, traced=None):
    """Phase 83(b) and 84(b), one cell: rank 0 of ``PARTITION_MESH`` at
    its own shapes, under the fake group of the mesh's size (its
    collectives move no bytes and return garbage: values are not checked).
    Traced on meta (``trace_summary``, or ``traced``: the summary and
    seconds ``traced_partition_cell`` returned; row 9's entries' shapes
    printed), then run on the card ``warmup`` + ``timed`` times on
    instantiated shards (a zeroed cache; a train cell's AdamW
    state from ``adamw_init``, each run a step that updates it): the p50
    beside the per-device bound, launches equal to the trace's entries x
    the runs, and ``max_memory_allocated``, less what earlier phases still
    hold, within ``PARTITION_MEM_SLACK`` of the trace's args + temp.
    Returns (the cell's row, its launches)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig, get_config
    from repro_torch.core.perfmodel import H100_SXM
    from repro_torch.distributed import partition
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_placeholder_mesh
    from repro_torch.models import api
    mesh = make_placeholder_mesh(PARTITION_MESH)
    world = int(mesh.devices.size)
    over = {"n_layers": layers} if layers else None
    cfg = get_config(arch).replace(**(over or {}))
    shape = SHAPES_BY_NAME[shape_name]
    t0 = time.perf_counter()
    fn, args, mem = dryrun.build_cell(arch, shape_name, mesh, overrides=over)
    if traced is None:
        cost, temp, calls, flash_shapes = trace_summary(fn, args)
        t_trace = time.perf_counter() - t0
    else:
        cost, temp, calls, flash_shapes, t_trace = traced
    dev = torch.device("cuda")
    release(torch)
    base = torch.cuda.memory_allocated()      # what earlier phases hold
    if shape.kind == "train":
        from repro_torch.training.optimizer import AdamWConfig, adamw_init
        from repro_torch.training.train_loop import trainable_params
        model = api.instantiate(args[0], 83, dev)
        real = (model, adamw_init(trainable_params(model),
                                  AdamWConfig(lr=3e-4)),
                api.instantiate(args[2], 84, dev))
        del model
    elif shape.kind == "prefill":
        real = (api.instantiate(args[0], 83, dev),
                api.instantiate(args[1], 84, dev),
                partition.materialize(args[2], dev),
                api.instantiate(args[3], 85, dev))
    else:
        real = (api.instantiate(args[0], 83, dev),
                partition.materialize(args[1], dev),
                api.instantiate(args[2], 84, dev),
                api.instantiate(args[3], 85, dev))
    held = sum(t.numel() * t.element_size()
               for t in api.tree_leaves([list(real[0].parameters())]
                                        + list(real[1:]))
               if isinstance(t, torch.Tensor))      # AdamW's step is an int
    del args
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    for _ in range(warmup):
        fn(*real)
    ms = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*real)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    del real, fn
    release(torch)
    runs = warmup + timed
    p50_s = float(np.percentile(ms, 50)) / 1e3
    local = ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                        shape.kind)
    rl = roofline.roofline_from_cost(
        cost, model_flops_per_device=roofline.model_flops(cfg, local)
        / world, hw=H100_SXM)
    bound_s = max(rl.t_compute, rl.t_memory)
    args_b = mem["argument_size_in_bytes"]
    row = dict(arch=arch, shape=shape_name, layers=cfg.n_layers,
               mesh=PARTITION_MESH, p50_ms=p50_s * 1e3, ms=ms,
               bound_ms=bound_s * 1e3, t_compute_ms=rl.t_compute * 1e3,
               t_memory_ms=rl.t_memory * 1e3,
               t_collective_ms=rl.t_collective * 1e3,
               bottleneck=rl.bottleneck, flops=cost.flops, bytes=cost.bytes,
               coll_bytes=cost.coll_bytes, coll_ops=cost.coll_counts,
               args_gib=args_b / 2 ** 30, temp_gib=temp / 2 ** 30,
               peak_gib=peak / 2 ** 30, held_gib=base / 2 ** 30,
               kernel_entries=dict(calls), flash_shapes=flash_shapes,
               launches=launches, trace_s=t_trace)
    print(f"partition cell: {arch} {shape_name} ({cfg.n_layers} layers), "
          f"rank 0 of {PARTITION_MESH}, the rank's local work with no wire "
          f"(fake group): p50 {row['p50_ms']:.3f} ms (runs "
          f"{[round(x, 3) for x in ms]} ms after {warmup} "
          f"warm-up) beside the per-device traced bound "
          f"{row['bound_ms']:.4f} ms (t_compute {row['t_compute_ms']:.4f}, "
          f"t_memory {row['t_memory_ms']:.4f}; collectives "
          f"{cost.coll_counts}, {cost.coll_bytes:,.0f} B, "
          f"{row['t_collective_ms']:.4f} ms at the fabric's rate); args + "
          f"temp {row['args_gib']:.3f} + {row['temp_gib']:.3f} GiB vs "
          f"max_memory_allocated {row['peak_gib']:.3f} GiB above the "
          f"{row['held_gib']:.3f} GiB held before the cell; kernel entries "
          f"{dict(calls)} x {runs} runs (row 9's (q, k) "
          f"{[json.loads(x) for x in flash_shapes]}), launches {launches}; "
          f"traced in "
          f"{t_trace:.1f} s; on {card}")
    want = {k: v * runs for k, v in calls.items()}
    if launches != want:
        raise AssertionError(f"partition cell: {arch} {shape_name}: "
                             f"launches {launches} != the trace's entries x "
                             f"{runs} {want}")
    if held != args_b:
        raise AssertionError(f"partition cell: {arch} {shape_name}: the "
                             f"shards hold {held} B, the record {args_b}")
    if abs(peak - (args_b + temp)) > PARTITION_MEM_SLACK * (args_b + temp):
        raise AssertionError(f"partition cell: {arch} {shape_name}: "
                             f"max_memory_allocated less what was held "
                             f"before, {peak} B, not within "
                             f"{PARTITION_MEM_SLACK} of args + temp "
                             f"{args_b + temp} B")
    return row, launches


def keyslice_inputs(torch, g, shape, wmax, dev):
    """``wkv_inputs``' distributions at a key slice's shapes: r, k (B, T,
    H, K) and v (B, T, H, V) in bf16, w in [-wmax, -1e-3], u (H, K), the
    state slice (B, H, K, V) 0.1 x normal."""
    B, T, H, K, V = shape
    r, k = (torch.randn((B, T, H, K), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((B, T, H, V), generator=g, device=dev).to(torch.bfloat16)
    w = -(torch.rand((B, T, H, K), generator=g, device=dev)
          * (wmax - 1e-3) + 1e-3)
    u = torch.randn((H, K), generator=g, device=dev)
    s0 = torch.randn((B, H, K, V), generator=g, device=dev) * 0.1
    return r, k, v, w, u, s0


def keyslice_bound(shape, io_bytes):
    """Least time of one key-slice call (``rwkv6_wkv/ops.py:
    keyslice_work``): its bytes over the memory rate against its float32
    operations over 67 TFLOP/s and its exponentials over the
    special-function units. Returns (ms, bound_by, parts)."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    flops, exps, nbytes = wkv_ops.keyslice_work(*shape, io_bytes)
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32": flops / F32_FLOPS * 1e3, "exp": exps / SFU_PER_S * 1e3}
    ms = max(parts.values())
    return ms, "bytes" if parts["bytes"] >= ms else "operations", parts


# the key-slice kernels' passes are each held against their plain twins
# at the chunk-boundary lengths, at each of these key slices (B 2, 8 heads,
# V 64), float32 and bf16, and at the rank shapes
KEYSLICE_PASS_T = (1, 31, 32, 33, 1031)
KEYSLICE_PASS_K = (4, 8, 16)
KEYSLICE_PASS_SHAPES = tuple(((2, T, 8, K, 64), dname)
                             for T in KEYSLICE_PASS_T
                             for K in KEYSLICE_PASS_K
                             for dname in ("float32", "bfloat16"))
# the kernels of a key-slice call, by pass, as the profiler names them
KEYSLICE_KERNELS = {"wkv6_keyslice": {"sums": "sums_kernel",
                                      "scan": "scan_kernel",
                                      "chunk": "fwd_chunk_kernel"},
                    "wkv6_keyslice_bwd": {"sums": "sums_kernel",
                                          "scan": "scan_kernel",
                                          "chunk": "bwd_chunk_kernel"}}


def keyslice_pass_checks(torch, wkv_ops, wkv_ref, g, dev, backward,
                         shapes):
    """Each kernel of the key-slice forward (the chunk sums, the forward
    scan, the forward chunk pass) or, ``backward``, of its backward (the
    chunk sums with Gamma, the scan both ways, the backward chunk pass,
    and its state passes through ``wkv6_keyslice_bwd_states`` /
    ``_dstates``) alone against its plain twin on the twins' own inputs,
    at ``shapes`` (((B, T, H, K, V), dtype name), ...), the decays up to
    ``max(WKV_DECAYS)``: the summaries and chunk states at the state's
    limits (rtol 1e-3, atol 5e-4: their arithmetic is float32 in either
    dtype), the forward chunk pass at row 8's (``wkv_ratio``), the
    backward's at row 8b's (``wkv_bwd_ratio``). A control for each: the
    kernel on an input changed where its output must move beyond the
    limit (the sums: k at the last token and r at the first token of the
    middle chunk zeroed, where no decay hides them; the scans: one
    sequence's initial state and final-state gradient zeroed; the forward
    chunk pass: one sequence's chunk states zeroed; the backward's: dy at
    the middle token zeroed). Returns {kernel: (largest error/limit,
    smallest control/limit)}; raises when an error is beyond its limit or
    a control within it."""
    state_lim = WKV_LIMITS[1]
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    out = {}

    def lim(got, want):
        return max(limit_ratio(a, b, *state_lim) for a, b in zip(got, want))

    def note(name, ratio, control):
        was = out.get(name, (0.0, float("inf")))
        out[name] = (max(was[0], ratio), min(was[1], control))

    for shape, dname in shapes:
        B, T, H, K, V = shape
        dt = dtypes[dname]
        r, k, v, w, u, s0 = keyslice_inputs(torch, g, shape,
                                            max(WKV_DECAYS), dev)
        r, k, v = (x.to(dt) for x in (r, k, v))
        first = T // 2 // 32 * 32
        k0, r0, s0c = k.clone(), r.clone(), s0.clone()
        k0[:, min(T, first + 32) - 1] = 0
        r0[:, first] = 0
        s0c[0] = 0
        if not backward:
            want = wkv_ref.wkv6_keyslice_sums_plain(k, v, w)[:2]
            note("wkv6_keyslice_sums",
                 lim(wkv_ops.wkv6_keyslice_sums(k, v, w)[:2], want),
                 lim(wkv_ops.wkv6_keyslice_sums(k0, v, w)[:2], want))
            d, delta = want
            want = wkv_ref.wkv6_keyslice_scan_plain(d, delta, s0)[:1]
            note("wkv6_keyslice_scan",
                 lim(wkv_ops.wkv6_keyslice_scan(d, delta, s0)[:1], want),
                 lim(wkv_ops.wkv6_keyslice_scan(d, delta, s0c)[:1], want))
            states = want[0].contiguous()
            zeroed = states.clone()
            zeroed[0] = 0
            want = wkv_ref.wkv6_keyslice_chunk_plain(r, k, v, w, u, states)
            note("wkv6_keyslice_chunk",
                 wkv_ratio(wkv_ops.wkv6_keyslice_chunk(r, k, v, w, u,
                                                       states), want),
                 wkv_ratio(wkv_ops.wkv6_keyslice_chunk(r, k, v, w, u,
                                                       zeroed), want))
        else:
            dy = torch.randn((B, T, H, V), generator=g, device=dev).to(dt)
            ds = torch.randn((B, H, K, V), generator=g, device=dev)
            dsc = ds.clone()
            dsc[0] = 0
            dyc = dy.clone()
            dyc[:, T // 2] = 0
            args = (r, k, v, w, u, s0, dy, ds)
            want = wkv_ref.wkv6_keyslice_sums_plain(k, v, w, r, dy)
            note("wkv6_keyslice_bwd_sums",
                 lim(wkv_ops.wkv6_keyslice_sums(k, v, w, r, dy), want),
                 lim(wkv_ops.wkv6_keyslice_sums(k0, v, w, r0, dy), want))
            d, delta, gamma = want
            want = wkv_ref.wkv6_keyslice_scan_plain(d, delta, s0, gamma, ds)
            note("wkv6_keyslice_bwd_scan",
                 lim(wkv_ops.wkv6_keyslice_scan(d, delta, s0, gamma, ds),
                     want),
                 lim(wkv_ops.wkv6_keyslice_scan(d, delta, s0c, gamma, dsc),
                     want))
            states, dstates = want[0].contiguous(), want[1].contiguous()
            note("wkv6_keyslice_bwd_states",
                 lim([wkv_ops.wkv6_keyslice_bwd_states(*args)], [states]),
                 lim([wkv_ops.wkv6_keyslice_bwd_states(*args[:5], s0c,
                                                       *args[6:])],
                     [states]))
            note("wkv6_keyslice_bwd_dstates",
                 lim(wkv_ops.wkv6_keyslice_bwd_dstates(*args), want[1:]),
                 lim(wkv_ops.wkv6_keyslice_bwd_dstates(*args[:7], dsc),
                     want[1:]))
            part = wkv_ref.wkv6_bwd_chunk_plain(r, k, v, w, u, dy, states,
                                                dstates)
            want = list(part[:4]) + [part[4].sum((0, 2))]
            note("wkv6_keyslice_bwd_chunk",
                 wkv_bwd_ratio(torch, wkv_ops.wkv6_keyslice_bwd_chunk(
                     *args[:7], states, dstates), want, dname),
                 wkv_bwd_ratio(torch, wkv_ops.wkv6_keyslice_bwd_chunk(
                     *args[:6], dyc, states, dstates), want, dname))
        del r, k, v, w, u, s0, k0, r0, s0c, want
    torch.cuda.synchronize()
    for name, (ratio, control) in out.items():
        print(f"kernel {name} alone against its plain twin over "
              f"{len(shapes)} shapes: error/limit {ratio:.3g}, control "
              f"{control:.3g}")
        if not ratio <= 1.0 < control:
            raise AssertionError(f"{name}: error/limit {ratio} must be <= "
                                 f"1 and the control's {control} above it")
    return out


def keyslice_info(wkv_ops, backward):
    """Print ``*_info`` of the key-slice forward's or backward's kernels
    (registers, spills, shared bytes, blocks per SM) at K 4, 8, 16 of V
    64; returns them at K 4."""
    fn = (wkv_ops.wkv6_keyslice_bwd_kernel_info if backward
          else wkv_ops.wkv6_keyslice_kernel_info)
    for K in KEYSLICE_PASS_K:
        info = fn(K, 64)
        for name, one in info.items():
            print(f"key-slice kernel K {K} V 64: {name} {json.dumps(one)}")
        if K == 4:
            kept = info
    return kept


def phase_keyslice_wkv(torch, np, report):
    """Phase 83(c): the key-slice WKV kernel (``wkv6_keyslice``) against
    its plain twin (the rectangular ``wkv6_plain``: the chunked form at T
    32,768, the scan at T 1) at rwkv6-3b's pod256 rank shapes
    (``PARTITION_WKV``), weak and strong decays, at row 8's limits
    (``WKV_LIMITS``), a control with one lane's incoming state zeroed
    beyond them. Device times by CUDA events: the kernel queued behind a
    device-side wait; the plain twin at T 32,768 (~15,000 small launches a
    call) back to back, its time the host's launch rate. No PyTorch call
    computes the recurrence: ``library_ms`` is null. Then each kernel of
    the forward alone against its plain twin (``keyslice_pass_checks``) at
    the chunk-boundary lengths and at the prefill shape, with the
    kernels' ``*_info``."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    info = keyslice_info(wkv_ops, backward=False)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(83)
    cases = {}
    for name, shape in PARTITION_WKV.items():
        B, T, H, K, V = shape
        ratios, controls, errs = [], [], []
        for wmax in WKV_DECAYS:
            args = keyslice_inputs(torch, g, shape, wmax, dev)
            got = wkv_ops.wkv6_keyslice(*args)
            s0c = args[5].clone()
            s0c[0] = 0.0
            ctrl = wkv_ops.wkv6_keyslice(*args[:5], s0c)
            plain = wkv_ref.wkv6_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"wkv6_keyslice {name}: not finite")
            ratios.append(wkv_ratio(got, plain))
            controls.append(wkv_ratio(ctrl, plain))
            errs.append((got[0].float() - plain[0].float()).abs().max()
                        .item())
            del got, ctrl, plain
        if T > 1:
            ms = (device_ms(lambda: wkv_ops.wkv6_keyslice(*args), 5)
                  + device_ms(lambda: wkv_ops.wkv6_keyslice(*args), 5)) / 2
            plain_ms = ms_timer(lambda: wkv_ref.wkv6_plain(*args), 1)
        else:
            ms, plain_ms = interleaved(
                lambda: wkv_ref.wkv6_plain(*args),
                lambda: wkv_ops.wkv6_keyslice(*args), 100)
        b, by, parts = keyslice_bound(shape, 2)
        cases[name] = dict(
            shape=f"B={B} T={T} H={H} K={K} V={V} (bf16 r/k/v/y)",
            max_abs_err=max(errs), limit_ratio=max(ratios),
            control_ratio=min(controls), tolerance=(
                "y rtol 2e-2 atol 5e-2, state rtol 1e-3 atol 5e-4"),
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            bound_parts_ms=parts, library_ms=None)
        print(f"kernel wkv6_keyslice {cases[name]['shape']}: error/limit "
              f"{max(ratios):.3g} (vs the plain twin, decays up to "
              f"{max(WKV_DECAYS)}); control (one lane's state zeroed) "
              f"{min(controls):.3g}; max abs y err {max(errs):.3g}; kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b * 1e3:.3f} us "
              f"({by}: bytes {parts['bytes'] * 1e3:.2f}, f32 "
              f"{parts['f32'] * 1e3:.2f}, exp {parts['exp'] * 1e3:.2f} us)")
        if not max(ratios) <= 1.0 < min(controls):
            raise AssertionError(
                f"wkv6_keyslice {name}: error/limit {max(ratios)} must be "
                f"<= 1 and the control's {min(controls)} above it")
        del args
        release(torch)
    passes = keyslice_pass_checks(
        torch, wkv_ops, wkv_ref, g, dev, False,
        KEYSLICE_PASS_SHAPES + ((PARTITION_WKV["prefill"], "bfloat16"),))
    release(torch)
    report.append(dict(
        name="wkv6_keyslice", route="cuda", source=WKV_KEYSLICE_SRC,
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:81",
        **{**cases["prefill"], "max_abs_err": max(c["max_abs_err"]
                                                  for c in cases.values())},
        decode=cases["decode"], passes=passes, info=info))


def phase_partition(torch, np, report, dev, card):
    """Phase 83: (a) ``PARTITION_RUNS`` at world size 1 over NCCL
    (``partition_world1``), (b) ``PARTITION_CELLS`` under a fake group
    (``partition_cell``), then row 9 at a rank's shape
    (``PARTITION_FLASH``, the ``partition`` entry of ``flash_attention``)
    and (c) the key-slice WKV at rwkv6-3b's rank shapes
    (``phase_keyslice_wkv``, its ``wkv6_keyslice`` entry). Returns {path:
    launches}."""
    import torch.distributed as dist
    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import make_placeholder_mesh
    paths = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    for run in PARTITION_RUNS:
        paths[f"partition world 1 {run[0]}"] = partition_world1(
            torch, np, run, dev, card)
    dist.destroy_process_group()
    rows = []
    with partition.fake_world(int(make_placeholder_mesh(
            PARTITION_MESH).devices.size)):
        for arch, shape_name, layers in PARTITION_CELLS:
            row, launches = partition_cell(torch, np, arch, shape_name,
                                           layers, card)
            rows.append(row)
            paths[f"partition {PARTITION_MESH} {arch} {shape_name}"] = \
                launches
    print("partition cells: " + json.dumps(
        [{k: v for k, v in r.items() if k != "ms"} for r in rows]))
    phase_flash_shapes(torch, report, PARTITION_FLASH, "partition", 83)
    phase_keyslice_wkv(torch, np, report)
    release(torch)
    return paths


# -- the partitioned train step -----------------------------------------------
# (a) at world size 1 on NCCL against the unpartitioned step: (arch, config
# overrides, batch, sequence with any prefix rows, micro-batches)
TRAIN_PARTITION_RUNS = (("qwen1.5-0.5b", {}, 4, 2048, 4),
                        # 256 prefix rows before 768 tokens
                        ("internvl2-1b", {}, 4, 1024, 2),
                        # one group: five windowed layers, then a global one
                        ("gemma3-12b", {"n_layers": 6}, 2, 2048, 2),
                        # MLA and the MoE (64 experts, 2 shared) at full
                        # width: 2,173,972,480 parameters, 32.39 GiB state
                        ("deepseek-v2-lite-16b", {"n_layers": 3}, 4, 1024,
                         2),
                        # jamba's three mixers at full width in two layers,
                        # a hybrid period of 2: attention + MLP, then Mamba
                        # + the MoE (16 experts of 14,336); ~3.7 G
                        # parameters, ~59 GB of state: one micro-batch,
                        # so no float32 gradient sum beside it
                        ("jamba-v0.1-52b", {"n_layers": 2, "hybrid": (2, 0)},
                         1, 512, 1),
                        # at a group of one the wkv state is whole: the
                        # square WKV and its backward (rows 8, 8b)
                        ("rwkv6-3b", {"n_layers": 4}, 4, 2048, 2),
                        # 8 x 448 decoder tokens over 1,500 frames
                        ("whisper-tiny", {}, 8, 448, 2))
TRAIN_PARTITION_STEPS = 2
# a run's state held on the card for torch.equal up to this size, else its
# bits' checksums (gemma3-12b's 6 layers: 33 GB of parameters and AdamW
# state, beside a second run's)
TRAIN_STATE_ON_CARD = 16 * 2 ** 30
RWKV_CELL_LAYERS = 8                # rwkv6-3b's pod256 train_4k cell
# (b) rank 0 of pod256 in train_4k under a fake group: (arch, layers or 0
# for all, warm-up runs, timed runs): qwen1.5-0.5b whole, the MoE, MLA and
# hybrid families' cells at the depths of phase 83's decode cells (dbrx 8
# of 40 layers, deepseek 4 of 27, jamba 8 of 32: one hybrid period),
# rwkv6-3b's at 8 of 32 and whisper-tiny's whole; the p50 of 2 runs, the
# first of them the warm-up, to keep the script inside its limit
TRAIN_PARTITION_CELLS = (("qwen1.5-0.5b", 0, 0, 2),
                         ("dbrx-132b", DBRX_LAYERS, 0, 2),
                         ("deepseek-v2-lite-16b", 4, 0, 2),
                         ("jamba-v0.1-52b", 8, 0, 2),
                         ("rwkv6-3b", RWKV_CELL_LAYERS, 0, 2),
                         ("whisper-tiny", 0, 0, 2))
# (c) row 9 at those ranks' micro-batches: 4 rows of 4,096, causal, forward
# and backward: qwen one head of 64 on one kv head; dbrx the 3 of 48 heads
# of 128 its wo rows touch, on the 1 kv head of 8 they read; jamba 2 of 32
# on 1 of 8
TRAIN_PARTITION_FLASH = {
    "qwen1.5-0.5b pod256 rank train_4k micro-batch":
        ((4, 4096, 4096, 1, 1, 64, True, 0), True),
    "dbrx-132b pod256 rank train_4k micro-batch":
        ((4, 4096, 4096, 3, 1, 128, True, 0), True),
    "jamba-v0.1-52b pod256 rank train_4k micro-batch":
        ((4, 4096, 4096, 2, 1, 128, True, 0), True),
    # whisper-tiny's rank: the head its wo rows touch, the encoder over
    # 1,500 frames and the decoder's 4,096 rows against them (its
    # self-attention is qwen's shape above)
    "whisper-tiny pod256 rank train_4k encoder":
        ((4, 1500, 1500, 1, 1, 64, False, 0), True),
    "whisper-tiny pod256 rank train_4k cross-attention":
        ((4, 4096, 1500, 1, 1, 64, False, 0), True)}
# (d) the key-slice WKV backward: (B, T, H, K, V) of the pod256 rank's
# rwkv6-3b train_4k micro-batch (bf16) and a float32 shape of 8 key rows
# whose last tile is short
TRAIN_PARTITION_WKV = {"train": ((4, 4096, 40, 4, 64), "bfloat16"),
                       "float32": ((2, 1031, 40, 8, 64), "float32")}
WKV_KEYSLICE_BWD_SRC = "src/repro_torch/csrc/wkv6_keyslice_bwd.cu"


def keyslice_bwd_bound(shape, io_bytes):
    """Least time of the backward of one key-slice call
    (``rwkv6_wkv/ops.py:keyslice_bwd_work``): its bytes over the memory
    rate against its float32 operations over 67 TFLOP/s and its
    exponentials over the special-function units. Returns (ms, bound_by,
    parts)."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    flops, exps, nbytes = wkv_ops.keyslice_bwd_work(*shape, io_bytes)
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32": flops / F32_FLOPS * 1e3, "exp": exps / SFU_PER_S * 1e3}
    ms = max(parts.values())
    return ms, "bytes" if parts["bytes"] >= ms else "operations", parts


def keyslice_autograd_check(torch, wkv_ops, wkv_ref, g, dev):
    """``wkv6_keyslice`` forward and backward through autograd (the
    ``WKV6KeySlice`` op: one launch of each kernel) against autograd of
    the plain forward (``wkv6_plain``, the chunked form), float32 at (2,
    1,024, 40, K 4, V 64): every gradient at float32's limits. Returns
    error/limit."""
    from repro_torch.kernels import build
    shape = (2, 1024, 40, 4, 64)
    B, T, H, K, V = shape
    args = keyslice_inputs(torch, g, shape, max(WKV_DECAYS), dev)
    args = [a.float() for a in args]
    dy = torch.randn((B, T, H, V), generator=g, device=dev)
    dso = torch.randn((B, H, K, V), generator=g, device=dev)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y, s1 = fn(*leaves)
        return torch.autograd.grad((y * dy).sum() + (s1 * dso).sum(),
                                   leaves)
    before = build.launch_counts()
    got = grads(wkv_ops.wkv6)
    after = build.launch_counts()
    want = grads(wkv_ref.wkv6_plain)
    torch.cuda.synchronize()
    launched = {n: after.get(n, 0) - before.get(n, 0)
                for n in ("wkv6_keyslice", "wkv6_keyslice_bwd")}
    if launched != {"wkv6_keyslice": 1, "wkv6_keyslice_bwd": 1}:
        raise AssertionError(f"wkv6_keyslice through autograd launched "
                             f"{launched}")
    ratio = wkv_bwd_ratio(torch, got, want, "float32")
    print(f"kernel wkv6_keyslice through autograd (WKV6KeySlice) B={B} "
          f"T={T} H={H} K={K} V={V} float32: every gradient against "
          f"autograd of wkv6_plain, error/limit {ratio:.3g} (rtol 1e-3, "
          f"atol 5e-4); launches {launched}")
    return ratio


def phase_keyslice_wkv_bwd(torch, np, report):
    """Phase 84(d) (module docstring): the key-slice WKV backward against
    its plain twin at ``TRAIN_PARTITION_WKV``, each of its kernels alone
    (``keyslice_pass_checks``), the autograd op, and the backward's and
    the forward's times, whole and by pass, at the rank's shape."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
    info = keyslice_info(wkv_ops, backward=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(84)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = {}
    for name, (shape, dname) in TRAIN_PARTITION_WKV.items():
        B, T, H, K, V = shape
        dt = dtypes[dname]
        ratios, controls, errs = [], [], []
        for wmax in WKV_DECAYS:
            r, k, v, w, u, s0 = keyslice_inputs(torch, g, shape, wmax, dev)
            dy = torch.randn((B, T, H, V), generator=g, device=dev)
            dso = torch.randn((B, H, K, V), generator=g, device=dev)
            args = [r.to(dt), k.to(dt), v.to(dt), w, u, s0, dy.to(dt), dso]
            got = wkv_ops.wkv6_keyslice_bwd(*args)
            dyc = args[6].clone()
            dyc[:, T // 2] = 0
            ctrl = wkv_ops.wkv6_keyslice_bwd(*args[:6], dyc, dso)
            want = wkv_ref.wkv6_backward_plain(*args)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(t).all()) for t in got):
                raise AssertionError(f"wkv6_keyslice_bwd {name}: not finite")
            ratios.append(wkv_bwd_ratio(torch, got, want, dname))
            controls.append(wkv_bwd_ratio(torch, ctrl, want, dname))
            errs.append(max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)))
            del got, ctrl, want, dyc
        cases[name] = dict(
            shape=f"B={B} T={T} H={H} K={K} V={V} ({dname} r/k/v/dy)",
            max_abs_err=max(errs), limit_ratio=max(ratios),
            control_ratio=min(controls))
        print(f"kernel wkv6_keyslice_bwd {cases[name]['shape']}: "
              f"error/limit {max(ratios):.3g} (dr, dk, dv, dw, du, dstate "
              f"against the plain twin, decays up to {max(WKV_DECAYS)}; "
              f"limit {WKV_BWD_LIMITS[dname]}); control (dy with token "
              f"{T // 2} zeroed) {min(controls):.3g}; max abs err "
              f"{max(errs):.3g}")
        if not max(ratios) <= 1.0 < min(controls):
            raise AssertionError(
                f"wkv6_keyslice_bwd {name}: error/limit {max(ratios)} must "
                f"be <= 1 and the control's {min(controls)} above it")
        if name == "train":
            # plain, kernel, kernel, plain; the plain twins issue thousands
            # of launches a call: host-paced event timing
            p1 = ms_timer(lambda: wkv_ref.wkv6_backward_plain(*args), 1)
            k1 = device_ms(lambda: wkv_ops.wkv6_keyslice_bwd(*args), 5)
            k2 = device_ms(lambda: wkv_ops.wkv6_keyslice_bwd(*args), 5)
            p2 = ms_timer(lambda: wkv_ref.wkv6_backward_plain(*args), 1)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            fwd = args[:6]
            f_ms = (device_ms(lambda: wkv_ops.wkv6_keyslice(*fwd), 5)
                    + device_ms(lambda: wkv_ops.wkv6_keyslice(*fwd), 5)) / 2
            f_plain = ms_timer(lambda: wkv_ref.wkv6_plain(*fwd), 1)
            b, by, parts = keyslice_bwd_bound(shape, 2)
            fb, fby, fparts = keyslice_bound(shape, 2)
            # each pass's kernel alone, from the profiler's device times
            pass_ms = kernel_ms_by_name(
                torch, lambda: wkv_ops.wkv6_keyslice_bwd(*args),
                KEYSLICE_KERNELS["wkv6_keyslice_bwd"])
            f_pass_ms = kernel_ms_by_name(
                torch, lambda: wkv_ops.wkv6_keyslice(*fwd),
                KEYSLICE_KERNELS["wkv6_keyslice"])
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                          bound_parts_ms=parts, pass_ms=pass_ms)
            fwd_train = dict(shape=cases[name]["shape"], ms=f_ms,
                             plain_ms=f_plain, bound_ms=fb, bound_by=fby,
                             bound_parts_ms=fparts, library_ms=None,
                             pass_ms=f_pass_ms)
            print(f"kernel wkv6_keyslice_bwd {cases[name]['shape']}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{b:.4f} ms ({by}: bytes {parts['bytes']:.4f}, f32 "
                  f"{parts['f32']:.4f}, exp {parts['exp']:.4f} ms), "
                  f"{b / ms:.4f} of it; the forward wkv6_keyslice there: "
                  f"kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, bound "
                  f"{fb:.4f} ms ({fby}); ms a pass: backward "
                  f"{json.dumps(pass_ms)}, forward {json.dumps(f_pass_ms)}")
        del args
        release(torch)
    passes = keyslice_pass_checks(
        torch, wkv_ops, wkv_ref, g, dev, True,
        KEYSLICE_PASS_SHAPES + ((TRAIN_PARTITION_WKV["train"][0],
                                 "bfloat16"),))
    release(torch)
    autograd_ratio = keyslice_autograd_check(torch, wkv_ops, wkv_ref, g, dev)
    if not autograd_ratio <= 1.0:
        raise AssertionError(f"wkv6_keyslice through autograd: error/limit "
                             f"{autograd_ratio}")
    main = cases["train"]
    report.append(dict(
        name="wkv6_keyslice_bwd", route="cuda", source=WKV_KEYSLICE_BWD_SRC,
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:81",
        replaces_note="no Pallas backward: the reference differentiates "
        "wkv6_chunked (src/repro/layers/rwkv6.py:92) under GSPMD, which "
        "splits the state of wkv6 by key rows",
        shape=main["shape"],
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        limit_ratio=max(c["limit_ratio"] for c in cases.values()),
        control_ratio=min(c["control_ratio"] for c in cases.values()),
        tolerance="bf16 2e-2 of the plain norm (per 32 tokens for dr, dk, "
        "dv, dw); float32 rtol 1e-3 atol 5e-4",
        **timing, library_ms=None, autograd_limit_ratio=autograd_ratio,
        cases=cases, passes=passes, info=info))
    for k in report:
        if k["name"] == "wkv6_keyslice":
            k["train"] = fwd_train


def bits_digest(torch, t, chunk=1 << 26):
    """Two int64 checksums (mod 2^64) of a tensor's bits, chunk by chunk on
    its device: the sum of its 16- or 32-bit words and the sum of each
    word times its index mod 65,521, plus one. A change in any word moves
    the first."""
    flat = t.detach().reshape(-1)
    words = flat.view(torch.int32 if flat.element_size() == 4
                      else torch.int16)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, words.numel(), chunk):
        w = words[i:i + chunk].to(torch.int64)
        idx = torch.arange(i, i + w.numel(), device=t.device) % 65521 + 1
        s1 += w.sum()
        s2 += (w * idx).sum()
    return int(s1), int(s2)


def train_state(torch, model, opt, on_card):
    """A train run's parameters and AdamW moments (and master) by name:
    clones on the card (``on_card``), else their bits' checksums."""
    named = {f"param {n}": p for n, p in model.named_parameters()}
    for part in ("mu", "nu", "master"):
        named.update({f"{part} {n}": t
                      for n, t in (getattr(opt, part) or {}).items()})
    return {k: t.detach().clone() if on_card else bits_digest(torch, t)
            for k, t in named.items()}


def train_partition_world1(torch, np, run, dev, card):
    """Phase 84(a), one config: ``TRAIN_PARTITION_STEPS`` steps of the
    partitioned train step (``TrainConfig.shard_axes`` on a (1, 1, 1) mesh
    over the NCCL group of world size 1, FSDP rules, sequence parallelism,
    remat, micro-batches) against as many unpartitioned steps from the
    same seeded weights and batches: every step's loss and ``grad_norm``
    bit for bit, then every parameter and AdamW moment (and master) bit
    for bit (``torch.equal`` on the card up to ``TRAIN_STATE_ON_CARD`` of
    state, else equal checksums of their bits), the same kernel launches,
    row 9's forward and backward among them where the config has an
    attention layer (none where it has none: deepseek's MLA is PyTorch's
    products), and for a MoE the same share of assignments dropped per
    layer on the first micro-batch. Prints both runs' host wall. Returns
    the partitioned run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HybridConfig
    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh, rank_context
    from repro_torch.models import api, lm
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step,
                                                 trainable_params)
    arch, over, B, T, micro = run
    over = dict(over)
    if "hybrid" in over:
        period, attn_index = over["hybrid"]
        over["hybrid"] = HybridConfig(period=period, attn_index=attn_index)
    cfg = get_config(arch).replace(**over)
    attends = any(lm.mixer_kind(cfg, i) in ("attn", "attn_local")
                  for i in range(lm.group_size(cfg)))
    mesh = Mesh(np.full((1, 1, 1), str(dev), dtype=object),
                ("pod", "data", "model"))
    rank = rank_context(mesh, device=dev)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    axes = {"dp": rules.dp, "tp": "model", "mesh": mesh, "sp": True,
            "ctx": rank}
    ocfg = AdamWConfig(lr=3e-4)
    batches = [make_batch(DataConfig(seed=84, batch=B, seq_len=T), cfg, s)
               for s in range(TRAIN_PARTITION_STEPS)]
    on_card = cfg.param_count() * (cfg.dtype().itemsize + 12) \
        <= TRAIN_STATE_ON_CARD
    runs = {}
    for label, shard_axes in (("unpartitioned", None),
                              ("partitioned", axes)):
        gen = torch.Generator(device=dev).manual_seed(84)
        model = api.init_params(cfg, gen, dev)
        if shard_axes:
            model = partition.shard_model(model, rules, rank,
                                          requires_grad=True)
        # the drop share per MoE layer of the first micro-batch the step
        # routes, at the config's capacity factor
        drops = (moe_drop_shares(torch, cfg, model, {
            k: v[:B // micro].to(dev) for k, v in batches[0].items()},
            shard_axes) if cfg.moe is not None else [])
        opt = adamw_init(trainable_params(model), ocfg)
        step = make_train_step(cfg, ocfg, TrainConfig(
            micro_batches=micro, remat=True, shard_axes=shard_axes))
        build.reset_launch_counts()
        _sync(torch, dev)
        t = time.perf_counter()
        stats = []
        for b in batches:
            model, opt, st = step(model, opt, b)
            stats.append((st["loss"].detach().clone(),
                          st["grad_norm"].detach().clone()))
        _sync(torch, dev)
        runs[label] = dict(wall=time.perf_counter() - t, stats=stats,
                           launches=build.launch_counts(), drops=drops,
                           state=train_state(torch, model, opt, on_card))
        del model, opt, step
        release(torch)
    want, got = runs["unpartitioned"], runs["partitioned"]
    same_stats = all(torch.equal(a, b) for x, y in zip(want["stats"],
                                                       got["stats"])
                     for a, b in zip(x, y))
    same = [(torch.equal(want["state"][k], got["state"][k]) if on_card
             else want["state"][k] == got["state"][k])
            for k in want["state"]]
    launches = got["launches"]
    print(f"partition train world 1: {arch} ({cfg.n_layers} layers, FSDP "
          f"rules, {B} x {T}, {micro} micro-batches, remat, sequence "
          f"parallel), {TRAIN_PARTITION_STEPS} steps: losses "
          f"{[float(x[0]) for x in got['stats']]} and grad norms "
          f"{[float(x[1]) for x in got['stats']]} bit-equal {same_stats}; "
          f"{sum(same)} of {len(same)} parameters and moments bit-equal "
          f"({'torch.equal on the card' if on_card else 'equal bit checksums'}"
          f"); launches {launches} (unpartitioned {want['launches']}); "
          f"partitioned {got['wall']:.2f} s, unpartitioned "
          f"{want['wall']:.2f} s (host wall); assignments dropped per MoE "
          f"layer at capacity factor "
          f"{cfg.moe.capacity_factor if cfg.moe else None}: partitioned "
          f"{[round(x, 4) for x in got['drops']]}, unpartitioned "
          f"{[round(x, 4) for x in want['drops']]}; on {card}")
    row9 = launches.get("flash_attention", 0) > 0 and launches.get(
        "flash_attention_bwd", 0) > 0
    if not (same_stats and all(same) and launches == want["launches"]
            and row9 == attends and got["drops"] == want["drops"]
            and set(got["state"]) == set(want["state"])):
        raise AssertionError(f"partition train world 1: {arch}: stats "
                             f"bit-equal {same_stats}, {sum(same)} of "
                             f"{len(same)} tensors bit-equal, launches "
                             f"{launches} vs {want['launches']}")
    return launches


def phase_partition_train(torch, np, report, dev, card):
    """Phase 84: (a) ``TRAIN_PARTITION_RUNS`` at world size 1 over NCCL
    (``train_partition_world1``), (b) rank 0 of ``PARTITION_MESH`` in the
    ``train_4k`` cells of ``TRAIN_PARTITION_CELLS`` under a fake group
    (``partition_cell``; their meta traces run meanwhile in spawned worker
    processes, one a cell, ``traced_partition_cell``), (c) row 9 at those
    ranks' micro-batch shapes, forward and backward
    (``TRAIN_PARTITION_FLASH``, the ``partition_train`` entries of
    ``flash_attention`` and ``flash_attention_bwd``), (d) the key-slice
    WKV backward (``phase_keyslice_wkv_bwd``). Returns {path: launches}."""
    import concurrent.futures
    import multiprocessing
    import torch.distributed as dist
    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import make_placeholder_mesh
    paths = {}
    with concurrent.futures.ProcessPoolExecutor(
            len(TRAIN_PARTITION_CELLS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        traces = [pool.submit(traced_partition_cell, arch, "train_4k", layers)
                  for arch, layers, _, _ in TRAIN_PARTITION_CELLS]
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        for run in TRAIN_PARTITION_RUNS:
            paths[f"partition train world 1 {run[0]}"] = \
                train_partition_world1(torch, np, run, dev, card)
        dist.destroy_process_group()
        rows = []
        with partition.fake_world(int(make_placeholder_mesh(
                PARTITION_MESH).devices.size)):
            for (arch, layers, warmup, timed), traced in zip(
                    TRAIN_PARTITION_CELLS, traces):
                row, launches = partition_cell(
                    torch, np, arch, "train_4k", layers, card, warmup, timed,
                    traced.result())
                rows.append(row)
                paths[f"partition {PARTITION_MESH} {arch} train_4k"] = \
                    launches
    print("partition train cells: " + json.dumps(
        [{k: v for k, v in r.items() if k != "ms"} for r in rows]))
    phase_flash_shapes(torch, report, TRAIN_PARTITION_FLASH,
                       "partition_train", 84)
    phase_keyslice_wkv_bwd(torch, np, report)
    release(torch)
    return paths


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
        torch, np, cfg, model, dev, need=ENGINE_ROWS, profile=True)
    one_writer_a_layer("engine", launches)
    t_lease = time.perf_counter()
    phase_lease_lifecycle(torch, np, cfg, model, dev, card)
    print(f"lease lifecycle phase: {time.perf_counter() - t_lease:.1f} s")
    t_req = time.perf_counter()
    request_lifecycle = phase_request_lifecycle(torch, np, cfg, model, dev,
                                                card, base_tokens)
    print(f"admission and request lifecycle phase: "
          f"{time.perf_counter() - t_req:.1f} s")
    del model
    release(torch)
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
    release(torch)
    print(f"rwkv6-3b phases done at {time.perf_counter() - t0:.1f} s")

    # -- deepseek-v2-lite-16b: MLA and the MoE, the mla latent plane -------
    dcfg = get_config("deepseek-v2-lite-16b")
    lap, done = model_laps(torch, "deepseek-v2-lite-16b", t0)
    phase_mla_rows(torch, np, dcfg, report, dev)
    lap("mla rows")
    model = phase_deepseek_model(torch, dcfg)
    lap("model")
    phase_deepseek_layer_step(torch, np, dcfg, model, dev)
    torch.cuda.empty_cache()
    lap("layer step")
    ds_per_request = phase_deepseek_per_request(torch, np, dcfg, model, dev)
    lap("per-request")
    ds_engine, _ = phase_engine(torch, np, dcfg, model, dev,
                                need=("gather_pages", "scatter_pages"),
                                profile=True)
    lap("engine")
    ds_roundtrip = phase_roundtrip(torch, np, dcfg, model, dev, "deepseek")
    lap("round trip")
    del model
    release(torch)
    done()

    # -- jamba-v0.1-52b: Mamba and attention, ssm/conv planes beside kv ---
    jamba = jamba_phases(torch, np, report, dev, t0)

    # -- internvl2-1b: prefix embeddings, G 7; the LoRA adapter cache;
    # gemma-7b: rows 1-5 at head_dim 256 -----------------------------------
    internvl2 = internvl2_phases(torch, np, report, dev, t0)
    t = time.perf_counter()
    lora_launches = phase_lora(torch, np, report, dev)
    print(f"lora phase: {time.perf_counter() - t:.1f} s; done at "
          f"{time.perf_counter() - t0:.1f} s")
    gemma = gemma_phases(torch, np, report, dev, t0)

    # -- dbrx-132b at 8 of 40 layers (rows 1-5 at G 6); the paper's
    # aqua-llama2-13b, aqua-codellama-34b and aqua-opt-30b; minicpm-2b ----
    new_models = {}
    for phases in (dbrx_phases, llama2_phases, codellama_phases,
                   opt_phases):
        new_models.update(phases(torch, np, report, dev, t0))
    new_models.update(minicpm_phase(torch, np, dev, t0))

    # -- qwen1.5-0.5b training: the flash attention kernels ----------------
    phase_flash_kernels(torch, report)
    gen = torch.Generator(device="cuda").manual_seed(2)
    model = lm.init_params(cfg, gen, "cuda")
    phase_train_step(torch, np, cfg, model, dev)
    del model
    torch.cuda.empty_cache()
    train_run = phase_train_run(torch, np, cfg, dev)
    release(torch)

    # -- training beyond the dense family: the WKV backward kernel,
    # rwkv6-3b, deepseek-v2-lite-16b at 3 layers, jamba's sub-layers,
    # internvl2-1b ----------------------------------------------------------
    t_fam = time.perf_counter()
    lap, done = model_laps(torch, "training families", t0)
    phase_wkv_bwd_kernel(torch, np, rcfg, report)
    lap("wkv6_bwd kernel")
    rcfg_t = rcfg.replace(n_layers=RWKV_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = lm.init_params(rcfg_t, gen, "cuda")
    rwkv_step = phase_rwkv_train_step(torch, np, rcfg_t, model, dev)
    del model
    release(torch)
    lap("rwkv6-3b train step")
    rwkv_train = phase_train_run(torch, np, rcfg_t, dev, remat=True,
                                 steps=SHORT_RUN_STEPS,
                                 label="rwkv6-3b train", seed=6)
    release(torch)
    lap("rwkv6-3b train run")
    ds_train = phase_deepseek_train(torch, np, dev)
    release(torch)
    lap("deepseek-v2-lite-16b train")
    jamba_train = phase_jamba_train_layers(torch, np, dev)
    release(torch)
    lap("jamba-v0.1-52b sub-layers train")
    ivl_train = phase_train_run(torch, np, get_config("internvl2-1b"), dev,
                                steps=SHORT_RUN_STEPS,
                                label="internvl2-1b train", seed=7)
    release(torch)
    lap("internvl2-1b train run")
    done()
    print(f"training families phases: {time.perf_counter() - t_fam:.1f} s")

    # -- the dense KV-cache path: row 9 at its prefill shapes, gemma3-12b
    # and aqua-mistral-7b at full width and depth, the float32 gate --------
    t_dense = time.perf_counter()
    dense = dense_cache_phases(torch, np, report, dev, t0)
    print(f"dense KV-cache path phases: {time.perf_counter() - t_dense:.1f} "
          f"s")

    # -- the host and slab legs measured and fitted, the paper's figures on
    # the simulator, AQUA-PLACER -> coordinator -> engine -> reclaim -------
    t_link = time.perf_counter()
    policy = link_and_policy_phases(torch, np, dev, card, t0)
    print(f"link legs, paper sim and placer phases: "
          f"{time.perf_counter() - t_link:.1f} s")

    # -- whisper-tiny (the encoder-decoder) served and trained through row
    # 9, and the windowed configs trained on the card --------------------
    t_new = time.perf_counter()
    whisper = whisper_and_windowed_phases(torch, np, report, dev, t0)
    print(f"whisper and windowed training phases: "
          f"{time.perf_counter() - t_new:.1f} s")

    # -- the scale-up domain: the mesh tier legs, the engine over the domain
    # with calibrate_clock, the int8 gradient all-reduce and reshard ------
    t_mesh = time.perf_counter()
    mesh = mesh_phases(torch, np, dev, card, t0)
    print(f"mesh phases: {time.perf_counter() - t_mesh:.1f} s")

    # -- the roofline against the card: dry-run cells traced on meta and
    # run on the card; the dry run's qwen1.5-0.5b and rwkv6-3b rows ------
    t_roof = time.perf_counter()
    roofline_paths = phase_roofline(torch, np, dev, card)
    print(f"roofline phase: {time.perf_counter() - t_roof:.1f} s; done at "
          f"{time.perf_counter() - t0:.1f} s")

    # -- the partitioned serving step: at world size 1 against the
    # unpartitioned one, and one rank of pod256 at its own shapes ---------
    t_part = time.perf_counter()
    partition_paths = phase_partition(torch, np, report, dev, card)
    print(f"partition phase: {time.perf_counter() - t_part:.1f} s; done at "
          f"{time.perf_counter() - t0:.1f} s")

    # -- the partitioned train step: at world size 1 against the
    # unpartitioned one, and rank 0 of pod256 in train_4k -----------------
    t_ptrain = time.perf_counter()
    partition_paths.update(phase_partition_train(torch, np, report, dev,
                                                 card))
    print(f"partition train phase: {time.perf_counter() - t_ptrain:.1f} s; "
          f"done at {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on the first path that runs it: the qwen engine
    # (the fused step), the qwen per-request path, the split-pool drive, the
    # rwkv engine, the rwkv per-request path, the train run; and on every
    # path that runs it, phase 6c's admission and request lifecycle and the
    # deepseek, jamba, internvl2-1b, LoRA, gemma-7b, dbrx-132b, the
    # paper's models', minicpm-2b's, the training families' and the dense
    # KV-cache path's, the link legs' and the placer serve's, whisper's and
    # the windowed train steps' included (the WKV backward's first is the
    # rwkv6-3b train run)
    paths = (("engine", launches), ("per-request", per_request),
             ("split-pool drive", split), ("rwkv engine", rwkv_engine),
             ("rwkv per-request", rwkv_per_request), ("train", train_run),
             ("request lifecycle", request_lifecycle),
             ("deepseek engine", ds_engine),
             ("deepseek per-request", ds_per_request),
             ("deepseek round trip", ds_roundtrip)) + tuple(jamba.items()) \
        + tuple(internvl2.items()) + (("lora cache", lora_launches),) \
        + tuple(gemma.items()) + tuple(new_models.items()) \
        + (("rwkv train", rwkv_train), ("rwkv train step", rwkv_step),
           ("deepseek train", ds_train), ("jamba layer train", jamba_train),
           ("internvl2 train", ivl_train)) + tuple(dense.items()) \
        + tuple(policy.items()) + tuple(whisper.items()) \
        + tuple(mesh.items()) + tuple(roofline_paths.items()) \
        + tuple(partition_paths.items())
    for k in report:
        k["path"], counts = next(((p, c) for p, c in paths
                                  if c.get(k["name"], 0) > 0), ("none", {}))
        k["launches"] = int(counts.get(k["name"], 0))
        k["launches_by_path"] = {p: int(c[k["name"]]) for p, c in paths
                                 if c.get(k["name"], 0) > 0}
    missing = [k["name"] for k in report if k["launches"] == 0]
    if missing:
        raise AssertionError(f"no path launched {missing}")
    if not all(ds_engine.get(k, 0) > 0 for k in ("gather_pages",
                                                 "scatter_pages")):
        raise AssertionError("the deepseek engine launched no gather or no "
                             "scatter")
    no_jamba = [k["name"] for k in report if k["name"] in JAMBA_ROWS
                and not any(p in k["launches_by_path"] for p in jamba)]
    if no_jamba:
        raise AssertionError(f"no jamba path launched {no_jamba}")
    rows_of = (("lora cache", ("gather_pages", "scatter_pages")),
               ("dbrx-132b per-request", PER_REQUEST_ROWS),
               ("aqua-llama2-13b per-request", PER_REQUEST_ROWS),
               ("aqua-llama2-13b split-pool drive", ("paged_attention",)),
               ("link legs", ("gather_pages", "scatter_pages")),
               ("mesh tier legs", ("gather_pages", "scatter_pages")),
               ("mesh engine", ("gather_pages", "scatter_pages"))) \
        + tuple((label, ENGINE_ROWS) for label in (
            "internvl2-1b engine", "gemma-7b engine", "dbrx-132b engine",
            "aqua-llama2-13b engine", "aqua-codellama-34b engine",
            "aqua-opt-30b engine", "minicpm-2b engine", "placer serve"))
    for label, rows in rows_of:
        paths_of = dict(paths)
        if not all(paths_of[label].get(k, 0) > 0 for k in rows):
            raise AssertionError(f"the {label} path launched none of some "
                                 f"of {list(rows)}")
    no_gemma = [k["name"] for k in report if k["name"] in GEMMA_ROWS
                and not any(p in k["launches_by_path"] for p in gemma)]
    if no_gemma:
        raise AssertionError(f"no gemma-7b path launched {no_gemma}")
    no_new = [k["name"] for k in report if k["name"] in GEMMA_ROWS
              and not any(p in k["launches_by_path"] for p in new_models)]
    if no_new:
        raise AssertionError(f"no path of dbrx-132b, the paper's models or "
                             f"minicpm-2b launched {no_new}")
    trained = (("rwkv train", ("wkv6", "wkv6_bwd")),
               ("jamba layer train", ("flash_attention_bwd",)),
               ("internvl2 train", ("flash_attention_bwd",)),
               ("gemma3-12b prefill", ("flash_attention",)),
               ("aqua-mistral-7b prefill", ("flash_attention",)),
               ("whisper-tiny prefill", ("flash_attention",)),
               ("whisper-tiny decode", ("flash_attention",)),
               ("whisper-tiny train", ("flash_attention",
                                       "flash_attention_bwd")),
               ("gemma3-12b windowed train step", ("flash_attention",
                                                   "flash_attention_bwd")),
               ("aqua-mistral-7b windowed train step", (
                   "flash_attention", "flash_attention_bwd")),
               ("roofline qwen1.5-0.5b train_4k", ("flash_attention",
                                                   "flash_attention_bwd")),
               ("roofline qwen1.5-0.5b prefill_32k", ("flash_attention",)),
               ("roofline rwkv6-3b long_500k", ("wkv6",)),
               ("partition world 1 qwen1.5-0.5b", ("flash_attention",)),
               ("partition world 1 dbrx-132b", ("flash_attention",)),
               ("partition pod256 qwen1.5-0.5b prefill_32k",
                ("flash_attention",)),
               ("partition world 1 jamba-v0.1-52b", ("flash_attention",)),
               ("partition world 1 rwkv6-3b", ("wkv6",)),
               ("partition world 1 whisper-tiny", ("flash_attention",)),
               ("partition pod256 rwkv6-3b long_500k", ("wkv6_keyslice",)),
               ("partition pod256 whisper-tiny decode_32k",
                ("flash_attention",))) + tuple(
        (label, ("flash_attention", "flash_attention_bwd")) for label in (
            "partition train world 1 qwen1.5-0.5b",
            "partition train world 1 internvl2-1b",
            "partition train world 1 gemma3-12b",
            "partition train world 1 jamba-v0.1-52b",
            "partition train world 1 whisper-tiny",
            "partition pod256 qwen1.5-0.5b train_4k",
            "partition pod256 dbrx-132b train_4k",
            "partition pod256 jamba-v0.1-52b train_4k",
            "partition pod256 whisper-tiny train_4k")) + (
        ("partition train world 1 rwkv6-3b", ("wkv6", "wkv6_bwd")),
        ("partition pod256 rwkv6-3b train_4k", ("wkv6_keyslice",
                                                "wkv6_keyslice_bwd")))
    for label, rows in trained:
        if not all(dict(paths)[label].get(k, 0) > 0 for k in rows):
            raise AssertionError(f"the {label} path launched none of some "
                                 f"of {list(rows)}")
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
