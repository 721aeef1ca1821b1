"""Analytic performance model that prices the serving engine's simulated
clock — the reference's ``core/perfmodel.py`` formulas, kept as a copy.

Three hardware profiles:
  * ``H100_SXM``     — the port's card, from NVIDIA's H100 SXM datasheet
    (989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB, NVLink 450 GB/s each
    way, PCIe Gen5 x16 64 GB/s each way). DATASHEET values, not measured;
    the per-message latencies are the A100 profile's assumptions. The
    engine's default.
  * ``A100_NVLINK``  — the paper's testbed (8x A100-80G, NVLink/NVSwitch).
  * ``TPU_V5E``      — the JAX reference's default profile; kept so the
    port prices a step exactly like the reference when handed it.

The interconnect model is latency + bandwidth: t(s) = alpha + s / B_peak.
``fit_link_model`` fits alpha and B_peak to measured ``(bytes, seconds)``
samples and ``calibrate_profile`` swaps a profile's links for such fits:
the way a profile's links become measured values instead of datasheet ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LinkModel:
    name: str
    peak_bw: float          # bytes/s
    latency: float          # s per message

    def time(self, nbytes: float, n_messages: int = 1) -> float:
        return n_messages * self.latency + nbytes / self.peak_bw

    def effective_bw(self, message_bytes: float) -> float:
        return message_bytes / self.time(message_bytes)


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops_peak: float       # FLOP/s (bf16)
    hbm_bw: float           # bytes/s
    hbm_bytes: float        # device memory capacity
    fabric: LinkModel       # scale-up interconnect (NVLink / ICI)
    host_link: LinkModel    # PCIe path to host DRAM
    mfu: float = 0.45       # achievable fraction of peak in serving kernels
    membw_util: float = 0.75
    launch_overhead: float = 4e-6     # per kernel launch dispatch
    retry_backoff: float = 25e-6      # base delay before re-issuing a leg

    def pod_slice(self, n: int) -> "HardwareProfile":
        """``n`` tensor-parallel cards as one serving unit: compute, memory
        and both links' aggregate bandwidth scale with ``n``; latencies and
        the launch overhead do not (every card dispatches in lockstep)."""
        if n == 1:
            return self
        return HardwareProfile(
            f"{self.name}x{n}", self.flops_peak * n, self.hbm_bw * n,
            self.hbm_bytes * n,
            LinkModel(self.fabric.name, self.fabric.peak_bw * n,
                      self.fabric.latency),
            LinkModel(self.host_link.name, self.host_link.peak_bw * n,
                      self.host_link.latency),
            self.mfu, self.membw_util, self.launch_overhead,
            self.retry_backoff)


# Paper testbed: A100-80G SXM. Fig. 3a calibration: 100 GB/s @ 2 MB, ~250 GB/s
# peak => alpha = 2e6/100e9 - 2e6/250e9 = 12 us.
A100_NVLINK = HardwareProfile(
    name="a100-nvlink",
    flops_peak=312e12,
    hbm_bw=2.0e12,
    hbm_bytes=80e9,
    fabric=LinkModel("nvlink", 250e9, 12e-6),
    host_link=LinkModel("pcie4", 25e9, 10e-6),
)

# The JAX reference's default profile (its constants, not the port's card).
TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    flops_peak=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    fabric=LinkModel("ici", 50e9, 5e-6),
    host_link=LinkModel("pcie-host", 16e9, 20e-6),
)

# H100 SXM datasheet peaks (not measured); latencies as in A100_NVLINK.
H100_SXM = HardwareProfile(
    name="h100-sxm-datasheet",
    flops_peak=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    fabric=LinkModel("nvlink4", 450e9, 12e-6),
    host_link=LinkModel("pcie5", 64e9, 10e-6),
)

PROFILES = {p.name: p for p in (A100_NVLINK, TPU_V5E, H100_SXM)}


@dataclass(frozen=True)
class ModelCost:
    """Analytic per-model serving costs (dense-equivalent active params)."""
    n_params: float            # active parameters per token
    kv_bytes_per_token: float  # whole-stack KV bytes per cached token
    dtype_bytes: int = 2
    state_bytes: float = 0.0   # fixed recurrent state bytes per request,
    #                            moved on every context switch
    n_layers: int = 1          # one fused kernel launch per layer per call
    n_planes: int = 1          # page planes of the family's state layout:
    #                            the messages of an uncoalesced tier flip

    @staticmethod
    def from_config(cfg) -> "ModelCost":
        """Costs of a dense config (every layer is attention), a hybrid
        one (K/V of its attention layers only, plus the Mamba layers' ssm
        and conv state), an MoE/MLA one (the latent cache per token; only
        the top-k routed experts are active) or an RWKV-6 one (O(1)
        recurrent state, no per-token cache)."""
        if cfg.mla is not None:
            kvtok = ((cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
                     * cfg.n_layers * 2)
        elif cfg.family == "ssm":
            kvtok = 0.0
        else:
            n_attn = sum(1 for i in range(cfg.n_layers)
                         if cfg.is_attention_layer(i))
            kvtok = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * n_attn * 2
        # the state page planes (as models/lm.py:paged_layout lays them
        # out): float32 wkv/ssm and native-dtype shift/conv leaves
        state = 0.0
        n_planes = 1
        if cfg.family == "ssm" and cfg.ssm is not None:
            rhd = cfg.ssm.rwkv_head_dim
            H = cfg.d_model // rhd
            state = cfg.n_layers * (H * rhd * rhd * 4 + 2 * cfg.d_model * 2)
            n_planes = 2                          # wkv + shift
        elif cfg.family == "hybrid" and cfg.ssm is not None:
            s = cfg.ssm
            di = s.mamba_expand * cfg.d_model
            n_mamba = sum(1 for i in range(cfg.n_layers)
                          if not cfg.is_attention_layer(i))
            state = n_mamba * (di * s.mamba_d_state * 4
                               + (s.mamba_d_conv - 1) * di * 2)
            n_planes = 3                          # kv + ssm + conv
        n_active = cfg.param_count()
        if cfg.moe is not None:
            m = cfg.moe
            fe = m.d_ff_expert or cfg.d_ff
            glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n_active -= ((m.n_experts - m.top_k) * glu * cfg.d_model * fe
                         * (cfg.n_layers // m.moe_every))
        return ModelCost(float(n_active), float(kvtok),
                         state_bytes=float(state), n_layers=int(cfg.n_layers),
                         n_planes=int(n_planes))

    def prefill_time(self, hw: HardwareProfile, n_tokens: int) -> float:
        return 2.0 * self.n_params * n_tokens / (hw.flops_peak * hw.mfu)

    def launch_time(self, hw: HardwareProfile, n_calls: int) -> float:
        """Dispatch overhead of ``n_calls`` serving calls, ~one fused launch
        per layer each."""
        return launch_overhead_time(hw, n_calls * self.n_layers)

    def decode_step_time(self, hw: HardwareProfile, batch: int,
                         ctx_tokens: float, weight_bytes: float) -> float:
        """One token for ``batch`` sequences with mean context
        ``ctx_tokens`` (roofline max)."""
        t_flops = 2.0 * self.n_params * batch / (hw.flops_peak * hw.mfu)
        kv_read = self.kv_bytes_per_token * ctx_tokens * batch
        t_mem = (weight_bytes + kv_read) / (hw.hbm_bw * hw.membw_util)
        return max(t_flops, t_mem)

    def fused_step_time(self, hw: HardwareProfile, batch: int,
                        ctx_tokens: float, weight_bytes: float,
                        chunk_tokens: int = 0) -> float:
        """One fused step: ``batch`` decode lanes plus ``chunk_tokens`` of
        prompt-chunk rows sharing one weight read (roofline max)."""
        t_flops = (2.0 * self.n_params * (batch + chunk_tokens)
                   / (hw.flops_peak * hw.mfu))
        kv_read = self.kv_bytes_per_token * ctx_tokens * batch
        t_mem = (weight_bytes + kv_read) / (hw.hbm_bw * hw.membw_util)
        return max(t_flops, t_mem)

    def piggyback_tokens(self, hw: HardwareProfile, batch: int,
                         ctx_tokens: float, weight_bytes: float) -> int:
        """Prompt-chunk tokens that ride a memory-bound decode launch free."""
        t_tok = 2.0 * self.n_params / (hw.flops_peak * hw.mfu)
        kv_read = self.kv_bytes_per_token * ctx_tokens * batch
        t_mem = (weight_bytes + kv_read) / (hw.hbm_bw * hw.membw_util)
        return max(int(t_mem / t_tok) - batch, 0)

    def kv_bytes(self, n_tokens: float) -> float:
        return self.kv_bytes_per_token * n_tokens

    def context_bytes(self, n_tokens: float) -> float:
        """A request's whole dynamic context: its token pages plus its fixed
        state pages (what one tier flip moves)."""
        return self.kv_bytes(n_tokens) + self.state_bytes

    def unique_context_bytes(self, n_tokens: float,
                             shared_tokens: float = 0.0) -> float:
        """The context a request owns alone when its first
        ``shared_tokens`` of KV alias another resident request's pages."""
        return self.context_bytes(n_tokens) \
            - self.kv_bytes(min(shared_tokens, n_tokens))


def context_switch_time(hw: HardwareProfile, kv_bytes: float, *,
                        tier: str, coalesced: bool = True,
                        n_fragments: int = 1) -> float:
    """Time to page a context in or out through a staging blob: ``tier``
    is ``"fabric"`` or ``"host"``. Coalesced, one message after a gather
    pass over HBM; uncoalesced, one message per fragment and no gather."""
    link = hw.fabric if tier == "fabric" else hw.host_link
    msgs = max(1, n_fragments) if not coalesced else 1
    gather_overhead = (kv_bytes / (hw.hbm_bw * hw.membw_util)
                       if coalesced else 0.0)
    return gather_overhead + link.time(kv_bytes, n_messages=msgs)


def launch_overhead_time(hw: HardwareProfile, n_launches: int) -> float:
    """Host time spent dispatching ``n_launches`` kernel launches."""
    return max(0, n_launches) * hw.launch_overhead


def retry_backoff_time(hw: HardwareProfile, attempt: int) -> float:
    """Exponential backoff before re-issuing a failed transfer leg."""
    return hw.retry_backoff * (2 ** max(int(attempt) - 1, 0))


def overlapped_transfer_time(compute_s: float, transfer_s: float) -> float:
    """Visible time of a page transfer overlapped with step compute: hidden
    up to the step's compute time, only the excess extends the step."""
    return max(0.0, transfer_s - compute_s)


def page_flip_time(hw: HardwareProfile, payload_bytes: float, *,
                   tier: str, n_groups: int = 1) -> float:
    """Time to park or restore a request on the paged runtime: the page
    payload moves as one message per (tier, donor) group, no repack."""
    link = hw.fabric if tier == "fabric" else hw.host_link
    return link.time(payload_bytes, n_messages=max(1, n_groups))


def prefix_hit_saving(hw: HardwareProfile, model: ModelCost, *,
                      hit_tokens: int, tier: str = "fabric",
                      n_groups: int = 1) -> Tuple[float, float]:
    """One prefix-cache hit of ``hit_tokens``: ``(prefill time saved,
    restore time paid)`` — the prefix's prefill skipped against one tier
    flip bringing its cached pages back LOCAL from ``tier``."""
    saved = model.prefill_time(hw, int(hit_tokens))
    paid = page_flip_time(hw, model.kv_bytes(float(hit_tokens)),
                          tier=tier, n_groups=n_groups)
    return saved, paid


def fit_link_model(samples: Sequence[Tuple[float, float]],
                   name: str) -> Optional[LinkModel]:
    """Least-squares fit of ``t = latency + nbytes / peak_bw`` to measured
    ``(nbytes, seconds)`` samples.

    Returns None when the samples cannot identify both terms (fewer than
    2 samples, or one distinct size). The fitted latency is clamped to
    >= 0; a non-positive fitted slope falls back to the effective
    bandwidth of the largest sample (None if that size is 0).
    """
    if len(samples) < 2:
        return None
    xs = np.asarray([s[0] for s in samples], np.float64)
    ys = np.asarray([s[1] for s in samples], np.float64)
    if len(np.unique(xs)) < 2:
        return None
    slope, alpha = np.polyfit(xs, ys, 1)
    if slope <= 0:
        big = int(np.argmax(xs))
        slope = ys[big] / xs[big] if xs[big] > 0 else None
        if not slope or slope <= 0:
            return None
    return LinkModel(name, float(1.0 / slope), float(max(alpha, 0.0)))


Samples = Optional[Sequence[Tuple[float, float]]]


def calibrate_profile(hw: HardwareProfile, *, fabric_samples: Samples = None,
                      host_samples: Samples = None,
                      min_samples: int = 4) -> HardwareProfile:
    """``hw`` with each link refit to its measured samples, where there
    are at least ``min_samples`` of them and the fit identifies both
    terms; otherwise the link keeps its constants. With nothing refit it
    returns ``hw`` itself; else a copy named ``<name>-calibrated``."""
    fabric = hw.fabric
    host = hw.host_link
    if fabric_samples is not None and len(fabric_samples) >= min_samples:
        fabric = fit_link_model(fabric_samples,
                                f"{hw.fabric.name}-measured") or fabric
    if host_samples is not None and len(host_samples) >= min_samples:
        host = fit_link_model(host_samples,
                              f"{hw.host_link.name}-measured") or host
    if fabric is hw.fabric and host is hw.host_link:
        return hw
    return dataclasses.replace(hw, name=f"{hw.name}-calibrated",
                               fabric=fabric, host_link=host)
