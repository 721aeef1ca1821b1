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
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinkModel:
    name: str
    peak_bw: float          # bytes/s
    latency: float          # s per message

    def time(self, nbytes: float, n_messages: int = 1) -> float:
        return n_messages * self.latency + nbytes / self.peak_bw


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


@dataclass(frozen=True)
class ModelCost:
    """Analytic per-model serving costs (dense-equivalent active params)."""
    n_params: float            # active parameters per token
    kv_bytes_per_token: float  # whole-stack KV bytes per cached token
    n_layers: int = 1          # one fused kernel launch per layer per call

    @staticmethod
    def from_config(cfg) -> "ModelCost":
        """Costs of a dense config (every layer is attention) or an RWKV-6
        one (O(1) recurrent state, no per-token cache)."""
        kvtok = (0.0 if cfg.family == "ssm" else
                 2 * cfg.n_kv_heads * cfg.resolved_head_dim * cfg.n_layers * 2)
        return ModelCost(float(cfg.param_count()), float(kvtok),
                         n_layers=int(cfg.n_layers))

    def prefill_time(self, hw: HardwareProfile, n_tokens: int) -> float:
        return 2.0 * self.n_params * n_tokens / (hw.flops_peak * hw.mfu)

    def launch_time(self, hw: HardwareProfile, n_calls: int) -> float:
        """Dispatch overhead of ``n_calls`` serving calls, ~one fused launch
        per layer each."""
        return launch_overhead_time(hw, n_calls * self.n_layers)

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
