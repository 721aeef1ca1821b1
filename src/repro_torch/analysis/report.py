"""Builds the dry-run and roofline tables from the dry-run results
directory (a JSON record per cell and, on the ``h100`` mesh, its gzipped
trace) — the counterpart of ``repro/analysis/report.py``.

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch

Every term is per device, against ``perfmodel.H100_SXM``'s datasheet
constants: on ``h100`` the whole step, on the pods rank 0's partitioned
step (the serving cells of the attention, MLP and MoE families; the other
pod cells have no trace, and their rows show "—"). A mesh gets a roofline
table when any of its cells has a trace.
"""
from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Dict, List

from repro_torch.analysis.roofline import (analyze_file, model_flops,
                                           roofline_from_cost)
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.core.perfmodel import H100_SXM
from repro_torch.launch.mesh import PLACEHOLDER_MESHES

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "internvl2-1b", "rwkv6-3b", "gemma-7b", "qwen1.5-0.5b", "minicpm-2b",
    "gemma3-12b", "deepseek-v2-lite-16b", "dbrx-132b", "whisper-tiny",
    "jamba-v0.1-52b",
]
_CELL_RE = re.compile(r"(.+)_(train_4k|prefill_32k|decode_32k|long_500k)$")


def _chips(mesh_name: str) -> int:
    return math.prod(PLACEHOLDER_MESHES[mesh_name][0])


def collect(results_dir: str, mesh_name: str) -> List[Dict]:
    out = []
    d = os.path.join(results_dir, mesh_name)
    for jf in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(jf) as f:
            rec = json.load(f)
        stem = os.path.basename(jf)[:-5]
        m = _CELL_RE.match(stem)
        if not m:
            continue
        arch, shape_name = m.groups()
        rec["arch"], rec["shape"] = arch, shape_name
        trace = os.path.join(d, stem + ".trace.jsonl.gz")
        if rec.get("status") == "ok" and os.path.exists(trace):
            cost = analyze_file(trace)
            mf = model_flops(get_config(arch), SHAPES_BY_NAME[shape_name]) \
                / _chips(mesh_name)
            rl = roofline_from_cost(cost, model_flops_per_device=mf)
            rec["roofline"] = {
                "flops": cost.flops, "bytes": cost.bytes,
                "coll_bytes": cost.coll_bytes,
                "coll_ops": cost.coll_counts,
                **rl.table_row(),
            }
        out.append(rec)
    return out


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table_md(records: List[Dict], mesh_name: str) -> str:
    hw = H100_SXM
    limit = hw.hbm_bytes / 1e9
    lines = [
        f"### Roofline — {mesh_name} "
        f"({_chips(mesh_name)} chip{'s' if _chips(mesh_name) > 1 else ''}, "
        f"{hw.name}: {hw.flops_peak/1e12:.0f} TF/s bf16, "
        f"{hw.hbm_bw/1e9:.0f} GB/s HBM, {hw.fabric.peak_bw/1e9:.0f} GB/s "
        f"{hw.fabric.name})",
        "",
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck | "
        "MODEL_FLOPS/HLO_FLOPs | mem/dev (args+temp) | notes |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    index = {(r["arch"], r["shape"]): r for r in records}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = index.get((arch, shape))
            if r is None:
                continue
            if r.get("status") == "skipped":
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                             f"SKIP: {r.get('reason','')[:60]} |")
                continue
            if r.get("status") == "ok" and "roofline" not in r:
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                             f"{r.get('cost_reason', 'no trace')[:60]} |")
                continue
            if r.get("status") != "ok":
                lines.append(f"| {arch} | {shape} | — | — | — | — | — | — | "
                             f"ERROR: {r.get('error','')[:60]} |")
                continue
            rl = r["roofline"]
            mem = r["memory"]
            memgb = (mem["argument_size_in_bytes"]
                     + mem["temp_size_in_bytes"]) / 1e9
            note = "" if memgb <= limit else \
                f"OVER {limit:.0f}GB ({memgb:.0f}GB)"
            lines.append(
                f"| {arch} | {shape} | {_fmt_s(rl['t_compute_s'])} | "
                f"{_fmt_s(rl['t_memory_s'])} | {_fmt_s(rl['t_collective_s'])} | "
                f"**{rl['bottleneck']}** | {rl['useful_ratio']:.2f} | "
                f"{memgb:.1f} GB | {note} |")
    return "\n".join(lines)


def dryrun_table_md(records: List[Dict], mesh_name: str) -> str:
    lines = [
        f"### Dry-run — {mesh_name}",
        "",
        "| arch | shape | status | compile | HLO GFLOPs/dev | bytes/dev | "
        "collective bytes/dev | collective ops |",
        "|---|---|---|---|---|---|---|---|",
    ]
    index = {(r["arch"], r["shape"]): r for r in records}
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = index.get((arch, shape))
            if r is None:
                continue
            if r.get("status") != "ok":
                lines.append(f"| {arch} | {shape} | {r.get('status')} | — | — "
                             f"| — | — | — |")
                continue
            if "roofline" not in r:
                lines.append(f"| {arch} | {shape} | ok | {r['compile_s']}s | "
                             f"— | — | — | — |")
                continue
            rl = r["roofline"]
            ops = rl.get("coll_ops", {})
            opss = ", ".join(f"{k}:{v}" for k, v in sorted(ops.items()))
            lines.append(
                f"| {arch} | {shape} | ok | {r['compile_s']}s | "
                f"{rl.get('flops', 0)/1e9:.1f} | {rl.get('bytes', 0)/1e9:.1f} GB | "
                f"{rl.get('coll_bytes', 0)/1e9:.2f} GB | {opss[:90]} |")
    return "\n".join(lines)


def summarize(results_dir: str) -> str:
    parts = []
    for mesh_name in PLACEHOLDER_MESHES:
        if not os.path.isdir(os.path.join(results_dir, mesh_name)):
            continue
        recs = collect(results_dir, mesh_name)
        parts.append(dryrun_table_md(recs, mesh_name))
        parts.append("")
        if any("roofline" in r for r in recs):
            parts.append(roofline_table_md(recs, mesh_name))
            parts.append("")
    return "\n".join(parts)


if __name__ == "__main__":
    import sys
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    print(summarize(d))
