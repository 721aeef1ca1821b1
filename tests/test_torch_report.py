"""The port's dry-run and roofline tables (``repro_torch/analysis/
report.py``) against the reference's (``repro/analysis/report.py``): fed
the same records, every row is the reference's, except the roofline
header's hardware (the H100's constants) and the memory limit of the notes
(``H100_SXM.hbm_bytes``, 80 GB, where the reference's is a v5e's 16 GB).
``collect`` and ``summarize`` read a results directory of records and
traces."""
import copy
import json

import pytest
import torch

from repro.analysis import report as jreport
from repro_torch.analysis import report
from repro_torch.analysis.roofline import TraceRecorder
from repro_torch.core.perfmodel import H100_SXM


def _ok(arch, shape, args_gb, temp_gb, t_c, t_m, bottleneck="memory"):
    return {
        "arch": arch, "shape": shape, "status": "ok", "compile_s": 1.5,
        "memory": {"argument_size_in_bytes": args_gb * 1e9,
                   "temp_size_in_bytes": temp_gb * 1e9},
        "roofline": {"flops": 3.2e12, "bytes": 7.1e10, "coll_bytes": 4.0e8,
                     "coll_ops": {"all-reduce": 2, "all-gather": 5},
                     "t_compute_s": t_c, "t_memory_s": t_m,
                     "t_collective_s": 2e-6, "bottleneck": bottleneck,
                     "model_flops": 1e12, "useful_ratio": 0.31}}


RECORDS = [
    _ok("qwen1.5-0.5b", "train_4k", 3.0, 5.0, 2.5, 0.004, "compute"),
    _ok("qwen1.5-0.5b", "decode_32k", 40.0, 1.0, 3e-5, 0.02),
    _ok("rwkv6-3b", "long_500k", 6.0, 0.1, 1e-3, 2e-4, "compute"),
    _ok("dbrx-132b", "prefill_32k", 435.0, 600.0, 0.11, 0.2),
    {"arch": "gemma-7b", "shape": "long_500k", "status": "skipped",
     "reason": "pure full-attention arch: 500k KV decode is quadratic"},
    {"arch": "minicpm-2b", "shape": "train_4k", "status": "error",
     "error": "RuntimeError: boom"},
]


def _rows(md: str):
    return [line for line in md.splitlines() if line.startswith("| ")
            and not line.startswith("| arch")]


def test_dryrun_table_rows_equal_reference():
    got = report.dryrun_table_md(copy.deepcopy(RECORDS), "h100")
    want = jreport.dryrun_table_md(copy.deepcopy(RECORDS), "h100")
    assert _rows(got) == _rows(want) and len(_rows(got)) == len(RECORDS)
    assert got.splitlines()[:4] == want.splitlines()[:4]


def test_roofline_table_rows_equal_reference_but_the_memory_limit():
    got = _rows(report.roofline_table_md(copy.deepcopy(RECORDS), "h100"))
    want = _rows(jreport.roofline_table_md(copy.deepcopy(RECORDS), "pod256"))
    assert len(got) == len(want) == len(RECORDS)
    for g, w, rec in zip(got, want, sorted(
            RECORDS, key=lambda r: (report.ARCH_ORDER.index(r["arch"]),
                                    report.SHAPE_ORDER.index(r["shape"])))):
        mem = rec.get("memory")
        gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) \
            / 1e9 if mem else 0
        if gb <= 16 or gb > H100_SXM.hbm_bytes / 1e9:
            head = g.rsplit("|", 2)[0]
            assert head == w.rsplit("|", 2)[0]
        if gb <= 16:
            assert g == w
        elif gb <= 80:
            assert "OVER 16GB" in w and g.endswith("|  |")
        else:
            assert "OVER 80GB" in g


def test_roofline_header_names_the_h100():
    head = report.roofline_table_md([], "h100").splitlines()[0]
    assert "1 chip," in head and "989 TF/s" in head and "3350 GB/s" in head
    assert "450 GB/s nvlink4" in head


def _write_cell(d, arch, shape, rec, trace=None):
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{arch}_{shape}.json").write_text(json.dumps(rec))
    if trace is not None:
        trace.write(str(d / f"{arch}_{shape}.trace.jsonl.gz"))


def test_collect_and_summarize(tmp_path):
    a = torch.empty(512, 1024, device="meta")
    b = torch.empty(1024, 256, device="meta")
    trace = TraceRecorder(arguments=(a, b))
    with trace:
        a @ b
    mem = {"argument_size_in_bytes": 1e9, "output_size_in_bytes": 1e6,
           "temp_size_in_bytes": 2e9, "alias_size_in_bytes": 0,
           "generated_code_size_in_bytes": 0}
    _write_cell(tmp_path / "h100", "qwen1.5-0.5b", "decode_32k",
                {"status": "ok", "compile_s": 0.4, "memory": mem,
                 "cost": {"flops": 1.0}}, trace)
    _write_cell(tmp_path / "h100", "gemma-7b", "long_500k",
                {"status": "skipped", "reason": "quadratic"})
    _write_cell(tmp_path / "pod256", "qwen1.5-0.5b", "decode_32k",
                {"status": "ok", "compile_s": 0.0, "memory": mem,
                 "cost": None, "cost_reason": "no partitioner"})
    recs = report.collect(str(tmp_path), "h100")
    rl = {r["arch"]: r for r in recs}["qwen1.5-0.5b"]["roofline"]
    assert rl["flops"] == 2 * 512 * 1024 * 256
    assert rl["t_compute_s"] == pytest.approx(rl["flops"] / 989e12)
    text = report.summarize(str(tmp_path))
    assert "### Dry-run — pod256" in text and "### Dry-run — h100" in text
    assert "### Roofline — h100" in text and "Roofline — pod256" not in text
    assert "| qwen1.5-0.5b | decode_32k | ok | 0.0s | — | — | — | — |" \
        in text
    assert "| gemma-7b | long_500k | — | — | — | — | — | — | SKIP: " \
        "quadratic |" in text


def test_pod_cells_with_a_trace_fill_the_pod_columns(tmp_path):
    """A pod cell traced by the dry run (rank 0's partitioned step, at
    smoke width on pod256): its dry-run row carries the per-device GFLOP,
    bytes and collectives, and the pod gets a roofline table whose model
    FLOP are a device's share."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config, smoke_config
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.launch import dryrun
    arch = "qwen1.5-0.5b"
    full, smoke = get_config(arch), smoke_config(get_config(arch))
    over = {f: getattr(smoke, f) for f in full.__dataclass_fields__
            if getattr(smoke, f) != getattr(full, f)}
    d = tmp_path / "pod256"
    rec = dryrun.run_cell(arch, "decode_32k", mesh_name="pod256",
                          out_dir=str(d), overrides=over, batch_override=16)
    assert rec["status"] == "ok", rec.get("error")
    trace = d / f"{arch}_decode_32k.trace.jsonl.gz"
    assert trace.exists()
    (d / f"{arch}_decode_32k.json").write_text(json.dumps(rec))
    _write_cell(d, "rwkv6-3b", "decode_32k",
                {"status": "ok", "compile_s": 0.0, "memory": rec["memory"],
                 "cost": None, "cost_reason": "no cost: not ported"})
    recs = {r["arch"]: r for r in report.collect(str(tmp_path), "pod256")}
    rl = recs[arch]["roofline"]
    assert rl["flops"] == rec["cost"]["flops"]
    assert rl["coll_ops"]["all_reduce"] > 0 and rl["coll_bytes"] > 0
    assert rl["model_flops"] == model_flops(
        full, SHAPES_BY_NAME["decode_32k"]) / 256
    assert "roofline" not in recs["rwkv6-3b"]
    text = report.summarize(str(tmp_path))
    assert "### Roofline — pod256 (256 chips" in text
    row = next(line for line in text.splitlines()
               if line.startswith(f"| {arch} | decode_32k | ok |"))
    assert "all_reduce:" in row and "—" not in row
    assert "| rwkv6-3b | decode_32k | ok | 0.0s | — | — | — | — |" in text
    assert "| rwkv6-3b | decode_32k | — | — | — | — | — | — | no cost: not " \
        "ported |" in text
