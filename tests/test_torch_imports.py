"""Guards on the PyTorch port: it imports neither JAX nor anything of the
JAX package (even modules of it that hold no JAX, such as the coordinator,
the control loop and the fault injector, of which it keeps its own copies),
and the source guards the CI applies to ``src/`` hold for it too, with
port twins of the ones pinned to reference files: the engine makes no
per-request call, the admission controller raises no builtin exception,
and each lifecycle mutation occurs once in the engine. No file of the port names
``scaled_dot_product_attention`` or ``torch.compile``; ``chip_smoke.py``
may name the former only inside the one function that times it as the
flash kernels' yardstick (``LIBRARY_FN``, found with ``ast``)."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
LIBRARY_FN = "library_attention_ms"
LIBRARY_NAME = "scaled_dot_product_attention"


def _library_fn_lines(path):
    """Line numbers of chip_smoke.py's ``LIBRARY_FN`` (empty elsewhere)."""
    if path.name != "chip_smoke.py":
        return set()
    tree = ast.parse(path.read_text(), filename=str(path))
    fns = [n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef) and n.name == LIBRARY_FN]
    assert len(fns) == 1, f"{path}: {len(fns)} functions {LIBRARY_FN}"
    return set(range(fns[0].lineno, fns[0].end_lineno + 1))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("configs/base.py", "configs/qwen1_5_0_5b.py",
                 "configs/rwkv6_3b.py",
                 "core/errors.py", "core/perfmodel.py", "core/aqua_tensor.py",
                 "core/coordinator.py", "core/control_loop.py",
                 "core/faults.py", "core/workload.py",
                 "serving/admission.py",
                 "kernels/kv_gather/ops.py", "kernels/kv_gather/ref.py",
                 "kernels/paged_attention/ops.py",
                 "kernels/paged_attention/ref.py",
                 "kernels/rwkv6_wkv/ops.py", "kernels/rwkv6_wkv/ref.py",
                 "layers/core.py", "layers/attention.py", "layers/rwkv6.py",
                 "models/lm.py", "models/api.py",
                 "params.py", "serving/scheduler.py", "serving/kv_cache.py",
                 "serving/engine.py", "launch/serve.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py", "models/losses.py",
                 "training/data.py", "training/optimizer.py",
                 "training/checkpoint.py", "training/train_loop.py",
                 "launch/train.py"):
        assert want in names, want
    assert (ROOT / "chip_smoke.py").exists()
    for cu in ("kv_gather.cu", "paged_attention.cu", "wkv6.cu",
               "flash_attention.cu"):
        assert (PORT / "csrc" / cu).exists(), cu


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.mark.parametrize("pattern", [
    r"interpret=True", r"except Exception|raise Exception",
    r"ContextStore|pack_context|extract_slot|insert_slot",
    r"scaled_dot_product_attention|torch\.compile"])
def test_source_guards(pattern):
    for path in FILES:
        allowed = _library_fn_lines(path) if LIBRARY_NAME in pattern \
            else set()
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if i in allowed:
                line = line.replace(LIBRARY_NAME, "")
            assert not re.search(pattern, line), f"{path}:{i}: {line}"


def test_engine_calls_no_per_request_entry_point():
    """The port's twin of the reference's CI guard on its engine: the
    engine's only model entry point is the fused ``serve_step_paged``; the
    per-request entry points are API calls for tests and ``chip_smoke.py``."""
    path = PORT / "serving" / "engine.py"
    for i, line in enumerate(path.read_text().splitlines(), 1):
        assert not re.search(r"prefill_chunk_paged|decode_step_paged",
                             line), f"{path}:{i}: {line}"


def test_admission_raises_no_builtin_exception():
    """Twin of the reference's CI guard on ``serving/admission.py``: it
    raises only typed ``AquaError`` subclasses (``AdmissionError``)."""
    path = PORT / "serving" / "admission.py"
    pattern = (r"raise (ValueError|TypeError|KeyError|RuntimeError|"
               r"AssertionError|NotImplementedError)")
    text = path.read_text()
    assert "raise AdmissionError" in text
    for i, line in enumerate(text.splitlines(), 1):
        assert not re.search(pattern, line), f"{path}:{i}: {line}"


@pytest.mark.parametrize("mutation", [
    "self._free_slots.append(", "self.kv.release(", "self.finished.append(",
    "self._free_slots.pop("])
def test_engine_lifecycle_mutations_occur_once(mutation):
    """Twin of the reference's CI lifecycle guard: batch-slot, page-release
    and finished-list mutations stay inside the lifecycle helpers, so
    finish, cancel, deadlines, drain and recovery share one teardown."""
    text = (PORT / "serving" / "engine.py").read_text()
    assert text.count(mutation) == 1, mutation


def test_chip_smoke_times_the_library_attention_in_one_function():
    path = ROOT / "chip_smoke.py"
    lines = path.read_text().splitlines()
    inside = _library_fn_lines(path)
    named = {i for i, line in enumerate(lines, 1) if LIBRARY_NAME in line}
    assert named and named <= inside, sorted(named - inside)
