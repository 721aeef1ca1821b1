"""Guards on the PyTorch port: it imports neither JAX nor anything of the
JAX package (even modules of it that hold no JAX), and the source guards
the CI applies to ``src/`` hold for it too."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                 "kernels/kv_gather/ops.py", "kernels/kv_gather/ref.py",
                 "kernels/paged_attention/ops.py",
                 "kernels/paged_attention/ref.py",
                 "kernels/rwkv6_wkv/ops.py", "kernels/rwkv6_wkv/ref.py",
                 "layers/core.py", "layers/attention.py", "layers/rwkv6.py",
                 "models/lm.py", "models/api.py",
                 "params.py", "serving/scheduler.py", "serving/kv_cache.py",
                 "serving/engine.py", "launch/serve.py"):
        assert want in names, want
    assert (ROOT / "chip_smoke.py").exists()
    assert (PORT / "csrc" / "wkv6.cu").exists()


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
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not re.search(pattern, line), f"{path}:{i}: {line}"
