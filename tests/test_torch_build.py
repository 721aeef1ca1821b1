"""The kernel build's cache key, on the CPU (no ``nvcc`` is called): the
library is named by a hash of the flags, the CUDA sources and the headers
they share, so an edited header never loads a stale build."""
import re
import shutil

from repro_torch.kernels import build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_build_tag_follows_sources_and_headers(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc holds no shared header"
    tag = build.build_tag()
    assert build.build_tag() == tag                 # stays put
    (csrc / "notes.txt").write_text("not a source")
    assert build.build_tag() == tag                 # other files ignored
    for path in headers + sorted(csrc.glob("*.cu")):
        original = path.read_bytes()
        path.write_bytes(original + b"\n// edited\n")
        assert build.build_tag() != tag, path.name
        path.write_bytes(original)
        assert build.build_tag() == tag, path.name


def test_every_included_header_is_hashed():
    """Each header a source includes by a quoted name lives in csrc as a
    ``.cuh``, so its bytes are part of the build tag."""
    hashed = {p.name for p in build.CSRC.glob("*.cuh")}
    included = set()
    for src in build.CSRC.glob("*.cu*"):
        included |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert included
    assert included <= hashed
