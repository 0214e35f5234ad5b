"""The port's shared native build: every library embeds the sha256 of the
source it was built from, an edited source builds a new library, and
processes building one source at once all load a whole library (the
compiler writes a temporary file that is renamed into place)."""

import subprocess
import sys
from pathlib import Path

import pytest

from antidote_tpu_torch import native_build

ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.smoke


@pytest.mark.parametrize("src,stem,getter", native_build.MODULES,
                         ids=[m[1] for m in native_build.MODULES])
def test_embedded_sha_equals_the_source(src, stem, getter):
    so = native_build.ensure(src, stem)
    assert so.parent == native_build.BUILD_DIR
    assert native_build.embedded_sha(so, getter) == native_build.src_sha(src)
    assert so.name == f"lib{stem}_{native_build.src_sha(src)[:16]}.so"


def test_check_reports_every_module_built():
    for src, stem, _g in native_build.MODULES:
        native_build.ensure(src, stem)
    assert native_build.check() == []


def test_an_edited_source_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "router.cc"
    text = (ROOT / "antidote_tpu_torch/store/cpp/router.cc").read_text()
    src.write_text(text)
    first = native_build.ensure(src, "router")
    assert native_build.ensure(src, "router") == first  # built once
    src.write_text(text + "\n// an edit\n")
    second = native_build.ensure(src, "router")
    assert second != first and second.exists() and first.exists()
    assert native_build.embedded_sha(second, "router_src_sha") == \
        native_build.src_sha(src)
    assert native_build.embedded_sha(first, "router_src_sha") != \
        native_build.src_sha(src)


def test_a_refused_source_raises_typed(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    with pytest.raises(native_build.NativeBuildError, match="bad.cc"):
        native_build.ensure(src, "bad")
    assert not list((tmp_path / "build").glob("*"))  # no half-written file


def test_concurrent_first_builds_all_load(tmp_path):
    """Four processes build one fresh source at once; each loads the
    library and hashes with it."""
    src = tmp_path / "router.cc"
    src.write_text((ROOT / "antidote_tpu_torch/store/cpp/router.cc")
                   .read_text() + "\n// fresh\n")
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from antidote_tpu_torch import native_build as nb\n"
        f"nb.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        f"so = nb.ensure(Path({str(src)!r}), 'router')\n"
        "lib = ctypes.CDLL(str(so))\n"
        "lib.router_hash64.restype = ctypes.c_uint64\n"
        "lib.router_hash64.argtypes = [ctypes.c_char_p, ctypes.c_uint64,"
        " ctypes.c_uint64]\n"
        "print(lib.router_hash64(b'abc', 3, 0))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(int(out))
    assert outs == [0x44BC2CF5AD770999] * 4
    built = list((tmp_path / "build").glob("*"))
    assert [b.suffix for b in built] == [".so"]  # no temporary left behind
