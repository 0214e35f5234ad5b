"""The port stands alone: no module of ``antidote_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or any module of the JAX package — read
from the sources (AST) and checked again in a fresh interpreter."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "antidote_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "antidote_tpu")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in SOURCES if p.parent != ROOT)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_cover_every_subpackage():
    """The walk above reaches every subpackage of the port, the cluster
    slice's, the metrics registry's, the durable log's, the wire front
    end's and the native front end's included."""
    pkgs = {p.parent.name for p in SOURCES if p.parent != ROOT}
    assert {"api", "clock", "cluster", "crdt", "faults", "log",
            "materializer", "meta", "obs", "proto", "store", "txn"} <= pkgs
    assert {p.name for p in SOURCES if p.parent.name == "proto"} >= {
        "__init__.py", "apb.py", "client.py", "codec.py", "server.py",
        "native_frontend.py"}
    assert {p.name for p in SOURCES
            if p.parent.name == "antidote_tpu_torch"} >= {
        "console.py", "overload.py", "supervise.py", "tenancy.py",
        "native_build.py"}
    assert {p.name for p in SOURCES if p.parent.name == "cluster"} >= {
        "__init__.py", "rpc.py", "member.py", "coordinator.py"}
