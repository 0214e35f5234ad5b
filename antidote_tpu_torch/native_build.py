"""Shared build + provenance helper for the port's native ``.so`` planes.

Every C++ module of the port (``log/cpp/wal.cc``, ``proto/cpp/frontend.cc``,
``store/cpp/router.cc``, ``interdc/cpp/pump.cc``) compiles through ONE pinned flag set, and every
build embeds the sha256 of its source as ``ANTIDOTE_SRC_SHA`` (each module
exports a ``<name>_src_sha()`` getter).  A build is made with g++ at first
use into ``antidote_tpu_torch/_build/``, named by the source's hash, so an
edited source rebuilds and no binary is committed.  The compiler writes a
temporary file that is renamed into place: processes building the same
source at once (test workers) never load a half-written library.

    python -m antidote_tpu_torch.native_build           # build every module
    python -m antidote_tpu_torch.native_build --check   # embedded sha == source
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

#: the ONE compile line — every loader builds with it
PINNED_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"

#: (source, library stem, exported sha getter) for every native plane
MODULES: List[Tuple[Path, str, str]] = [
    (_PKG / "log" / "cpp" / "wal.cc", "wal", "wal_src_sha"),
    (_PKG / "proto" / "cpp" / "frontend.cc", "frontend", "frontend_src_sha"),
    (_PKG / "store" / "cpp" / "router.cc", "router", "router_src_sha"),
    (_PKG / "interdc" / "cpp" / "pump.cc", "pump", "pump_src_sha"),
]


class NativeBuildError(RuntimeError):
    """A native module could not be built (no compiler, or g++ refused the
    source)."""


def src_sha(src: Path) -> str:
    return hashlib.sha256(Path(src).read_bytes()).hexdigest()


def lib_path(src: Path, stem: str) -> Path:
    """Where the build of ``src``'s current contents lives."""
    return BUILD_DIR / f"lib{stem}_{src_sha(src)[:16]}.so"


def build(src: Path, out: Path) -> str:
    """Compile ``src`` into ``out`` with the pinned flags, embedding the
    source sha; returns the sha.  Raises :class:`NativeBuildError`."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(f"g++ not found: {Path(src).name} cannot be "
                               "built")
    sha = src_sha(src)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(
            [cxx, *PINNED_FLAGS, f'-DANTIDOTE_SRC_SHA="{sha}"', str(src),
             "-o", str(tmp)], capture_output=True, text=True)
        if res.returncode != 0:
            raise NativeBuildError(
                f"g++ failed on {Path(src).name} (rc {res.returncode}): "
                f"{res.stderr.strip()[-2000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if tmp.exists():
            tmp.unlink()
    return sha


def ensure(src: Path, stem: str) -> Path:
    """The library of ``src``'s current contents, built first when it is
    missing (the lazy first-use compile the loaders share)."""
    out = lib_path(src, stem)
    if not out.exists():
        build(src, out)
    return out


def embedded_sha(so: Path, getter: str) -> Optional[str]:
    """The source sha a built library carries, or None when it exports no
    getter (built outside this helper)."""
    try:
        fn = getattr(ctypes.CDLL(str(so)), getter)
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_char_p
    fn.argtypes = []
    out = fn()
    return out.decode() if out else None


def check() -> List[str]:
    """One problem string per module whose library is missing or carries
    another source's sha (empty list = every build matches its source)."""
    problems = []
    for src, stem, getter in MODULES:
        so = lib_path(src, stem)
        if not so.exists():
            problems.append(f"{so.name}: missing (run `python -m "
                            "antidote_tpu_torch.native_build`)")
            continue
        got, want = embedded_sha(so, getter), src_sha(src)
        if got != want:
            problems.append(f"{so.name}: embeds {str(got)[:12]}…, "
                            f"{src.name} is {want[:12]}…")
    return problems


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        problems = check()
        for p in problems:
            print(f"native-check: {p}")
        if not problems:
            print(f"native-check: {len(MODULES)} libraries match source")
        return 1 if problems else 0
    for src, stem, _getter in MODULES:
        so = ensure(src, stem)
        print(f"built {so.relative_to(_PKG.parent)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
