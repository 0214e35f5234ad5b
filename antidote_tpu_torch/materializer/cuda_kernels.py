"""Hand-written Hopper kernels of the materializer hot path, and their plain
PyTorch versions.

Four kernels live in ``antidote_tpu_torch/csrc/materializer.cu``:

* ``orset_presence`` — the OR-set presence test behind every ``set_aw``
  resolve (replaces ``pallas_kernels.py::_presence_kernel``), as a mask
  (``orset_presence``) or fused with the resolve's top-K compaction
  (``orset_resolve``); both forms count as ``orset_presence`` launches;
* ``counter_fold`` — the ``counter_pn`` ring fold, a masked int64 sum
  (replaces ``_counter_fold_kernel``);
* ``set_aw_fold`` — the add-wins ring fold (replaces
  ``_set_aw_fold_kernel``);
* ``stable_min`` — the column-wise min of a clock matrix, the stable-time
  merge over a cluster's shard rows (replaces ``_stable_min_kernel``).

Each wrapper dispatches on where its tensors live: CPU tensors run the
plain version (the CPU tests' path and the kernels' oracle), CUDA tensors
launch the kernel or raise.  Nothing falls back.  ``LAUNCHES`` counts the
kernel launches per name, so a run can show that its path went through
the kernels; ``LAUNCHES_BY_DEVICE`` splits them by CUDA device, and
``LAUNCHES_BY_BLOCK`` by the shard block of a placed table whose work
made them (``on_block``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use into
``antidote_tpu_torch/_build/`` (named by the source's hash, so an edited
source rebuilds) and bound through its C entry points with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from antidote_tpu_torch.materializer import fold as fold_mod

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "materializer.cu"
BUILD_DIR = _PKG / "_build"

#: kernel name -> launches since the last reset
LAUNCHES = {"orset_presence": 0, "counter_fold": 0, "set_aw_fold": 0,
            "stable_min": 0}
#: (kernel name, CUDA device index) -> launches since the last reset
LAUNCHES_BY_DEVICE: dict = {}
#: (kernel name, shard block) -> launches since the last reset, of the
#: launches made inside ``on_block``
LAUNCHES_BY_BLOCK: dict = {}
_block = threading.local()
INT32_MAX = 2**31 - 1
#: stable_min runs as one block up to this many elements (the cluster
#: path's 2048 x 4 among them), as a grid of at most this many blocks past it
STABLE_MIN_ONE_BLOCK = 1 << 15
STABLE_MIN_MAX_PARTS = 4096

_lib = None
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_DEVICE.clear()
    LAUNCHES_BY_BLOCK.clear()


@contextlib.contextmanager
def on_block(b: int):
    """Tag this thread's launches inside the block with shard block ``b``
    (a placed table's work on one of its blocks)."""
    prev = getattr(_block, "b", None)
    _block.b = b
    try:
        yield
    finally:
        _block.b = prev


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple:
    """Compile the kernels' source for sm_90a (once per source version).
    Returns (path of the shared library, the compiler's resource report,
    empty when the library was already built)."""
    src = SOURCE.read_bytes()
    lib = BUILD_DIR / f"libmaterializer_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) on {SOURCE}:\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, res.stderr


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.materializer_error_string.restype = ctypes.c_char_p
        lib.materializer_error_string.argtypes = [_I]
        lib.orset_presence_launch.restype = _I
        lib.orset_presence_launch.argtypes = [_P] * 4 + [_LL, _I, _I, _P]
        lib.orset_resolve_launch.restype = _I
        lib.orset_resolve_launch.argtypes = [_P] * 5 + [_LL] + [_I] * 3 + [_P]
        lib.counter_fold_launch.restype = _I
        lib.counter_fold_launch.argtypes = [_P] * 8 + [_LL] * 3 + [_I, _I,
                                                                  _P]
        lib.empty_launch.restype = _I
        lib.empty_launch.argtypes = [_P]
        lib.set_aw_fold_launch.restype = _I
        lib.set_aw_fold_launch.argtypes = [_P] * 16 + [_LL] + [_I] * 5 + [_P]
        lib.set_aw_fold_variant.restype = ctypes.c_char_p
        lib.set_aw_fold_variant.argtypes = [_I, _I]
        lib.set_aw_fold_variant_names.restype = ctypes.c_char_p
        lib.set_aw_fold_variant_names.argtypes = []
        lib.stable_min_launch.restype = _I
        lib.stable_min_launch.argtypes = [_P, _P, _P, _I, _LL, _I, _P]
        _lib = lib
    return _lib


def _on_cuda(name: str, first: torch.Tensor, *rest: torch.Tensor) -> bool:
    """True for a CUDA launch, False for the plain CPU path; every
    operand must share the first one's device."""
    dev = first.device
    for t in rest:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _expect(name: str, arg: str, t: torch.Tensor, dtype, shape,
            contiguous: bool = True) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")


def _launch(name: str, device, entry, *args) -> None:
    """Launch ``entry`` on ``device``'s current stream and count it under
    ``name`` (None: counted nowhere)."""
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.materializer_error_string(err).decode()
        raise RuntimeError(f"{entry}: kernel launch failed ({err}): {msg}")
    if name is not None:
        LAUNCHES[name] += 1
        key = (name, torch.device(device).index or 0)
        LAUNCHES_BY_DEVICE[key] = LAUNCHES_BY_DEVICE.get(key, 0) + 1
        b = getattr(_block, "b", None)
        if b is not None:
            LAUNCHES_BY_BLOCK[(name, b)] = (
                LAUNCHES_BY_BLOCK.get((name, b), 0) + 1)


def launch_floor(device) -> None:
    """One launch of an empty kernel through the same ``ctypes`` path: the
    floor under every kernel's time.  Counted by no path."""
    _launch(None, device, "empty_launch")


# ---------------------------------------------------------------------------
# orset_presence
# ---------------------------------------------------------------------------
def orset_presence_plain(addvc, rmvc, elems):
    return (addvc > rmvc).any(-1) & (elems != 0)


def orset_presence(addvc, rmvc, elems):
    """OR-set element presence: ``addvc``/``rmvc`` int32[B, E, D],
    ``elems`` int64[B, E] → bool[B, E], present ⟺ (∃d: addvc > rmvc) ∧
    the slot holds a handle (any of its 64 bits set)."""
    if not _on_cuda("orset_presence", addvc, rmvc, elems):
        return orset_presence_plain(addvc, rmvc, elems)
    b, e, d = _orset_shape("orset_presence", addvc, rmvc, elems)
    out = torch.empty((b, e), dtype=torch.bool, device=addvc.device)
    if b * e:
        _launch("orset_presence", addvc.device, "orset_presence_launch",
                addvc.data_ptr(), rmvc.data_ptr(), elems.data_ptr(),
                out.data_ptr(), b, e, d)
    return out


def orset_resolve_plain(elems, addvc, rmvc, top: int):
    from antidote_tpu_torch.crdt.base import compact_top

    return compact_top(elems, orset_presence_plain(addvc, rmvc, elems), top)


def orset_resolve(elems, addvc, rmvc, top: int):
    """The ``set_aw`` resolve: presence and top-K compaction in one launch.
    ``elems`` int64[B, E], ``addvc``/``rmvc`` int32[B, E, D] → (the first
    ``top`` present handles in slot order, zero-padded, int64[B, min(top,
    E)]; the number present int32[B], also past ``top``), bit for bit
    ``compact_top(elems, orset_presence(addvc, rmvc, elems), top)``."""
    if not _on_cuda("orset_resolve", elems, addvc, rmvc):
        return orset_resolve_plain(elems, addvc, rmvc, top)
    b, e, d = _orset_shape("orset_resolve", addvc, rmvc, elems)
    if top < 0:
        raise ValueError(f"orset_resolve: top = {top} < 0")
    t = min(top, e)
    out = torch.empty((b, t), dtype=torch.int64, device=elems.device)
    count = torch.empty((b,), dtype=torch.int32, device=elems.device)
    if b:
        _launch("orset_presence", elems.device, "orset_resolve_launch",
                addvc.data_ptr(), rmvc.data_ptr(), elems.data_ptr(),
                out.data_ptr(), count.data_ptr(), b, e, d, t)
    return out, count


def _orset_shape(name, addvc, rmvc, elems) -> tuple:
    if addvc.dim() != 3:
        raise ValueError(f"{name}: addvc has shape {tuple(addvc.shape)}, "
                         "expected (B, E, D)")
    b, e, d = addvc.shape
    _expect(name, "addvc", addvc, torch.int32, (b, e, d))
    _expect(name, "rmvc", rmvc, torch.int32, (b, e, d))
    _expect(name, "elems", elems, torch.int64, (b, e))
    return b, e, d


# ---------------------------------------------------------------------------
# counter_fold
# ---------------------------------------------------------------------------
def counter_fold_plain(base_cnt, deltas, ops_vc, n_ops, base_vc, read_vc):
    k = deltas.shape[1]
    slots = torch.arange(k, device=deltas.device)
    include = (
        ~(ops_vc <= base_vc[:, None, :]).all(-1)
        & (ops_vc <= read_vc[:, None, :]).all(-1)
        & (slots[None, :] < n_ops[:, None])
    )
    total = torch.where(include, deltas, torch.zeros_like(deltas)).sum(-1)
    return base_cnt + total, include.sum(-1, dtype=torch.int32)


def counter_fold(base_cnt, deltas, ops_vc, n_ops, base_vc, read_vc):
    """counter_pn ring fold: ``base_cnt`` int64[B], ``deltas`` int64[B, K]
    (effect lane 0; any strides, so lane 0 of the ring's int64[B, K, A]
    effect lanes passes as a view), ``ops_vc`` int32[B, K, D], ``n_ops``
    int32[B], ``base_vc``/``read_vc`` int32[B, D] → (cnt int64[B], applied
    int32[B]).

    The sum is int64 on both paths, so it equals ``fold.fold_batch`` for any
    delta; the JAX package's int32 kernel sum needed the
    ``|delta| ≤ INT32_MAX // K`` gate this port does without."""
    args = (base_cnt, deltas, ops_vc, n_ops, base_vc, read_vc)
    if not _on_cuda("counter_fold", *args):
        return counter_fold_plain(*args)
    if ops_vc.dim() != 3:
        raise ValueError(f"counter_fold: ops_vc has shape "
                         f"{tuple(ops_vc.shape)}, expected (B, K, D)")
    b, k, d = ops_vc.shape
    _expect("counter_fold", "base_cnt", base_cnt, torch.int64, (b,))
    _expect("counter_fold", "deltas", deltas, torch.int64, (b, k),
            contiguous=False)
    _expect("counter_fold", "ops_vc", ops_vc, torch.int32, (b, k, d))
    _expect("counter_fold", "n_ops", n_ops, torch.int32, (b,))
    _expect("counter_fold", "base_vc", base_vc, torch.int32, (b, d))
    _expect("counter_fold", "read_vc", read_vc, torch.int32, (b, d))
    cnt = torch.empty((b,), dtype=torch.int64, device=deltas.device)
    applied = torch.empty((b,), dtype=torch.int32, device=deltas.device)
    if b:
        _launch("counter_fold", deltas.device, "counter_fold_launch",
                *(t.data_ptr() for t in args), cnt.data_ptr(),
                applied.data_ptr(), b, deltas.stride(0), deltas.stride(1),
                k, d)
    return cnt, applied


# ---------------------------------------------------------------------------
# set_aw_fold
# ---------------------------------------------------------------------------
def set_aw_fold_plain(state, ops_a, ops_b, ops_vc, ops_origin, n_ops,
                      base_vc, read_vc):
    from antidote_tpu_torch.crdt.sets import SetAW

    return fold_mod.fold_batch(SetAW(), None, state, ops_a, ops_b, ops_vc,
                               ops_origin, n_ops, base_vc, read_vc)


def set_aw_fold_variants() -> list:
    """Names of the ``set_aw_fold`` kernel variants (builds the kernels)."""
    return _load().set_aw_fold_variant_names().decode().split(",")


def set_aw_fold_variant(e: int, d: int) -> str:
    """The variant the CUDA wrapper launches for E slots and D clock lanes
    (chosen by shape only; builds the kernels)."""
    return _load().set_aw_fold_variant(e, d).decode()


def set_aw_fold(state, ops_a, ops_b, ops_vc, ops_origin, n_ops, base_vc,
                read_vc):
    """set_aw ring fold: ``state`` = {elems int64[B, E], addvc/rmvc
    int32[B, E, D], ovf int32[B]}, ``ops_a`` int64[B, K, A] (lane 0 = the
    element handle), ``ops_b`` int32[B, K, 1+D] (kind + observed add VC),
    ``ops_vc`` int32[B, K, D], ``ops_origin`` int32[B, K], ``n_ops``
    int32[B], ``base_vc``/``read_vc`` int32[B, D].  Returns (state,
    applied int32[B]), equal to ``fold.fold_batch`` with ``SetAW``."""
    ins = (state["elems"], state["addvc"], state["rmvc"], state["ovf"],
           ops_a, ops_b, ops_vc, ops_origin, n_ops, base_vc, read_vc)
    if not _on_cuda("set_aw_fold", *ins):
        return set_aw_fold_plain(state, ops_a, ops_b, ops_vc, ops_origin,
                                 n_ops, base_vc, read_vc)
    b, e, d = state["addvc"].shape
    k, a_w, b_w = ops_a.shape[1], ops_a.shape[2], ops_b.shape[2]
    if d > 32 or b_w < 1 + d or a_w < 1:
        raise ValueError(f"set_aw_fold: unsupported lanes D={d}, A={a_w}, "
                         f"B={b_w} (needs D <= 32, A >= 1, B >= 1 + D)")
    for arg, dt, shape in (
        ("elems", torch.int64, (b, e)), ("addvc", torch.int32, (b, e, d)),
        ("rmvc", torch.int32, (b, e, d)), ("ovf", torch.int32, (b,)),
    ):
        _expect("set_aw_fold", arg, state[arg], dt, shape)
    _expect("set_aw_fold", "ops_a", ops_a, torch.int64, (b, k, a_w))
    _expect("set_aw_fold", "ops_b", ops_b, torch.int32, (b, k, b_w))
    _expect("set_aw_fold", "ops_vc", ops_vc, torch.int32, (b, k, d))
    _expect("set_aw_fold", "ops_origin", ops_origin, torch.int32, (b, k))
    _expect("set_aw_fold", "n_ops", n_ops, torch.int32, (b,))
    _expect("set_aw_fold", "base_vc", base_vc, torch.int32, (b, d))
    _expect("set_aw_fold", "read_vc", read_vc, torch.int32, (b, d))
    out = {f: torch.empty_like(state[f])
           for f in ("elems", "addvc", "rmvc", "ovf")}
    applied = torch.empty((b,), dtype=torch.int32, device=ops_vc.device)
    if b:
        _launch("set_aw_fold", ops_vc.device, "set_aw_fold_launch",
                *(t.data_ptr() for t in ins),
                *(out[f].data_ptr() for f in ("elems", "addvc", "rmvc",
                                               "ovf")),
                applied.data_ptr(), b, k, e, d, a_w, b_w)
    return out, applied


# ---------------------------------------------------------------------------
# stable_min
# ---------------------------------------------------------------------------
def stable_min_plain(clocks):
    if clocks.shape[0] == 0:
        return torch.full((clocks.shape[1],), INT32_MAX, dtype=torch.int32,
                          device=clocks.device)
    return torch.amin(clocks, 0)


def stable_min(clocks):
    """Column-wise min of a clock matrix: ``clocks`` int32[N, D] →
    int32[D].  INT32_MAX rows are the identity, and N = 0 gives all
    INT32_MAX.  Exact for any int32 values and any D ≥ 1."""
    if not _on_cuda("stable_min", clocks):
        return stable_min_plain(clocks)
    if clocks.dim() != 2 or clocks.shape[1] < 1:
        raise ValueError(f"stable_min: clocks has shape "
                         f"{tuple(clocks.shape)}, expected (N, D >= 1)")
    n, d = clocks.shape
    _expect("stable_min", "clocks", clocks, torch.int32, (n, d))
    if not n:
        return torch.full((d,), INT32_MAX, dtype=torch.int32,
                          device=clocks.device)
    # one launch that stores each output once: one block up to
    # STABLE_MIN_ONE_BLOCK elements, else a grid whose blocks leave their
    # column minima in a per-call partials buffer
    out = torch.empty((d,), dtype=torch.int32, device=clocks.device)
    parts = None
    if n * d > STABLE_MIN_ONE_BLOCK:
        parts = torch.empty((STABLE_MIN_MAX_PARTS * d,), dtype=torch.int32,
                            device=clocks.device)
    _launch("stable_min", clocks.device, "stable_min_launch",
            clocks.data_ptr(), out.data_ptr(),
            None if parts is None else parts.data_ptr(),
            STABLE_MIN_MAX_PARTS, n, d)
    return out
