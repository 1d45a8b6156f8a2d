"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
library file is named by a hash of its source, the headers beside it, the
flags and the nvcc path, so a stale build is never loaded.  Output goes to
``build/kernels/`` at the repository root (git-ignored).  Nothing here runs
at import: the CPU tests import every module and have no nvcc.

``build_all`` starts one nvcc per source at once, so the build takes as
long as the slowest file.

Each kernel's launch wrapper is ``counted``: ``fn.launches`` counts the
launches of its kernel and ``fn.captured`` the calls that a CUDA graph
recorded instead (a capture launches nothing).  ``train/graphs.py`` adds a
graph's recorded calls to ``launches`` at each replay, which is where those
kernels launch.

Where a kernel's place in a program is reached -- the kernel launched on
a card, or its plain version run on the CPU -- its wrapper reports the
call with its FLOPs (``note_call``) to every open ``recording_calls()``
block: ``utils/mfu.py`` adds the launched kernels' FLOPs to what
``FlopCounterMode`` counts.  With no block open a report costs one test.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("dcn_fwd", "dcn_bwd", "fused_stem", "conv_s2", "conv_int8", "nms_keep",
           "bn_train")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) of each
# library ``build_all`` returned; kept beside the library as
# ``lib<name>-<hash>.ptxas.txt`` and read back when the library is cached
PTXAS_REPORT: Dict[str, str] = {}


# every counted launch wrapper, in the order the modules defined them
COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Give the launch wrapper ``fn`` its counts (see the module docstring)."""
    fn.launches = 0
    fn.captured = 0
    COUNTED.append(fn)
    return fn


def note_launch(fn: Callable) -> None:
    """Called by ``fn`` where it hands its kernel to the current stream: a
    launch, or under a CUDA graph's capture a call the graph records."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


_RECORDERS: List[list] = []   # the open recording_calls() blocks' lists


def recording() -> bool:
    """Is a ``recording_calls()`` block open (so a wrapper should report)?"""
    return bool(_RECORDERS)


def note_call(name: str, flops: float, launched: bool) -> None:
    """Report a call of kernel ``name`` (``launched``: the kernel ran; else its
    plain version did) with its FLOPs (``utils/mfu.py``'s formula) to every
    open ``recording_calls()`` block.  Any thread: a backward reports from
    autograd's device thread."""
    for rec in _RECORDERS:
        rec.append((name, float(flops), bool(launched)))


@contextlib.contextmanager
def recording_calls():
    """Yields the list that the kernel calls inside the block fill, in order."""
    calls: list = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Raises with nvcc's output if a compile fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        path = _lib_path(name, nvcc)
        paths[name] = path
        if path.exists():
            report = _report_path(path)
            PTXAS_REPORT[name] = report.read_text() if report.exists() else ""
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        PTXAS_REPORT[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n{out}")
            continue
        _report_path(path).write_text(out)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _LIBS[name] = lib
    return lib
