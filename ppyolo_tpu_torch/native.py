"""ctypes binding and on-demand build of the repository's native host library.

Counterpart of ``ppyolo_tpu/native.py``.  The source is the repository's
``native/host_ops.cpp`` (outside either package); g++ builds it on first
use into ``build/host/libhost_ops-<hash>.so``, named by a hash of the
source, the flags and the compiler path as ``ops/_build.py`` names the
kernels, so a stale build is never loaded and the JAX package's own
``native/libhost_ops.so`` is never written.  These are host ops, not
kernels: every caller keeps a numpy fallback (bitwise the same), taken
when the library cannot be built or loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "native" / "host_ops.cpp"
BUILD_DIR = REPO / "build" / "host"
# -march=native vectorizes the fused loader loops; -ffp-contract=off keeps
# them bitwise (no fused multiply-add contraction).  Baseline -O3 if the
# first set is rejected.
FLAG_SETS = (("-O3", "-march=native", "-ffp-contract=off"), ("-O3",))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def lib_path(flags, compiler: str) -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(compiler.encode())
    return BUILD_DIR / f"libhost_ops-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The built library's path (built now if missing), or None."""
    compiler = shutil.which("g++")
    if compiler is None or not SRC.exists():
        return None
    for flags in FLAG_SETS:
        path = lib_path(flags, compiler)
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([compiler, *flags, "-shared", "-fPIC", str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
            continue
        os.replace(tmp, path)
        return path
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built or loaded."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = _build()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _failed = True
            return None
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bbox_iou_xywh.argtypes = [f64p, i64, f64p, i64, u8p, f64p]
        lib.match_greedy.argtypes = [f64p, i64, i64, u8p, u8p, f64p, i64, i64p, i64p]
        lib.gt2yolo_scatter.argtypes = [f32p, i32p, f32p, i32p, i64, i64, i32p, i64, f32p,
                                        f32p, i64, i64, i64, f32p]
        lib.f32_to_u8_rint.argtypes = [f32p, i64, u8p]
        lib.color_distort_u8.argtypes = [u8p, i64, i32p, f32p, i64, f32p]
        lib.color_distort_f32.argtypes = [f32p, i64, i32p, f32p, i64, f32p]
        lib.mixup_u8.argtypes = [u8p, i64, i64, u8p, i64, i64, ctypes.c_float, ctypes.c_float,
                                 i64, u8p]
        for fn in ("bbox_iou_xywh", "match_greedy", "gt2yolo_scatter", "f32_to_u8_rint",
                   "color_distort_u8", "color_distort_f32", "mixup_u8"):
            getattr(lib, fn).restype = None
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> Optional[np.ndarray]:
    """Pairwise xywh IoU with crowd semantics; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    dt = np.ascontiguousarray(dt, np.float64)
    gt = np.ascontiguousarray(gt, np.float64)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    out = np.zeros((len(dt), len(gt)), np.float64)
    lib.bbox_iou_xywh(_ptr(dt, ctypes.c_double), len(dt), _ptr(gt, ctypes.c_double), len(gt),
                      _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def match_greedy(ious: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray,
                 thrs: np.ndarray):
    """Greedy COCO matching; (dt_m [nt, nd], gt_m [nt, ng]) or None.

    g_ignore marks gts excluded from scoring (crowd or out of the area
    range); g_crowd marks only the crowd gts, which several dts may match
    (pycocotools ``evaluateImg``)."""
    lib = get_lib()
    if lib is None:
        return None
    nd, ng = ious.shape
    nt = len(thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    gi = np.ascontiguousarray(g_ignore, np.uint8)
    gc = np.ascontiguousarray(g_crowd, np.uint8)
    th = np.ascontiguousarray(thrs, np.float64)
    dt_m = np.zeros((nt, nd), np.int64)
    gt_m = np.zeros((nt, ng), np.int64)
    lib.match_greedy(_ptr(ious, ctypes.c_double), nd, ng, _ptr(gi, ctypes.c_uint8),
                     _ptr(gc, ctypes.c_uint8), _ptr(th, ctypes.c_double), nt,
                     _ptr(dt_m, ctypes.c_int64), _ptr(gt_m, ctypes.c_int64))
    return dt_m, gt_m


def color_distort(img: np.ndarray, codes: np.ndarray,
                  params: np.ndarray) -> Optional[np.ndarray]:
    """The ColorDistort chain in one pass over an [H, W, 3] image (uint8 or
    float32; other dtypes are cast to float32 first).  ``codes`` int32
    [n_ops] (0/1/2/3 = brightness/contrast/saturation/hue), ``params``
    float32 [n_ops, 12] as ``native/host_ops.cpp`` packs them.  Returns the
    float32 image, or None: the caller then runs the per-op numpy chain."""
    lib = get_lib()
    if lib is None or img.ndim != 3 or img.shape[2] != 3:
        return None
    if img.dtype not in (np.uint8, np.float32):
        img = img.astype(np.float32, copy=False)
    img = np.ascontiguousarray(img)
    codes = np.ascontiguousarray(codes, np.int32)
    params = np.ascontiguousarray(params, np.float32)
    out = np.empty(img.shape, np.float32)
    n_px = img.shape[0] * img.shape[1]
    u8 = img.dtype == np.uint8
    fn = lib.color_distort_u8 if u8 else lib.color_distort_f32
    fn(_ptr(img, ctypes.c_uint8 if u8 else ctypes.c_float), n_px,
       _ptr(codes, ctypes.c_int32), _ptr(params, ctypes.c_float), len(codes),
       _ptr(out, ctypes.c_float))
    return out


def mixup_u8(im1: np.ndarray, im2: np.ndarray, factor: float) -> Optional[np.ndarray]:
    """Mixup blend of two uint8 HWC images with one channel count into a
    [max(h), max(w), C] uint8 canvas, both anchored at the origin; None
    without the library or for other inputs (numpy fallback)."""
    lib = get_lib()
    if (lib is None or im1.dtype != np.uint8 or im2.dtype != np.uint8
            or im1.ndim != 3 or im2.ndim != 3 or im1.shape[2] != im2.shape[2]):
        return None
    im1 = np.ascontiguousarray(im1)
    im2 = np.ascontiguousarray(im2)
    h = max(im1.shape[0], im2.shape[0])
    w = max(im1.shape[1], im2.shape[1])
    out = np.empty((h, w, im1.shape[2]), np.uint8)
    lib.mixup_u8(_ptr(im1, ctypes.c_uint8), im1.shape[0], im1.shape[1],
                 _ptr(im2, ctypes.c_uint8), im2.shape[0], im2.shape[1],
                 np.float32(factor), np.float32(1.0 - factor), im1.shape[2],
                 _ptr(out, ctypes.c_uint8))
    return out


def pack_u8(src: np.ndarray, dst: np.ndarray) -> bool:
    """``dst[...] = clip(rint(src), 0, 255)`` in one pass (half to even, as
    ``np.rint``).  ``src`` contiguous float32, ``dst`` contiguous uint8 of
    the same size.  False without the library (numpy fallback)."""
    lib = get_lib()
    if lib is None:
        return False
    if not (src.dtype == np.float32 and src.flags.c_contiguous
            and dst.dtype == np.uint8 and dst.flags.c_contiguous and src.size == dst.size):
        raise ValueError(f"pack_u8: contiguous float32 -> uint8 of one size, got "
                         f"{src.dtype} {src.shape} -> {dst.dtype} {dst.shape}")
    lib.f32_to_u8_rint(_ptr(src, ctypes.c_float), src.size, _ptr(dst, ctypes.c_uint8))
    return True
