"""Time the port's kernels against an earlier build of the same kernels, kernel alone.

Both versions get the same inputs at the shapes their paths give them (K4:
the probe's stage3_0 and stage4_0 convs, K2: a b8@608 batch, K1 and K3:
ppyolo_2x's stage-5 DCNs at b8@608, 38x38/s2 and 19x19/s1; bf16; K5: the
32 shapes of ppyolo_2x@608 b8's 65 int8 convs, a static scale), with
their weights packed once, outside the timed window, in the layout each
reads.  Each is held against the plain version first (max-abs error <= 2%
of the plain output's max-abs; K3: dx, d_om and cols; K5 bit-equal), then timed with CUDA
events over 20 warm launches in the order earlier, current, current,
earlier; K1, K3 and K5 inside a CUDA graph of the 20 launches
(``graph_ms``), so that their wrappers' host work is not what is timed.  K3's earlier call
zeroes its dx first (its first form added into dx).

The earlier version is given as a directory of CUDA sources with the C
interface of the kernels that preceded each redesign:

  conv_s2_launch(x, w, y, is_f32, N, H, W, C, Co, stream), w [9*C, Co]
  fused_stem_launch(x, w1, b1, w2, b2, w3, b3, y, N, H, W, stream),
      w1 fp32 and w2, w3 bf16, all HWIO; b1, b2, b3 fp32
  dcn_fwd_launch(x, om, w, bias, y, is_f32, N, H, W, C, oH, oW, outC, kh,
      kw, stride, pad, stream), w [k2*C, outC] bf16
  dcn_bwd_launch(x, om, dm, dx, d_om, cols, is_f32, N, H, W, C, oH, oW, kh,
      kw, stride, pad, stream), dx zeroed by the caller
  conv_int8_launch(x, w, w_scale, s_x, bias, y, N, H, W, C, Co, k, stride,
      oH, oW, stream), w K-major [Co, k*k*Cp] int8 with each tap's channels
      zero-padded to Cp = C rounded up to 16 (K5's first form, commit
      ``76e2a95``: mma.sync, the activation quantized on load); with
      ``--conv-int8-form tile`` K5's A-tile form (commit ``3044a30``, before
      C could stream): today's interface without ``c_chunk`` and today's
      packed weight, launched with today's (resident) plan
  nms_keep_launch(valid, suppress, keep, B, k, stream), suppress the
      [B, k, k] bool matrix built eagerly by the caller (K6's first form,
      commit ``76e2a95``, k <= 1024; its source is kept in
      ``tools/earlier/nms_keep.cu``): timed with that eager chain
      (``earlier_nms_keep``), since the current K6 builds its suppression
      itself from the boxes

e.g. an earlier commit's ``ppyolo_tpu_torch/csrc`` unpacked with
``git archive`` (the wmma K2/K4 before PR 4's commit, the first K1/K3 at
it).  K3 had two later forms, named by ``--dcn-bwd-form``: ``binned``
(commit ``0c722e4``; its dx pixels' bins in slot order) takes
``cnt, bins, over, cap`` after ``cols``, cnt zeroed by the caller, and
``sorted`` (a CUB radix sort of its dx entries) takes ``keys, vals, wts,
keys_out, vals_out, temp, temp_bytes`` there, temp_bytes from its
``dcn_bwd_sort_bytes(N, H, W, oH, oW, k2)``.  ``--kernels`` picks which of
the five to compare (K5's rows also sum ms a batch, earlier and current,
by class: 3x3 s1, 3x3 s2, 1x1 with C % 8 = 0, 1x1 with C = 2 mod 8; K6's
at b8 with k = 500 and 1024 clustered candidates, ``nms_candidates``).  The earlier
sources are built with the same nvcc flags into ``build/kernels/earlier/``.

Usage: python -m ppyolo_tpu_torch.tools.kernel_ab --earlier DIR [--kernels dcn_fwd,conv_int8]
       [--dcn-bwd-form first|binned|sorted]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.deform_conv import dcn_bwd_plain, deform_conv2d_plain
from ..ops.deform_conv_cuda import dcn_bwd, dcn_fwd, pack_dcn_weight
from ..ops.stem import fused_stem, fused_stem_plain, pack_stem_params
from ..ops.strided_conv import conv_s2, conv_s2_phase, pack_conv_s2_weight
from .probe_strided_conv import SHAPES

BATCH, SIZE, TOL, ITERS = 8, 608, 0.02, 20
_EARLIER_ARGTYPES = {
    "conv_s2": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "fused_stem": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "dcn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    "conv_int8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "nms_keep": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}
_P, _I = ctypes.c_void_p, ctypes.c_int
_EARLIER_DCN_BWD = {   # K3's earlier C interfaces, by form
    "first": [_P] * 6 + [_I] * 11 + [_P],
    "binned": [_P] * 9 + [_I] * 12 + [_P],
    "sorted": [_P] * 12 + [_I] * 12 + [_P],
}
_EARLIER_ARGTYPES["dcn_bwd"] = _EARLIER_DCN_BWD["first"]
_EARLIER_CONV_INT8 = {"first": _EARLIER_ARGTYPES["conv_int8"],   # K5's earlier forms
                      "tile": [_P] * 6 + [_I] * 16 + [_P]}
BINNED_CAP = 64   # the binned form's entries per dx pixel
DCN_SHAPES = ((38, 2), (19, 1))   # stage5_0 once, stage5_1 / 5_2 twice a batch; C = 512
EARLIER_DIR = Path(__file__).resolve().parent / "earlier"   # K6's first form
NMS_THR = 0.45                     # ppyolo_2x's multiclass nms_threshold
NMS_SHAPES = ((8, 500), (8, 1024))  # (b, k): nms_top_k 500, and K6's first form's cap


def build_earlier(src_dir: Path, names, dcn_bwd_form: str = "first",
                  conv_int8_form: str = "first") -> dict:
    """Compile the earlier ``<name>.cu`` of each name, in parallel; their
    launch functions (K3's in the C interface of ``dcn_bwd_form``, with
    its library as ``.lib``; K5's in that of ``conv_int8_form``)."""
    out = _build.BUILD_DIR / "earlier"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"),
         str(src_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in names}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src_dir / name}.cu failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = (_EARLIER_DCN_BWD[dcn_bwd_form] if name == "dcn_bwd"
                       else _EARLIER_CONV_INT8[conv_int8_form] if name == "conv_int8"
                       else _EARLIER_ARGTYPES[name])
        fn.restype = ctypes.c_int
        fns[name] = (fn, lib) if name == "dcn_bwd" else fn
    return fns


def cuda_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of ``fn`` in ms with the host taken out: ``iters``
    calls captured in one CUDA graph (after 3 warm calls on a side stream),
    CUDA events around 3 replays.  K1's and K3's wrappers spend longer on
    the host than their kernels on the card, so timed eagerly they would
    time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def check(name: str, got, want) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= TOL * float(want.float().abs().max()):
        raise AssertionError(f"{name}: max-abs error {err} against the plain version")
    return err


def ab(name: str, earlier, current, timer=cuda_ms) -> dict:
    """earlier, current, current, earlier; each side's mean of its two."""
    e1, c1, c2, e2 = timer(earlier), timer(current), timer(current), timer(earlier)
    return {"kernel": name, "earlier_ms": [e1, e2], "current_ms": [c1, c2],
            "speedup": (e1 + e2) / (c1 + c2)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="directory with the earlier sources of the kernels compared")
    ap.add_argument("--kernels", default="conv_s2,fused_stem,dcn_fwd,dcn_bwd",
                    help="comma-separated subset of " + ",".join(_EARLIER_ARGTYPES))
    ap.add_argument("--dcn-bwd-form", default="first", choices=sorted(_EARLIER_DCN_BWD),
                    help="the C interface of the earlier dcn_bwd.cu")
    ap.add_argument("--conv-int8-form", default="first", choices=sorted(_EARLIER_CONV_INT8),
                    help="the C interface of the earlier conv_int8.cu")
    a = ap.parse_args(argv)
    names = a.kernels.split(",")
    if not set(names) <= set(_EARLIER_ARGTYPES):
        raise ValueError(f"--kernels {a.kernels}: not a subset of {list(_EARLIER_ARGTYPES)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the A/B runs on the card")
    earlier = build_earlier(a.earlier, names, a.dcn_bwd_form, a.conv_int8_form)
    rows = []
    for name in names:
        gen = torch.Generator().manual_seed(0)
        rows += (ab_dcn_bwd(*earlier[name], gen, a.dcn_bwd_form) if name == "dcn_bwd"
                 else ab_conv_int8(earlier[name], gen, a.conv_int8_form) if name == "conv_int8"
                 else _AB[name](earlier[name], gen))
    dev_name = torch.cuda.get_device_name(0)
    for r in rows:
        print(json.dumps({**r, "device": dev_name}), flush=True)
    return rows


def _stream():
    return torch.cuda.current_stream().cuda_stream


def ab_conv_s2(earlier, gen) -> list:
    dev, bf, rows = torch.device("cuda"), torch.bfloat16, []
    for sname, h, c, co in SHAPES:
        x = torch.randn(BATCH, h, h, c, generator=gen).to(dev, bf).permute(0, 3, 1, 2)
        w = (torch.randn(co, c, 3, 3, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dev, bf)
        packed = pack_conv_s2_weight(w)
        packed_earlier = w.permute(2, 3, 1, 0).reshape(9 * c, co).contiguous()
        y = torch.empty(BATCH, co, h // 2, h // 2, dtype=bf, device=dev,
                        memory_format=torch.channels_last)
        xh = x.permute(0, 2, 3, 1)
        run_e = lambda: earlier(xh.data_ptr(), packed_earlier.data_ptr(),
                                y.data_ptr(), 0, BATCH, h, h, c, co, _stream())
        run_c = lambda: conv_s2(x, w, packed=packed)
        want = conv_s2_phase(x, w)
        if run_e() != 0:
            raise RuntimeError("earlier conv_s2 launch failed")
        errs = {"earlier": check(f"earlier conv_s2 {sname}", y, want),
                "current": check(f"conv_s2 {sname}", run_c(), want)}
        rows.append({**ab(f"conv_s2 {sname}", run_e, run_c), "max_abs_err": errs})
    return rows


def ab_fused_stem(earlier, gen) -> list:
    dev, bf = torch.device("cuda"), torch.bfloat16
    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=gen).to(dev, bf)
    x = x.contiguous(memory_format=torch.channels_last)
    ws = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        ws.append((torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (cin * 9)) ** 0.5)
                  .to(dev, bf))
        ws.append((torch.randn(cout, generator=gen) * 0.1).to(dev))
    packed = pack_stem_params(*ws)
    hwio = [wt.to(dt).permute(2, 3, 1, 0).contiguous()
            for wt, dt in ((ws[0], torch.float32), (ws[2], bf), (ws[4], bf))]
    biases = [b.float().contiguous() for b in ws[1::2]]
    y = torch.empty(BATCH, 64, SIZE // 4, SIZE // 4, dtype=bf, device=dev,
                    memory_format=torch.channels_last)
    xh = x.permute(0, 2, 3, 1)
    args_e = [xh.data_ptr()] + [t.data_ptr() for pair in zip(hwio, biases) for t in pair]
    run_e = lambda: earlier(*args_e, y.data_ptr(), BATCH, SIZE, SIZE, _stream())
    run_c = lambda: fused_stem(x, *ws, packed=packed)
    want = fused_stem_plain(x, *ws)
    if run_e() != 0:
        raise RuntimeError("earlier fused_stem launch failed")
    errs = {"earlier": check("earlier fused_stem", y, want),
            "current": check("fused_stem", run_c(), want)}
    return [{**ab("fused_stem b8@608", run_e, run_c), "max_abs_err": errs}]


def _dcn_inputs(gen, h, stride, c=512):
    """x, OIHW weight, om (offsets of a few pixels, some far out of range)
    and an output gradient at b8, bf16 on the card, channels_last."""
    dev, bf, cl = torch.device("cuda"), torch.bfloat16, torch.channels_last
    oh = (h - 1) // stride + 1
    x = torch.randn(BATCH, c, h, h, generator=gen)
    w = torch.randn(c, c, 3, 3, generator=gen) * (1.0 / (9 * c)) ** 0.5
    off = torch.randn(BATCH, 18, oh, oh, generator=gen) * 2.0
    off[:, 0, 0, 0] = 3.0 * h
    om = torch.cat([off, torch.randn(BATCH, 9, oh, oh, generator=gen)], 1)
    g = torch.randn(BATCH, c, oh, oh, generator=gen)
    return [t.to(dev, bf).contiguous(memory_format=cl) for t in (x, w, om, g)] + [oh]


def ab_dcn_fwd(earlier, gen) -> list:
    rows = []
    for h, stride in DCN_SHAPES:
        x, w, om, _, oh = _dcn_inputs(gen, h, stride)
        c = x.shape[1]
        packed = pack_dcn_weight(w)
        packed_earlier = packed.t().contiguous()   # [k2*C, outC]
        y = torch.empty(BATCH, c, oh, oh, dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        ptrs = [t.data_ptr() for t in (x, om, packed_earlier)]
        run_e = lambda: earlier(*ptrs, 0, y.data_ptr(), 0, BATCH, h, h, c, oh, oh, c, 3, 3,
                                stride, 1, _stream())
        run_c = lambda: dcn_fwd(x, om, packed, None, ksize=(3, 3), stride=stride, padding=1)
        want = deform_conv2d_plain(x, w, om, stride=stride, padding=1)
        if run_e() != 0:
            raise RuntimeError("earlier dcn_fwd launch failed")
        errs = {"earlier": check(f"earlier dcn_fwd {h}x{h}/s{stride}", y, want),
                "current": check(f"dcn_fwd {h}x{h}/s{stride}", run_c(), want)}
        rows.append({**ab(f"dcn_fwd {h}x{h}/s{stride}", run_e, run_c, graph_ms),
                     "max_abs_err": errs})
    return rows


def _dcn_bwd_scratch(lib, form: str, h: int, oh: int, dev) -> list:
    """The arguments that K3's earlier ``form`` takes after ``cols``, and
    the tensor its caller zeroes before a launch (or None)."""
    pixels, entries = BATCH * h * h, BATCH * oh * oh * 9 * 4
    if form == "first":
        return [], None
    if form == "binned":
        cnt = torch.zeros(pixels + 1, dtype=torch.int32, device=dev)
        bins = torch.empty(pixels * BINNED_CAP * 2, dtype=torch.int32, device=dev)
        over = torch.empty(entries * 4, dtype=torch.int32, device=dev)
        return [cnt, bins, over, BINNED_CAP], cnt
    lib.dcn_bwd_sort_bytes.restype = ctypes.c_int
    temp_bytes = lib.dcn_bwd_sort_bytes(BATCH, h, h, oh, oh, 9)
    if temp_bytes < 0:
        raise RuntimeError(f"earlier dcn_bwd_sort_bytes: cudaError {-temp_bytes}")
    ents = [torch.empty(entries, dtype=torch.int32, device=dev) for _ in range(5)]
    temp = torch.empty(max(temp_bytes, 1), dtype=torch.uint8, device=dev)
    return ents + [temp, temp_bytes], None


def ab_dcn_bwd(earlier, lib, gen, form: str = "first") -> list:
    rows = []
    for h, stride in DCN_SHAPES:
        x, w, om, g, oh = _dcn_inputs(gen, h, stride)
        c = x.shape[1]
        dm = g.permute(0, 2, 3, 1).reshape(-1, c) @ pack_dcn_weight(w)
        dx = torch.empty(BATCH, h, h, c, dtype=torch.float32, device=x.device)
        d_om, cols = torch.empty_like(om), torch.empty_like(dm)
        scratch, zeroed = _dcn_bwd_scratch(lib, form, h, oh, x.device)
        ptrs = [t.data_ptr() for t in (x, om, dm, dx, d_om, cols)]
        ptrs += [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in scratch]

        if form == "first":
            zeroed = dx   # the first form adds into dx

        def run_e():
            if zeroed is not None:
                zeroed.zero_()
            return earlier(*ptrs, 0, BATCH, h, h, c, oh, oh, 3, 3, stride, 1, _stream())

        run_c = lambda: dcn_bwd(x, om, dm, ksize=(3, 3), stride=stride, padding=1)
        want = dcn_bwd_plain(x, om, dm, ksize=(3, 3), stride=stride, padding=1)
        if run_e() != 0:
            raise RuntimeError("earlier dcn_bwd launch failed")
        got = run_c()
        errs = {}
        for side, outs in (("earlier", (dx.permute(0, 3, 1, 2), d_om, cols)), ("current", got)):
            errs[side] = max(check(f"{side} dcn_bwd {h}x{h}/s{stride} {k}", a, b)
                             for k, a, b in zip(("dx", "d_om", "cols"), outs, want))
        same = all(torch.equal(a, b) for a, b in zip((dx.permute(0, 3, 1, 2), d_om, cols), got))
        rows.append({**ab(f"dcn_bwd {h}x{h}/s{stride}", run_e, run_c, graph_ms),
                     "earlier_form": form, "max_abs_err": errs, "bit_equal": same})
    return rows


def _earlier_int8_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the earlier K5's K-major [Co, k*k*Cp], Cp = C rounded up to 16."""
    co, c, k, _ = wq.shape
    cp = (c + 15) // 16 * 16
    return torch.nn.functional.pad(wq.permute(0, 2, 3, 1), (0, cp - c)).reshape(
        co, k * k * cp).contiguous()


def ab_conv_int8(earlier, gen, form: str = "first") -> list:
    from configs import PPYOLO_2x_Config

    from ..eval.optimize import int8_conv_class, int8_conv_shapes
    from ..models import PPYOLO
    from ..ops.conv_int8 import (dynamic_act_scale, k5_plan, pack_int8_weight,
                                 quantized_conv2d, quantized_conv2d_plain, sm_count)

    dev, rows = torch.device("cuda"), []
    by_class = {}
    for c, h, w, co, k, stride, count in int8_conv_shapes(
            PPYOLO.from_config(PPYOLO_2x_Config()).eval(), SIZE, BATCH):
        x = (torch.randn(BATCH, c, h, w, generator=gen) * 1.5).to(dev, torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        wq = torch.randint(-127, 128, (co, c, k, k), generator=gen, dtype=torch.int8).to(dev)
        ws = (torch.rand(co, generator=gen) * 1e-3 + 1e-4).to(dev)
        s_x = dynamic_act_scale(x) * 0.6      # static; clips the largest activations
        packed = pack_int8_weight(wq)
        packed_earlier = packed if form == "tile" else _earlier_int8_weight(wq)
        oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
        y = torch.empty(BATCH, co, oh, ow, dtype=x.dtype, device=dev,
                        memory_format=torch.channels_last)
        ptrs = [t.data_ptr() for t in (x, packed_earlier, ws, s_x)]
        if form == "tile":
            p = k5_plan(BATCH, h, w, c, co, k, stride, sm_count(dev))
            shape_args = (p.wg_m, p.m_tiles, p.tiles_per_block, p.planes[1], p.planes[2],
                          p.a_slots, *p.grid, p.smem_bytes)
        else:
            shape_args = (oh, ow)
        run_e = lambda: earlier(*ptrs, 0, y.data_ptr(), BATCH, h, w, c, co, k, stride,
                                *shape_args, _stream())
        kw = dict(stride=stride, padding=(k - 1) // 2, act_scale=s_x)
        run_c = lambda: quantized_conv2d(x, wq, ws, packed=packed, **kw)
        with torch.no_grad():
            want = quantized_conv2d_plain(x, wq, ws, **kw)
            if run_e() != 0:
                raise RuntimeError("earlier conv_int8 launch failed")
            for side, got in (("earlier", y), ("current", run_c())):
                if not torch.equal(got, want):
                    raise AssertionError(f"{side} conv_int8 {(c, h, w, co, k, stride)}: not "
                                         f"bit-equal to the plain version")
            row = ab(f"conv_int8 {[BATCH, h, w, c]} -> {co} k{k} s{stride}", run_e, run_c,
                     graph_ms)
        acc = by_class.setdefault(int8_conv_class(k, c, stride),
                                  {"convs": 0, "earlier_ms": 0.0, "current_ms": 0.0})
        acc["convs"] += count
        acc["earlier_ms"] += count * sum(row["earlier_ms"]) / 2
        acc["current_ms"] += count * sum(row["current_ms"]) / 2
        rows.append({**row, "convs": count, "bit_equal": True})
    total = {"convs": sum(v["convs"] for v in by_class.values()),
             "earlier_ms": sum(v["earlier_ms"] for v in by_class.values()),
             "current_ms": sum(v["current_ms"] for v in by_class.values())}
    rows.append({"kernel": "conv_int8 per b8@608 batch", "by_class": by_class, **total,
                 "speedup": total["earlier_ms"] / total["current_ms"]})
    return rows


def nms_candidates(gen, b: int, k: int, dev):
    """K6's inputs as ``multiclass_nms`` gives them: valid [b, k] bool,
    boxes [b, k, 4] fp32 xyxy and labels [b, k] int32 of k candidates in
    score order; boxes in 24 clusters of a SIZE-px image (so suppressions
    chain), 4 labels, 10% invalid."""
    centres = torch.rand(b, 24, 2, generator=gen) * SIZE
    pick = torch.randint(0, 24, (b, k), generator=gen)
    xy = torch.gather(centres, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.randn(b, k, 2, generator=gen) * 6
    wh = 20 + torch.rand(b, k, 2, generator=gen) * 60
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    labels = torch.randint(0, 4, (b, k), generator=gen, dtype=torch.int32)
    valid = torch.rand(b, k, generator=gen) < 0.9
    return valid.to(dev), boxes.to(dev), labels.to(dev)


def earlier_nms_keep(earlier, valid, boxes, labels, thr: float = NMS_THR) -> torch.Tensor:
    """K6's first form as ``multiclass_nms`` ran it: the [B, k, k] suppress
    matrix built eagerly (``suppress_matrix``), then its launch."""
    from ..ops.matrix_nms import suppress_matrix

    sup = suppress_matrix(boxes, labels, thr)
    keep = torch.empty_like(valid)
    b, k = valid.shape
    if earlier(valid.data_ptr(), sup.data_ptr(), keep.data_ptr(), b, k, _stream()) != 0:
        raise RuntimeError("earlier nms_keep launch failed")
    return keep


def ab_nms_keep(earlier, gen) -> list:
    from ..ops.matrix_nms import nms_keep, nms_keep_boxes_plain

    rows = []
    for b, k in NMS_SHAPES:
        v, bx, lb = nms_candidates(gen, b, k, torch.device("cuda"))
        run_e = lambda: earlier_nms_keep(earlier, v, bx, lb)
        run_c = lambda: nms_keep(v, bx, lb, NMS_THR)
        want = nms_keep_boxes_plain(v, bx, lb, NMS_THR)
        for side, got in (("earlier", run_e()), ("current", run_c())):
            if not torch.equal(got, want):
                raise AssertionError(f"{side} nms_keep b{b} k{k}: keep flags differ from the "
                                     f"plain version")
        rows.append({**ab(f"nms_keep b{b} k{k}", run_e, run_c, graph_ms), "bit_equal": True,
                     "kept": int(want.sum())})
    return rows


_AB = {"conv_s2": ab_conv_s2, "fused_stem": ab_fused_stem, "dcn_fwd": ab_dcn_fwd,
       "conv_int8": ab_conv_int8, "nms_keep": ab_nms_keep}


if __name__ == "__main__":
    main()
