"""Plain PyTorch reference of PP-YOLO: the architecture written out over a
flat state dict, with nothing of the program under test.

The state dict uses the program's keys (the JAX param paths, e.g.
``backbone.stage5_0.conv2.conv.dcn_weight``), so the benchmark makes one
set of fp32 weights and hands the same tensors to both sides.  Everything
the program derives from them (the folded BN, the bf16 cast, packed
kernel weights) is worked out again here from the unfolded fp32 leaves:
BN is applied as ``(x - mean) / sqrt(var + eps) * w + b``, DCNv2 is a
bilinear gather and one matrix product, and the decode and Matrix-NMS are
the published formulas (PP-YOLO, arXiv:2007.12099; Matrix-NMS, SOLOv2,
arXiv:2003.10152).

``forward`` runs in the dtype of its input; the benchmark runs it in fp32
with TF32 off (``fp32_exact``).  ``mode="calibrate"`` fills the BN
statistics while it runs (``harness/weights.py``), ``mode="train"`` uses
batch statistics, updates the running ones and applies DropBlock from
uniforms drawn by the caller's generator in the program's order, and
with ``stats_sum`` (sync-BN over ranks) takes each BN's batch statistics
from sums over every rank's batch.  ``targets`` and ``loss`` are the
training step's YOLOv3 targets and loss terms (``reference/train.py``
runs the step).  This is the reference module of every configuration
that names none (``reference/__init__.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import fp32_exact, kaiming_std, pairwise_iou  # noqa: F401 (interface)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
STEM = ((3, 32, 2), (32, 32, 1), (32, 64, 1))   # (cin, cout, stride) of conv1_1..conv1_3
OUTPUT_CONVS = "head.yolo_output_convs."        # the head's output convs' key prefix


# -- the layer list: every conv of the model, in forward order ----------------

def _conv(key, cin, cout, k, *, stride=1, norm=True, act=None, dcn=False, bias=False,
          last_of_branch=False):
    return dict(key=key, cin=cin, cout=cout, k=k, stride=stride, norm=norm, act=act,
                dcn=dcn, bias=bias, last_of_branch=last_of_branch)


def backbone_layers(cfg) -> Dict[str, list]:
    """{block name: [conv specs]} of the backbone, stem first."""
    bb = cfg["backbone"]
    dcn_stages = set(bb.get("dcn_v2_stages", []))
    out = {"stem": [_conv(f"backbone.stage1_conv1_{i}", cin, cout, 3, stride=s, act="relu")
                    for i, (cin, cout, s) in enumerate(STEM, start=1)]}
    if cfg["backbone_type"] == "Resnet50Vd":
        specs = [(2, 3, (64, 64, 256), 64), (3, 4, (128, 128, 512), 256),
                 (4, 6, (256, 256, 1024), 512), (5, 3, (512, 512, 2048), 1024)]
        for stage, n, (f1, f2, f3), in_c in specs:
            for b in range(n):
                p = f"backbone.stage{stage}_{b}"
                cin = in_c if b == 0 else f3
                stride = (1 if stage == 2 else 2) if b == 0 else 1
                s1, s2 = (1, stride) if bb.get("downsample_in3x3", True) else (stride, 1)
                layers = [_conv(f"{p}.conv1", cin, f1, 1, stride=s1, act="relu"),
                          _conv(f"{p}.conv2", f1, f2, 3, stride=s2, act="relu",
                                dcn=stage in dcn_stages),
                          _conv(f"{p}.conv3", f2, f3, 1, last_of_branch=True)]
                if b == 0:
                    layers.append(_conv(f"{p}.conv4", cin, f3, 1,
                                        stride=stride if stage == 2 else 1))
                out[p] = layers
    elif cfg["backbone_type"] == "Resnet18Vd":
        specs = [(2, 64, 64, 1), (3, 128, 64, 2), (4, 256, 128, 2), (5, 512, 256, 2)]
        for stage, f, in_c, stride in specs:
            for b in range(2):
                p = f"backbone.stage{stage}_{b}"
                cin, s = (in_c, stride) if b == 0 else (f, 1)
                layers = [_conv(f"{p}.conv1", cin, f, 3, stride=s, act="relu"),
                          _conv(f"{p}.conv2", f, f, 3, dcn=stage in dcn_stages,
                                last_of_branch=True)]
                if s == 2 or (stage == 2 and b == 0):
                    layers.append(_conv(f"{p}.conv3", cin, f, 1,
                                        stride=s if stage == 2 and b == 0 else 1))
                out[p] = layers
    else:
        raise NotImplementedError(cfg["backbone_type"])
    return out


def head_plan(cfg) -> List[dict]:
    """Per FPN level (coarsest first): the block's ops in order, as
    ("coord" | "spp" | "drop", None) or ("conv", spec), its tip, its
    output conv and its transition."""
    h = cfg["head"]
    n = len(h["downsample"])
    cbn = h.get("conv_block_num", 2)
    coord, use_spp, drop = h.get("coord_conv", True), h.get("spp", True), h.get("drop_block", True)
    nc = h["num_classes"]
    levels = []
    for i in range(n):
        p = f"head.detection_blocks.{i}"
        in_c = h["in_channels"][i] + (512 // (2 ** i) if i > 0 else 0)
        ch = 64 * (2 ** n) // (2 ** i)
        ops = []

        def add(kind, spec=None):
            ops.append((kind, spec if spec is None else dict(spec, key=f"{p}.layers.{len(ops)}")))

        c = in_c
        for j in range(cbn):
            add("coord")
            add("conv", _conv("", c + 2 if coord else c, ch, 1, act="leaky"))
            if use_spp and i == 0 and j == 1:
                add("spp")
                add("conv", _conv("", ch * 4, 512, 1, act="leaky"))
                add("conv", _conv("", 512, ch * 2, 3, act="leaky"))
            else:
                add("conv", _conv("", ch, ch * 2, 3, act="leaky"))
            if drop and j == 0 and i != 0:
                add("drop")
            c = ch * 2
        if drop and i == 0:
            add("drop")
        add("coord")
        add("conv", _conv("", (c if cbn == 0 else ch * 2) + (2 if coord else 0), ch, 1,
                          act="leaky"))
        an = len(h["anchor_masks"][i])
        nf = an * (nc + 6) if h.get("iou_aware", True) else an * (nc + 5)
        levels.append(dict(
            ops=ops, coord=coord,
            tip=_conv(f"{p}.tip_layers.1", ch + (2 if coord else 0), ch * 2, 3, act="leaky"),
            out=_conv(f"head.yolo_output_convs.{i}", ch * 2, nf, 1, norm=False, bias=True),
            trans=(_conv(f"head.upsample_layers.{2 * i}", ch, 256 // (2 ** i), 1, act="leaky")
                   if i < n - 1 else None)))
    return levels


def conv_specs(cfg) -> List[dict]:
    """Every conv spec of the model, backbone then head."""
    out = [s for layers in backbone_layers(cfg).values() for s in layers]
    for lv in head_plan(cfg):
        out += [s for kind, s in lv["ops"] if kind == "conv"] + [lv["tip"], lv["out"]]
        if lv["trans"] is not None:
            out.append(lv["trans"])
    return out


def param_shapes(cfg) -> Dict[str, tuple]:
    """{state dict key: shape} of the model, the program's keys."""
    out = {}
    for s in conv_specs(cfg):
        k, cin, cout, ks = s["key"], s["cin"], s["cout"], s["k"]
        if s["dcn"]:
            out[f"{k}.conv.conv_offset.weight"] = (3 * ks * ks, cin, ks, ks)
            out[f"{k}.conv.conv_offset.bias"] = (3 * ks * ks,)
            out[f"{k}.conv.dcn_weight"] = (cout, cin, ks, ks)
        else:
            out[f"{k}.conv.weight"] = (cout, cin, ks, ks)
            if s["bias"]:
                out[f"{k}.conv.bias"] = (cout,)
        if s["norm"]:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[f"{k}.bn.{leaf}"] = (cout,)
    return out


# -- layers ---------------------------------------------------------------------

def deform_conv(x, weight, om, stride: int, pad: int):
    """DCNv2: each output pixel samples ``x`` at its k x k taps moved by the
    learned offsets (bilinear, zero outside the image; positions clipped to
    the padded frame), scales each sample by the sigmoid of its mask logit,
    and takes one product with the weight.  om [N, 3k^2, oH, oW]: offsets
    (dy, dx) per tap, then the mask logits."""
    n, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    k2 = kh * kw
    oh, ow = om.shape[2], om.shape[3]
    off = om[:, :2 * k2].permute(0, 2, 3, 1).reshape(n, oh, ow, k2, 2)
    mask = torch.sigmoid(om[:, 2 * k2:].permute(0, 2, 3, 1))              # [n,oh,ow,k2]
    ty = torch.arange(kh, device=x.device, dtype=x.dtype).repeat_interleave(kw)
    tx = torch.arange(kw, device=x.device, dtype=x.dtype).repeat(kh)
    oy = torch.arange(oh, device=x.device, dtype=x.dtype) * stride - pad
    ox = torch.arange(ow, device=x.device, dtype=x.dtype) * stride - pad
    py = (oy[:, None, None] + ty[None, None, :] + off[..., 0]).clamp(-pad, h - 1 + pad)
    px = (ox[None, :, None] + tx[None, None, :] + off[..., 1]).clamp(-pad, w - 1 + pad)
    y0, x0 = torch.floor(py), torch.floor(px)
    flat = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
    val = 0
    for dy in (0, 1):
        for dx in (0, 1):
            yc, xc = y0 + dy, x0 + dx
            wgt = (1 - (py - yc).abs()) * (1 - (px - xc).abs())
            inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long().reshape(n, -1, 1)
            g = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(n, oh, ow, k2, c)
            val = val + g * (wgt * inside)[..., None]
    cols = (val * mask[..., None]).reshape(n * oh * ow, k2 * c)
    wm = weight.permute(0, 2, 3, 1).reshape(cout, k2 * c)              # tap-major, then channel
    return (cols @ wm.t()).reshape(n, oh, ow, cout).permute(0, 3, 1, 2)


class Net:
    """The reference forward over a state dict ``P``.

    mode "eval" uses the running statistics; "calibrate" sets each BN's
    running statistics from its own input first (``calibrate`` hook);
    "train" normalizes with batch statistics, updates the running ones
    and runs DropBlock with uniforms from ``drop_uniform(shape)``; with
    ``stats_sum`` (sync-BN), a differentiable sum over the ranks of each
    BN's fp32 ``[Σx, Σx², count]``, the statistics are every rank's."""

    def __init__(self, cfg, P: Dict[str, torch.Tensor], mode: str = "eval",
                 calibrate: Optional[Callable] = None,
                 drop_uniform: Optional[Callable] = None, quant: Optional[Callable] = None,
                 stats_sum: Optional[Callable] = None):
        self.cfg, self.P, self.mode = cfg, P, mode
        self.q = quant or (lambda t: t)     # rounding of every conv's operands
        self.calibrate, self.drop_uniform = calibrate, drop_uniform
        self.stats_sum = stats_sum
        self.dropblock = dict(block_size=3, keep_prob=cfg["head"].get("keep_prob", 0.9))

    def bn(self, key, x, spec):
        P = self.P
        if self.mode == "calibrate":
            self.calibrate(key, x, spec)
        w, b = P[f"{key}.bn.weight"], P[f"{key}.bn.bias"]
        if self.mode == "train":
            x32 = x.float()
            cnt = x.shape[0] * x.shape[2] * x.shape[3]
            if self.stats_sum is None:
                m, msq = x32.mean((0, 2, 3)), x32.square().mean((0, 2, 3))
            else:
                c = x.shape[1]
                s = self.stats_sum(torch.cat([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)),
                                              x32.new_full((1,), float(cnt))]))
                m, msq, cnt = s[:c] / s[2 * c], s[c:2 * c] / s[2 * c], float(s[2 * c].detach())
            v = (msq - m.square()).clamp_min(0)
            with torch.no_grad():
                for buf, stat in ((P[f"{key}.bn.running_mean"], m),
                                  (P[f"{key}.bn.running_var"], v * cnt / max(cnt - 1, 1))):
                    buf.copy_((1 - BN_MOMENTUM) * buf + BN_MOMENTUM * stat.detach())
            y = (x32 - m.view(1, -1, 1, 1)) * torch.rsqrt(v + BN_EPS).view(1, -1, 1, 1)
            return (y * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)).to(x.dtype)
        mean, var = P[f"{key}.bn.running_mean"], P[f"{key}.bn.running_var"]
        return ((x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + BN_EPS)
                * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))

    def conv(self, spec, x):
        P, k = self.P, spec["key"]
        pad = (spec["k"] - 1) // 2
        q = self.q
        x = q(x)
        if spec["dcn"]:
            om = F.conv2d(x, q(P[f"{k}.conv.conv_offset.weight"]), P[f"{k}.conv.conv_offset.bias"],
                          spec["stride"], pad)
            x = deform_conv(x, q(P[f"{k}.conv.dcn_weight"]), om, spec["stride"], pad)
        else:
            x = F.conv2d(x, q(P[f"{k}.conv.weight"]), P.get(f"{k}.conv.bias"), spec["stride"], pad)
        if spec["norm"]:
            x = self.bn(k, x, spec)
        if spec["act"] == "relu":
            x = F.relu(x)
        elif spec["act"] == "leaky":
            x = F.leaky_relu(x, 0.1)
        return x

    def backbone(self, x) -> List[torch.Tensor]:
        blocks = backbone_layers(self.cfg)
        for s in blocks.pop("stem"):
            x = self.conv(s, x)
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        resnet50 = self.cfg["backbone_type"] == "Resnet50Vd"
        for name, layers in blocks.items():
            stage = int(name.split("stage")[1].split("_")[0])
            first = name.endswith("_0")
            main = layers[:3] if resnet50 else layers[:2]
            y = x
            for s in main:
                y = self.conv(s, y)
            short = layers[3] if resnet50 and first else (
                layers[2] if not resnet50 and len(layers) == 3 else None)
            if short is not None:
                if stage != 2:
                    x = F.avg_pool2d(x, 2, 2)
                x = self.conv(short, x)
            x = F.relu(y + x)
            feats[stage] = x
        return [feats[s] for s in self.cfg["backbone"]["feature_maps"]]

    def _drop(self, x):
        bs, keep = self.dropblock["block_size"], self.dropblock["keep_prob"]
        n, c, h, w = x.shape
        u = self.drop_uniform(x.shape)
        gamma = float(h) ** 2 * (1 - keep) / (bs * bs * float(max(h - bs + 1, 1)) ** 2)
        mask = 1 - F.max_pool2d((u < gamma).to(x.dtype), bs, 1, 1)
        return x * mask * (float(n * c * h * w) / mask.sum())

    @staticmethod
    def _coord(x):
        n, _, h, w = x.shape
        gx = torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1) * 2 - 1
        gy = torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1) * 2 - 1
        g = torch.stack([gx.view(1, w).expand(h, w), gy.view(h, 1).expand(h, w)])
        return torch.cat([x, g[None].expand(n, 2, h, w)], 1)

    def head(self, feats) -> List[torch.Tensor]:
        levels = head_plan(self.cfg)
        feats = feats[::-1][:len(levels)]
        outs, route = [], None
        for i, (lv, x) in enumerate(zip(levels, feats)):
            if i > 0:
                x = torch.cat([route, x], 1)
            for kind, spec in lv["ops"]:
                if kind == "coord" and lv["coord"]:
                    x = self._coord(x)
                elif kind == "conv":
                    x = self.conv(spec, x)
                elif kind == "spp":
                    x = torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)], 1)
                elif kind == "drop" and self.mode == "train":
                    x = self._drop(x)
            route = x
            tip = self.conv(lv["tip"], self._coord(route) if lv["coord"] else route)
            outs.append(self.conv(lv["out"], tip))
            if lv["trans"] is not None:
                route = F.interpolate(self.conv(lv["trans"], route), scale_factor=2,
                                      mode="nearest")
        return outs

    def __call__(self, images) -> List[torch.Tensor]:
        return self.head(self.backbone(images))


def normalize(cfg, images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[N,H,W,3] uint8 RGB -> [N,3,H,W] normalized (``normalizeImage``)."""
    norm = cfg["normalizeImage"]
    if cfg["permute"].get("to_bgr", False):
        raise NotImplementedError("to_bgr configurations")
    x = images_u8.permute(0, 3, 1, 2).to(dtype)
    if norm.get("is_scale", True):
        x = x / 255.0
    mean = torch.tensor(norm["mean"], dtype=dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(norm["std"], dtype=dtype, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# -- decode and Matrix-NMS --------------------------------------------------------

def decode(cfg, outs: List[torch.Tensor], im_size: torch.Tensor, net_size: int):
    """Raw maps -> (boxes [N, A, 4] xyxy in image pixels, scores [N, A, C]).

    Per anchor: centre ``(s * sigmoid(t_xy) + grid - (s - 1) / 2) * stride``,
    size ``exp(t_wh) * anchor``; score = conf * sigmoid(class logits), with
    conf = obj^(1-f) * iou^f under the IoU-aware head, else obj.  Boxes
    scale to the image and clip to it."""
    h = cfg["head"]
    nc, sxy = h["num_classes"], h.get("scale_x_y", 1.0)
    f = h.get("iou_aware_factor", 0.4) if h.get("iou_aware", True) else None
    boxes, scores = [], []
    for i, out in enumerate(outs):
        mask = h["anchor_masks"][i]
        stride = h["downsample"][i]
        n, _, s, _ = out.shape
        an = len(mask)
        o = out.float().permute(0, 2, 3, 1)                      # [n, s, s, ch]
        base = an if f is not None else 0
        g = torch.arange(s, dtype=torch.float32, device=out.device)
        for a, ai in enumerate(mask):
            blk = o[..., base + a * (nc + 5): base + (a + 1) * (nc + 5)]
            cx = (sxy * torch.sigmoid(blk[..., 0]) + g.view(1, 1, s) - (sxy - 1) / 2) * stride
            cy = (sxy * torch.sigmoid(blk[..., 1]) + g.view(1, s, 1) - (sxy - 1) / 2) * stride
            bw = torch.exp(blk[..., 2]) * h["anchors"][ai][0]
            bh = torch.exp(blk[..., 3]) * h["anchors"][ai][1]
            obj = torch.sigmoid(blk[..., 4])
            conf = obj if f is None else obj ** (1 - f) * torch.sigmoid(o[..., a]) ** f
            boxes.append(torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1))
            scores.append(conf[..., None] * torch.sigmoid(blk[..., 5:]))
    # (S, S, anchor) order within a level, as the program flattens
    boxes = _interleave(boxes, [len(m) for m in h["anchor_masks"]])
    scores = _interleave(scores, [len(m) for m in h["anchor_masks"]])
    n = boxes.shape[0]
    imh = im_size[:, 0].float().view(n, 1)
    imw = im_size[:, 1].float().view(n, 1)
    x0 = (boxes[..., 0] * imw / net_size).clamp_min(0)
    y0 = (boxes[..., 1] * imh / net_size).clamp_min(0)
    x1 = torch.minimum(boxes[..., 2] * imw / net_size, imw)
    y1 = torch.minimum(boxes[..., 3] * imh / net_size, imh)
    return torch.stack([x0, y0, x1, y1], -1), scores


def _interleave(per_anchor: List[torch.Tensor], counts: List[int]) -> torch.Tensor:
    out, i = [], 0
    for an in counts:
        grp = torch.stack(per_anchor[i:i + an], 3)              # [n, s, s, an, d]
        out.append(grp.reshape(grp.shape[0], -1, grp.shape[-1]))
        i += an
    return torch.cat(out, 1)


def matrix_nms(boxes, scores, nms_cfg) -> torch.Tensor:
    """Matrix-NMS per image: the ``nms_top_k`` (anchor, class) pairs above
    ``score_threshold``; each score decays by min over higher-scored
    same-class boxes j of (1 - iou_ij) / (1 - max iou of j with its own
    higher-scored boxes) (linear) or the gaussian form; ``keep_top_k``
    rows above ``post_threshold`` by decayed score.  -> [N, keep_top_k, 6]
    (label, score, x0, y0, x1, y1), -1 rows where empty."""
    thr, post = nms_cfg["score_threshold"], nms_cfg["post_threshold"]
    top_k, keep_k = nms_cfg["nms_top_k"], nms_cfg["keep_top_k"]
    n, a, c = scores.shape
    out = torch.full((n, keep_k, 6), -1.0, device=scores.device)
    for i in range(n):
        flat = scores[i].reshape(-1)
        vals, idx = torch.sort(torch.where(flat > thr, flat, 0.0), descending=True, stable=True)
        vals, idx = vals[:top_k], idx[:top_k]
        valid = vals > thr
        vals, idx = vals[valid], idx[valid]
        labels, cand = idx % c, boxes[i][idx // c]
        iou = pairwise_iou(cand, cand)
        k = len(vals)
        upper = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
        d = torch.where(upper & (labels[:, None] == labels[None, :]), iou, 0.0)
        comp = d.amax(0)                                        # each box's own max IoU above it
        if nms_cfg.get("use_gaussian", False):
            sig = nms_cfg.get("gaussian_sigma", 2.0)
            ratio = torch.exp(-sig * (d ** 2 - comp[:, None] ** 2))
        else:
            ratio = (1 - d) / (1 - comp[:, None])
        dec = vals * (ratio.amin(0) if k else vals)
        keep = dec >= post
        dec, labels, cand = dec[keep], labels[keep], cand[keep]
        order = torch.sort(dec, descending=True, stable=True).indices[:keep_k]
        m = len(order)
        out[i, :m, 0] = labels[order].float()
        out[i, :m, 1] = dec[order]
        out[i, :m, 2:] = cand[order]
    return out


def detect(cfg, P, images_u8: torch.Tensor, im_size: torch.Tensor):
    """uint8 [N,S,S,3] -> (rows [N, keep_top_k, 6], boxes, scores) in fp32."""
    outs = Net(cfg, P)(normalize(cfg, images_u8))
    boxes, scores = decode(cfg, outs, im_size, images_u8.shape[1])
    return matrix_nms(boxes, scores, cfg["nms_cfg"]), boxes, scores


# -- training targets and loss ----------------------------------------------------

_EPS_CAP = 20.72326583694641  # -log(1e-9)


def targets(cfg, gt_bbox: np.ndarray, gt_class: np.ndarray, gt_score: np.ndarray,
            hw, device) -> List[torch.Tensor]:
    """YOLOv3 targets, per level [B, gh, gw, an, 6 + C]: tx, ty, tw, th,
    tscale, score and the multi-hot classes (best anchor by wh-IoU, the
    later ground truth winning a cell's fields)."""
    t = cfg["gt2YoloTarget"]
    h, w = hw
    nc = t["num_classes"]
    anchors = np.asarray(t["anchors"], np.float32)
    f = np.float32
    out = []
    for mask, ds in zip(t["anchor_masks"], t["downsample_ratios"]):
        out.append(np.zeros((gt_bbox.shape[0], h // ds, w // ds, len(mask), 6 + nc), np.float32))
    for b in range(gt_bbox.shape[0]):
        for m in range(gt_bbox.shape[1]):
            gx, gy, gw, gh = (f(v) for v in gt_bbox[b, m])
            score = f(gt_score[b, m])
            if not (gw > 0 and gh > 0 and score > 0):
                continue
            aw, ah = anchors[:, 0] / f(w), anchors[:, 1] / f(h)
            inter = np.minimum(gw, aw) * np.minimum(gh, ah)
            best = int(np.argmax(inter / np.maximum(gw * gh + aw * ah - inter, f(1e-12))))
            for lvl, (mask, ds) in enumerate(zip(t["anchor_masks"], t["downsample_ratios"])):
                if best not in mask:
                    continue
                a = mask.index(best)
                gridh, gridw = h // ds, w // ds
                gi = min(max(int(gx * f(gridw)), 0), gridw - 1)
                gj = min(max(int(gy * f(gridh)), 0), gridh - 1)
                row = out[lvl][b, gj, gi, a]
                row[:6] = [gx * f(gridw) - f(gi), gy * f(gridh) - f(gj),
                           np.log(gw * f(w) / anchors[best, 0]),
                           np.log(gh * f(h) / anchors[best, 1]), f(2.0) - gw * gh, score]
                c = int(gt_class[b, m])
                if 0 <= c < nc:
                    row[6 + c] = 1.0
    return [torch.from_numpy(o).to(device) for o in out]


def _bce_logits(logit, target):
    pos = torch.clamp_max(F.softplus(-logit), _EPS_CAP)
    neg = torch.clamp_max(F.softplus(logit), _EPS_CAP)
    return target * pos + (1.0 - target) * neg


def _decode(dx, dy, dw, dh, anchors_wh, downsample, sxy, is_gt):
    s = dx.shape[1]
    gx = torch.arange(s, dtype=dx.dtype, device=dx.device)[None, None, :, None]
    gy = torch.arange(s, dtype=dx.dtype, device=dx.device)[None, :, None, None]
    if is_gt:
        cx, cy = (dx + gx) / s, (dy + gy) / s
    else:
        sx, sy = torch.sigmoid(dx), torch.sigmoid(dy)
        if abs(sxy - 1.0) > 1e-10:
            sx, sy = sxy * sx - 0.5 * (sxy - 1.0), sxy * sy - 0.5 * (sxy - 1.0)
        cx, cy = (sx + gx) / s, (sy + gy) / s
    pw = torch.exp(dw) * anchors_wh[:, 0] / (s * downsample)
    ph = torch.exp(dh) * anchors_wh[:, 1] / (s * downsample)
    out = (cx - 0.5 * pw, cy - 0.5 * ph, cx + 0.5 * pw, cy + 0.5 * ph)
    return tuple(v.detach() for v in out) if is_gt else out


def _iou(p, g, eps=1e-10):
    x1, y1, x2, y2 = p
    x1g, y1g, x2g, y2g = g
    x2, y2 = torch.maximum(x1, x2), torch.maximum(y1, y2)
    inter = (torch.minimum(x2, x2g) - torch.maximum(x1, x1g)).clamp_min(0) * \
        (torch.minimum(y2, y2g) - torch.maximum(y1, y1g)).clamp_min(0)
    return inter / ((x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter + eps)


def loss(cfg, outputs: List[torch.Tensor], tgts: List[torch.Tensor],
         gt_box: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fine-grained YOLOv3 loss terms (fp32), each summed over cells and
    averaged over images: Grid-Sensitive L1 xy, L1 wh, IoU, IoU-aware
    (soft-weight form), objectness with the ignore mask, per-class BCE; a
    frozen copy of the program's plain formulas."""
    h = cfg["head"]
    nc = h["num_classes"]
    sxy = cfg["yolo_loss"]["scale_x_y"]
    if abs(sxy - 1.0) < 1e-10:
        raise NotImplementedError("the BCE xy loss of scale_x_y == 1")
    iou_w = cfg["iou_loss"]["loss_weight"] if cfg.get("iou_loss_type") else None
    aware_w = cfg["iou_aware_loss"]["loss_weight"] if cfg.get("iou_aware_loss_type") else None
    ignore = cfg["yolo_loss"]["ignore_thresh"]
    out: Dict[str, torch.Tensor] = {}

    def add(k, v):
        out[k] = out[k] + v if k in out else v

    g = gt_box.float()
    gt = torch.stack([g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2,
                      g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2], -1)
    for i, (o, t) in enumerate(zip(outputs, tgts)):
        o = o.float().permute(0, 2, 3, 1)
        mask = h["anchor_masks"][i]
        an = len(mask)
        anc = torch.tensor([h["anchors"][a] for a in mask], dtype=torch.float32, device=o.device)
        ds = h["downsample"][i]
        n, s = o.shape[:2]
        ioup = None
        if aware_w is not None:
            ioup, o = o[..., :an], o[..., an:]
        o = o.reshape(n, s, s, an, 5 + nc)
        x, y, w, hh, obj = o.unbind(-1)[:5]
        cls = o[..., 5:]
        tx, ty, tw, th, tscale, tobj = t[..., :6].unbind(-1)
        wgt = tscale * tobj
        dx = sxy * torch.sigmoid(x) - 0.5 * (sxy - 1.0)
        dy = sxy * torch.sigmoid(y) - 0.5 * (sxy - 1.0)
        add("loss_xy", ((dx - tx).abs() * wgt + (dy - ty).abs() * wgt).sum((1, 2, 3)).mean())
        add("loss_wh", ((w - tw).abs() * wgt + (hh - th).abs() * wgt).sum((1, 2, 3)).mean())
        pred = _decode(x, y, w, hh, anc, ds, sxy, False)
        tbox = _decode(tx, ty, tw, th, anc, ds, sxy, True)
        iouk = _iou(pred, tbox)
        if iou_w is not None:
            add("loss_iou", ((1 - iouk * iouk) * iou_w * wgt).sum((1, 2, 3)).mean())
        if aware_w is not None:
            la = iouk.detach() * torch.clamp_max(F.softplus(-ioup), _EPS_CAP) * aware_w * tobj
            add("loss_iou_aware", la.sum((1, 2, 3)).mean())
        pb = torch.stack(pred, -1).reshape(n, s * s * an, 4).detach()
        max_iou = pairwise_iou(pb, gt).amax(-1).reshape(n, s, s, an)
        noobj = (1.0 - (tobj > 0).float()) * (max_iou <= ignore).float()
        pos = (tobj * torch.clamp_max(F.softplus(-obj), _EPS_CAP)).sum((1, 2, 3))
        neg = (noobj * torch.clamp_max(F.softplus(obj), _EPS_CAP)).sum((1, 2, 3))
        add("loss_obj", (pos + neg).mean())
        add("loss_cls", (_bce_logits(cls, t[..., 6:]).sum(-1) * tobj).sum((1, 2, 3)).mean())
    return out
