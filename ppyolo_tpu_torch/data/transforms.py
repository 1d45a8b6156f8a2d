"""The PP-YOLO sample transforms (host side, numpy and cv2).

Counterpart of ``ppyolo_tpu/data/transforms.py``, op for op: the same
arithmetic and the same draws from an explicit ``np.random.RandomState``
in the same order (including the draws an augmentation with ``p < 1``
takes when it misses), so a seeded stream of samples is bitwise the JAX
package's.  The fused colour-distort, mixup and uint8 pack run through the
port's own ``native`` library, with the same numpy fallbacks.

Sample dict keys: ``image`` (HWC RGB), ``gt_bbox``, ``gt_class``,
``gt_score``, ``h``, ``w`` (and ``mixup``/``cutmix`` partner samples).
Images stay HWC throughout (NHWC batches), so ``Permute`` only flips to
BGR when asked.
"""
from __future__ import annotations

from numbers import Number


import numpy as np

from .. import native

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class BaseOperator:
    def __init__(self):
        self._id = type(self).__name__

    def __call__(self, sample, rng: np.random.RandomState):
        raise NotImplementedError

    def __str__(self):
        return self._id


class DecodeImage(BaseOperator):
    """imdecode + BGR->RGB; recursively decodes mixup/cutmix partners
    (reference transform.py:61-128)."""

    def __init__(self, to_rgb=True, with_mixup=False, with_cutmix=False):
        super().__init__()
        self.to_rgb = to_rgb
        self.with_mixup = with_mixup
        self.with_cutmix = with_cutmix

    def __call__(self, sample, rng):
        if "image" not in sample:
            with open(sample["im_file"], "rb") as f:
                sample["image"] = f.read()
        im = sample["image"]
        if isinstance(im, (bytes, bytearray)):
            im = cv2.imdecode(np.frombuffer(im, dtype=np.uint8), 1)
        if self.to_rgb and im.ndim == 3 and not sample.get("_rgb", False):
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        sample["image"] = im
        sample["h"] = im.shape[0]
        sample["w"] = im.shape[1]
        if self.with_mixup and "mixup" in sample:
            self(sample["mixup"], rng)
        if self.with_cutmix and "cutmix" in sample:
            self(sample["cutmix"], rng)
        return sample


class MixupImage(BaseOperator):
    """Beta-blend two images; concat gts with factor-weighted scores
    (reference transform.py:131-191)."""

    def __init__(self, alpha=1.5, beta=1.5):
        super().__init__()
        assert alpha > 0 and beta > 0
        self.alpha = alpha
        self.beta = beta

    def __call__(self, sample, rng):
        if "mixup" not in sample:
            return sample
        factor = float(np.clip(rng.beta(self.alpha, self.beta), 0.0, 1.0))
        if factor >= 1.0:
            sample.pop("mixup")
            return sample
        if factor <= 0.0:
            return sample["mixup"]
        other = sample["mixup"]
        img1, img2 = sample["image"], other["image"]
        h = max(img1.shape[0], img2.shape[0])
        w = max(img1.shape[1], img2.shape[1])
        out = native.mixup_u8(img1, img2, factor)  # fused single pass
        if out is None:  # no native lib / non-u8 inputs: numpy chain
            img = np.zeros((h, w, img1.shape[2]), np.float32)
            img[: img1.shape[0], : img1.shape[1]] = (
                img1.astype(np.float32) * factor)
            img[: img2.shape[0], : img2.shape[1]] += (
                img2.astype(np.float32) * (1 - factor))
            out = img.astype(np.uint8)
        sample["image"] = out
        sample["gt_bbox"] = np.concatenate([sample["gt_bbox"], other["gt_bbox"]], 0)
        sample["gt_class"] = np.concatenate([sample["gt_class"], other["gt_class"]], 0)
        sample["gt_score"] = np.concatenate(
            [sample["gt_score"] * factor, other["gt_score"] * (1 - factor)], 0)
        if "is_crowd" in sample and "is_crowd" in other:
            sample["is_crowd"] = np.concatenate(
                [sample["is_crowd"], other["is_crowd"]], 0)
        sample["h"], sample["w"] = h, w
        sample.pop("mixup")
        return sample


class CutmixImage(BaseOperator):
    """Cut-and-paste mix (capability slot for cutmix_epoch; rarely enabled)."""

    def __init__(self, alpha=1.5, beta=1.5):
        super().__init__()
        self.alpha = alpha
        self.beta = beta

    def __call__(self, sample, rng):
        if "cutmix" not in sample:
            return sample
        other = sample.pop("cutmix")
        factor = float(np.clip(rng.beta(self.alpha, self.beta), 0.0, 1.0))
        img1 = sample["image"].astype(np.float32)
        img2 = other["image"].astype(np.float32)
        h = max(img1.shape[0], img2.shape[0])
        w = max(img1.shape[1], img2.shape[1])
        cut_rat = np.sqrt(1.0 - factor)
        cut_w, cut_h = int(w * cut_rat), int(h * cut_rat)
        cx, cy = rng.randint(w), rng.randint(h)
        x1, y1 = np.clip(cx - cut_w // 2, 0, w), np.clip(cy - cut_h // 2, 0, h)
        x2, y2 = np.clip(cx + cut_w // 2, 0, w), np.clip(cy + cut_h // 2, 0, h)
        canvas = np.zeros((h, w, 3), np.float32)
        canvas[: img1.shape[0], : img1.shape[1]] = img1
        canvas[y1:y2, x1:x2] = 0
        # paste only the part of the cut rectangle the partner image covers
        # (partial overlap is the common case when the partner is smaller);
        # the uncovered remainder stays zeroed
        ye, xe = min(y2, img2.shape[0]), min(x2, img2.shape[1])
        if ye > y1 and xe > x1:
            canvas[y1:ye, x1:xe] = img2[y1:ye, x1:xe]
        sample["image"] = canvas.astype(np.uint8)
        sample["gt_bbox"] = np.concatenate([sample["gt_bbox"], other["gt_bbox"]], 0)
        sample["gt_class"] = np.concatenate([sample["gt_class"], other["gt_class"]], 0)
        sample["gt_score"] = np.concatenate(
            [sample["gt_score"] * factor, other["gt_score"] * (1 - factor)], 0)
        if "is_crowd" in sample and "is_crowd" in other:
            # keep per-box arrays in lock-step (RandomCrop np.take's on it)
            sample["is_crowd"] = np.concatenate(
                [sample["is_crowd"], other["is_crowd"]], 0)
        sample["h"], sample["w"] = h, w
        return sample


class PhotometricDistort(BaseOperator):
    """SSD-style photometric distortions (reference transform.py:194-239)."""

    def __call__(self, sample, rng):
        image = sample["image"].astype(np.float32)
        if rng.randint(2):
            image += rng.uniform(-32, 32)
        state = rng.randint(2)
        if state == 0 and rng.randint(2):
            image *= rng.uniform(0.5, 1.5)
        image = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
        if rng.randint(2):
            image[:, :, 1] *= rng.uniform(0.5, 1.5)
        if rng.randint(2):
            image[:, :, 0] += rng.uniform(-18.0, 18.0)
            image[:, :, 0][image[:, :, 0] > 360.0] -= 360.0
            image[:, :, 0][image[:, :, 0] < 0.0] += 360.0
        image = cv2.cvtColor(image, cv2.COLOR_HSV2RGB)
        if state == 1 and rng.randint(2):
            image *= rng.uniform(0.5, 1.5)
        sample["image"] = image
        return sample


class ColorDistort(BaseOperator):
    """Random hue/saturation/contrast/brightness in random order
    (reference transform.py:479-612, random_apply path).

    The RNG draws (permutation, per-op skip uniform, per-op delta) happen
    up front in exactly the order the reference's per-op functions draw
    them; the drawn chain is then applied either as ONE fused native pass
    over the pixels (``native.color_distort`` — all four sub-ops are
    per-pixel maps, so fusing them is bitwise-free and removes every
    full-image temporary; this was the loader's worst op at 34% of sample
    time in the JAX package's loader benchmark) or as the equivalent per-op
    numpy chain when the native lib is unavailable; the two are bitwise
    the same (tests/test_torch_port_data.py)."""

    # draw order index -> op; codes match native/host_ops.cpp
    _OP_ATTRS = ("brightness", "contrast", "saturation", "hue")
    _GRAY_W = (np.float32(0.299), np.float32(0.587), np.float32(0.114))

    def __init__(self, hue=(-18, 18, 0.5), saturation=(0.5, 1.5, 0.5),
                 contrast=(0.5, 1.5, 0.5), brightness=(0.5, 1.5, 0.5),
                 random_apply=True, hsv_format=False, random_channel=False):
        super().__init__()
        self.hue, self.saturation = hue, saturation
        self.contrast, self.brightness = contrast, brightness
        self.random_apply = random_apply
        self.hsv_format = hsv_format
        self.random_channel = random_channel

    @staticmethod
    def _hue_matrix(delta):
        """RGB-space hue rotation via YIQ (reference transform.py:497-515);
        3x3 math in f64, cast once — a float64 t would promote the whole
        image dot to f64 (2x cost).  Returns np.dot's rhs ([k, j])."""
        u = np.cos(delta * np.pi)
        w = np.sin(delta * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        tyiq = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]])
        ityiq = np.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]])
        return np.dot(np.dot(ityiq, bt), tyiq).T.astype(np.float32)

    def _draw_ops(self, rng):
        """Permutation + per-op draws, RNG-order-identical to the
        reference's brightness/contrast/saturation/hue functions: one
        uniform(0,1) skip draw each, then uniform(low,high) if applied."""
        ops = []
        # map the historical fns-list index (brightness, contrast,
        # saturation, hue) to the native op code (same order)
        for i in rng.permutation(len(self._OP_ATTRS)):
            low, high, prob = getattr(self, self._OP_ATTRS[int(i)])
            if rng.uniform(0.0, 1.0) < prob:
                continue
            ops.append((int(i), rng.uniform(low, high)))
        return ops

    def _apply_numpy(self, img, code, delta):
        """One sub-op, exactly the pre-fusion numpy arithmetic."""
        img = img.astype(np.float32, copy=False)
        if code == 0:  # brightness
            return img + delta
        if code == 1:  # contrast
            return img * delta
        if code == 2:  # saturation
            gray = (img * np.array([[self._GRAY_W]], np.float32)).sum(
                axis=2, keepdims=True)
            return img * delta + gray * (1.0 - delta)
        return np.dot(img, self._hue_matrix(delta))  # hue

    def _pack_params(self, ops):
        params = np.zeros((len(ops), 12), np.float32)
        for o, (code, delta) in enumerate(ops):
            if code == 2:
                params[o, 0] = np.float32(delta)
                params[o, 1] = np.float32(1.0 - delta)
                params[o, 2:5] = self._GRAY_W
            elif code == 3:
                params[o, :9] = np.ascontiguousarray(
                    self._hue_matrix(delta)).ravel()
            else:
                params[o, 0] = np.float32(delta)
        return params

    def __call__(self, sample, rng):
        img = sample["image"]
        ops = self._draw_ops(rng)
        if ops:
            codes = np.array([c for c, _ in ops], np.int32)
            out = native.color_distort(img, codes, self._pack_params(ops))
            if out is None:  # no native lib: equivalent per-op numpy chain
                for code, delta in ops:
                    img = self._apply_numpy(img, code, delta)
                out = img
            img = out
        sample["image"] = img
        return sample


class RandomExpand(BaseOperator):
    """Paste onto a larger fill-value canvas (reference transform.py:618-705)."""

    def __init__(self, ratio=4.0, prob=0.5, fill_value=(127.5,) * 3):
        super().__init__()
        assert ratio > 1.01
        if isinstance(fill_value, Number):
            fill_value = (fill_value,) * 3
        self.ratio = ratio
        self.prob = prob
        self.fill_value = tuple(fill_value)

    def __call__(self, sample, rng):
        if rng.uniform(0.0, 1.0) < self.prob:
            return sample
        img = sample["image"]
        height, width = int(sample["h"]), int(sample["w"])
        expand_ratio = rng.uniform(1.0, self.ratio)
        h, w = int(height * expand_ratio), int(width * expand_ratio)
        if not (h > height and w > width):
            return sample
        y = rng.randint(0, h - height)
        x = rng.randint(0, w - width)
        # empty + fill: numpy's [3]-vector broadcast-assign walks the canvas
        # element-wise (~30x slower than the memset fill() path, measured);
        # the fill is uniform for every shipped config (127.5 -> 127), so
        # memset, with per-channel fills for a non-uniform custom value
        canvas = np.empty((h, w, 3), np.uint8)
        fv = np.array(self.fill_value, np.uint8)
        if fv[0] == fv[1] == fv[2]:
            canvas.fill(fv[0])
        else:
            for ch in range(3):
                canvas[:, :, ch].fill(fv[ch])
        # direct assignment casts with the same C semantics as astype(uint8)
        # but skips the intermediate full-image copy
        canvas[y:y + height, x:x + width] = img
        sample["h"], sample["w"] = h, w
        sample["image"] = canvas
        if len(sample.get("gt_bbox", [])) > 0:
            sample["gt_bbox"] = sample["gt_bbox"] + np.array(
                [x, y, x, y], np.float32)
        return sample


class RandomCrop(BaseOperator):
    """IoU-threshold random crop with the center constraint
    (reference transform.py:242-475)."""

    def __init__(self, aspect_ratio=(0.5, 2.0),
                 thresholds=(0.0, 0.1, 0.3, 0.5, 0.7, 0.9),
                 scaling=(0.3, 1.0), num_attempts=50, allow_no_crop=True,
                 cover_all_box=False):
        super().__init__()
        self.aspect_ratio = aspect_ratio
        self.thresholds = list(thresholds)
        self.scaling = scaling
        self.num_attempts = num_attempts
        self.allow_no_crop = allow_no_crop
        self.cover_all_box = cover_all_box

    @staticmethod
    def _iou_matrix(a, b):
        tl = np.maximum(a[:, None, :2], b[:, :2])
        br = np.minimum(a[:, None, 2:], b[:, 2:])
        area_i = np.prod(br - tl, axis=2) * (tl < br).all(axis=2)
        area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
        area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
        return area_i / (area_a[:, None] + area_b - area_i + 1e-10)

    @staticmethod
    def _crop_with_center_constraint(box, crop):
        cropped = box.copy()
        cropped[:, :2] = np.maximum(box[:, :2], crop[:2])
        cropped[:, 2:] = np.minimum(box[:, 2:], crop[2:])
        cropped[:, :2] -= crop[:2]
        cropped[:, 2:] -= crop[:2]
        centers = (box[:, :2] + box[:, 2:]) / 2
        valid = np.logical_and(crop[:2] <= centers, centers < crop[2:]).all(1)
        valid = np.logical_and(valid, (cropped[:, :2] < cropped[:, 2:]).all(1))
        return cropped, np.where(valid)[0]

    def __call__(self, sample, rng):
        if len(sample.get("gt_bbox", [])) == 0:
            return sample
        h, w = sample["h"], sample["w"]
        gt_bbox = sample["gt_bbox"]
        thresholds = list(self.thresholds)
        if self.allow_no_crop:
            thresholds.append("no_crop")
        rng.shuffle(thresholds)
        for thresh in thresholds:
            if thresh == "no_crop":
                return sample
            for _ in range(self.num_attempts):
                scale = rng.uniform(*self.scaling)
                min_ar, max_ar = self.aspect_ratio
                aspect_ratio = rng.uniform(
                    max(min_ar, scale ** 2), min(max_ar, scale ** -2))
                crop_h = int(h * scale / np.sqrt(aspect_ratio))
                crop_w = int(w * scale * np.sqrt(aspect_ratio))
                if h - crop_h <= 0 or w - crop_w <= 0:
                    continue
                crop_y = rng.randint(0, h - crop_h)
                crop_x = rng.randint(0, w - crop_w)
                crop_box = [crop_x, crop_y, crop_x + crop_w, crop_y + crop_h]
                iou = self._iou_matrix(
                    gt_bbox, np.array([crop_box], np.float32))
                if iou.max() < thresh:
                    continue
                if self.cover_all_box and iou.min() < thresh:
                    continue
                cropped_box, valid_ids = self._crop_with_center_constraint(
                    gt_bbox, np.array(crop_box, np.float32))
                if valid_ids.size > 0:
                    x1, y1, x2, y2 = crop_box
                    sample["image"] = sample["image"][y1:y2, x1:x2, :]
                    sample["gt_bbox"] = np.take(cropped_box, valid_ids, axis=0)
                    sample["gt_class"] = np.take(
                        sample["gt_class"], valid_ids, axis=0)
                    sample["w"] = x2 - x1
                    sample["h"] = y2 - y1
                    if "gt_score" in sample:
                        sample["gt_score"] = np.take(
                            sample["gt_score"], valid_ids, axis=0)
                    if "is_crowd" in sample:
                        sample["is_crowd"] = np.take(
                            sample["is_crowd"], valid_ids, axis=0)
                    return sample
        return sample


class RandomFlipImage(BaseOperator):
    """Horizontal flip (reference transform.py:709-820)."""

    def __init__(self, prob=0.5, is_normalized=False):
        super().__init__()
        self.prob = prob
        self.is_normalized = is_normalized

    def __call__(self, sample, rng):
        if rng.uniform(0, 1) >= self.prob:
            return sample
        im = sample["image"]
        height, width = im.shape[:2]
        sample["image"] = im[:, ::-1, :]
        gt_bbox = sample["gt_bbox"]
        if gt_bbox.shape[0] == 0:
            return sample
        oldx1 = gt_bbox[:, 0].copy()
        oldx2 = gt_bbox[:, 2].copy()
        if self.is_normalized:
            gt_bbox[:, 0] = 1 - oldx2
            gt_bbox[:, 2] = 1 - oldx1
        else:
            gt_bbox[:, 0] = width - oldx2 - 1
            gt_bbox[:, 2] = width - oldx1 - 1
        sample["gt_bbox"] = gt_bbox
        sample["flipped"] = True
        return sample


class NormalizeBox(BaseOperator):
    """Scale box coordinates into [0,1] (reference transform.py:822-849)."""

    def __call__(self, sample, rng):
        gt_bbox = sample["gt_bbox"].astype(np.float32)
        if gt_bbox.shape[0]:
            gt_bbox[:, 0::2] /= float(sample["w"])
            gt_bbox[:, 1::2] /= float(sample["h"])
        sample["gt_bbox"] = gt_bbox
        return sample


class BboxXYXY2XYWH(BaseOperator):
    """xyxy -> (cx, cy, w, h) (reference transform.py:851-865)."""

    def __call__(self, sample, rng):
        bbox = sample["gt_bbox"]
        if bbox.shape[0]:
            bbox[:, 2:4] = bbox[:, 2:4] - bbox[:, :2]
            bbox[:, :2] = bbox[:, :2] + bbox[:, 2:4] / 2.0
        sample["gt_bbox"] = bbox
        return sample


class PadBox(BaseOperator):
    """Pad gt arrays to num_max_boxes (reference transform.py:1141-1179)."""

    def __init__(self, num_max_boxes=50):
        super().__init__()
        self.num_max_boxes = num_max_boxes

    def __call__(self, sample, rng):
        bbox = sample["gt_bbox"]
        n = min(self.num_max_boxes, len(bbox))
        pad_bbox = np.zeros((self.num_max_boxes, 4), np.float32)
        pad_class = np.zeros((self.num_max_boxes,), np.int32)
        pad_score = np.zeros((self.num_max_boxes,), np.float32)
        if n > 0:
            pad_bbox[:n] = bbox[:n]
            pad_class[:n] = np.reshape(sample["gt_class"], (-1,))[:n]
            pad_score[:n] = np.reshape(sample["gt_score"], (-1,))[:n]
        sample["gt_bbox"] = pad_bbox
        sample["gt_class"] = pad_class
        sample["gt_score"] = pad_score
        return sample


class NormalizeImage(BaseOperator):
    """(x/255 - mean) / std (reference transform.py:868-921)."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(1, 1, 1),
                 is_scale=True, is_channel_first=False):
        super().__init__()
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.is_scale = is_scale

    def __call__(self, sample, rng):
        im = sample["image"].astype(np.float32)
        if self.is_scale:
            im = im / 255.0
        im -= self.mean
        im /= self.std
        sample["image"] = im
        return sample


class Permute(BaseOperator):
    """HWC->CHW in the reference (transform.py:1028-1063).  Batches here are
    NHWC end to end, so channel_first is a no-op; to_bgr supported."""

    def __init__(self, to_bgr=False, channel_first=True):
        super().__init__()
        self.to_bgr = to_bgr

    def __call__(self, sample, rng):
        if self.to_bgr:
            sample["image"] = sample["image"][..., ::-1]
        return sample


class ResizeImage(BaseOperator):
    """Resize to a square target (max_size==0 branch of transform.py:923-1026)."""

    def __init__(self, target_size=0, max_size=0, interp=cv2.INTER_LINEAR if cv2 else 1,
                 use_cv2=True):
        super().__init__()
        self.target_size = target_size
        self.max_size = int(max_size)
        self.interp = int(interp)

    def __call__(self, sample, rng):
        im = sample["image"]
        target = (rng.choice(self.target_size)
                  if isinstance(self.target_size, (list, tuple))
                  else self.target_size)
        if self.max_size != 0:
            im_size_min = np.min(im.shape[0:2])
            im_size_max = np.max(im.shape[0:2])
            im_scale = float(target) / float(im_size_min)
            if np.round(im_scale * im_size_max) > self.max_size:
                im_scale = float(self.max_size) / float(im_size_max)
            sample["image"] = cv2.resize(im, None, None, fx=im_scale,
                                         fy=im_scale, interpolation=self.interp)
        else:
            sample["image"] = cv2.resize(
                im, None, None,
                fx=float(target) / im.shape[1],
                fy=float(target) / im.shape[0],
                interpolation=self.interp)
        return sample


_RANDOM_INTERPS = None


def _interps():
    global _RANDOM_INTERPS
    if _RANDOM_INTERPS is None:
        _RANDOM_INTERPS = [cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_AREA,
                           cv2.INTER_CUBIC, cv2.INTER_LANCZOS4]
    return _RANDOM_INTERPS


class RandomShapeSingle(BaseOperator):
    """Resize one image to the batch-chosen square shape
    (reference transform.py:1109-1139)."""

    def __init__(self, random_inter=False, resize_box=False):
        super().__init__()
        self.random_inter = random_inter
        self.resize_box = resize_box

    def __call__(self, shape, sample, rng, dst=None):
        method = (int(rng.choice(_interps())) if self.random_inter
                  else cv2.INTER_NEAREST)
        im = sample["image"]
        h, w = im.shape[:2]
        scale_x = float(shape) / w
        scale_y = float(shape) / h
        # explicit dsize: fx/fy rounding could yield shape+-1 and break the
        # static-shape batch stack
        if (dst is not None and im.dtype == dst.dtype
                and im.ndim == dst.ndim
                and (im.ndim < 3 or im.shape[2] == dst.shape[2])):
            # channel/rank must match too: cv2.resize(dst=) silently
            # allocates internally on mismatch and leaves `dst` (the
            # PREVIOUS sample's pixels) untouched
            # resize into the caller's reusable scratch (assemble_batch's
            # per-batch buffer — skips one full-image malloc per sample;
            # values bitwise-identical to the allocating call)
            cv2.resize(im, (int(shape), int(shape)), dst=dst,
                       interpolation=method)
            sample["image"] = dst
        else:
            sample["image"] = cv2.resize(im, (int(shape), int(shape)),
                                         interpolation=method)
        if self.resize_box and len(sample.get("gt_bbox", [])) > 0:
            scale = np.array([scale_x, scale_y] * 2, np.float32)
            sample["gt_bbox"] = np.clip(sample["gt_bbox"] * scale, 0,
                                        float(shape) - 1)
        return sample


class RandomShape(RandomShapeSingle):
    """Batch-level random shape: one size for the whole batch
    (reference transform.py:1065-1107)."""

    def __init__(self, sizes=(), random_inter=False, resize_box=False):
        super().__init__(random_inter=random_inter, resize_box=resize_box)
        self.sizes = list(sizes)

    def __call__(self, samples, rng):
        shape = int(rng.choice(self.sizes))
        for s in samples:
            RandomShapeSingle.__call__(self, shape, s, rng)
        return samples


class Gt2YoloTargetSingle(BaseOperator):
    """Per-sample static target assignment, API-compatible with the
    reference op (transform.py:1318-1421) but backed by the vectorized
    scatter in data/targets.py.  Writes sample['target{i}'] in the
    [gh, gw, an, 6+C] layout."""

    def __init__(self, anchors, anchor_masks, downsample_ratios,
                 num_classes=80, iou_thresh=1.0):
        super().__init__()
        self.anchors = anchors
        self.anchor_masks = anchor_masks
        self.downsample_ratios = downsample_ratios
        self.num_classes = num_classes
        self.iou_thresh = iou_thresh

    def __call__(self, sample, rng=None):
        from .targets import gt2yolo_targets

        h, w = sample["image"].shape[0:2]
        targets = gt2yolo_targets(
            sample["gt_bbox"][None],
            np.reshape(sample["gt_class"], (1, -1)),
            np.reshape(sample["gt_score"], (1, -1)).astype(np.float32),
            (h, w), self.anchors, self.anchor_masks, self.downsample_ratios,
            self.num_classes, iou_thresh=self.iou_thresh)
        for i, t in enumerate(targets):
            sample[f"target{i}"] = t[0]
        return sample


class Gt2YoloTarget(Gt2YoloTargetSingle):
    """Batch-level variant (reference transform.py:1211-1315)."""

    def __call__(self, samples, rng=None):
        for s in samples:
            Gt2YoloTargetSingle.__call__(self, s, rng)
        return samples


# name registry used by the config-driven pipeline builder
SAMPLE_OPS = {
    "decodeImage": DecodeImage,
    "mixupImage": MixupImage,
    "cutmixImage": CutmixImage,
    "photometricDistort": PhotometricDistort,
    "colorDistort": ColorDistort,
    "randomExpand": RandomExpand,
    "randomCrop": RandomCrop,
    "randomFlipImage": RandomFlipImage,
    "normalizeBox": NormalizeBox,
    "padBox": PadBox,
    "bboxXYXY2XYWH": BboxXYXY2XYWH,
}
