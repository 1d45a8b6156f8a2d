"""A synthetic COCO dataset of drawn coloured-square objects.

Counterpart of ``ppyolo_tpu/data/synthetic.py`` (the same images and the
same annotations from the same ``RandomState``).  Objects are solid-colour
squares keyed by class, so they are learnable.  The annotation json follows
the COCO detection schema the loader reads (``data/coco.py``): xywh float
bboxes, 1-based category ids, iscrowd=0, per-image width and height.
"""
import json
import os

import numpy as np

# class -> fill color; classes beyond the base palette get a deterministic
# distinct color from _class_color so EVERY configured class is drawable
# (and therefore gets gt annotations) no matter how large n_classes is
PALETTE = [(255, 0, 0), (0, 255, 0), (0, 0, 255),
           (255, 255, 0), (255, 0, 255), (0, 255, 255)]


def _class_color(cls):
    if cls < len(PALETTE):
        return PALETTE[cls]
    # coprime strides over [40, 240) keep extra classes mutually distinct
    # and away from the base palette's saturated corners
    return ((37 * cls + 53) % 200 + 40,
            (91 * cls + 17) % 200 + 40,
            (151 * cls + 101) % 200 + 40)


def make_synthetic_coco(root, n_images, n_classes, rng, *,
                        image_sizes=((480, 640), (640, 480), (512, 512)),
                        max_objects=3, box_range=(60, 160)):
    """Write ``root/imgs/*.jpg`` + ``root/train.json``; return (json, dir/).

    ``image_sizes`` are (h, w) pairs cycled per image; each image gets
    1..max_objects square objects with side lengths drawn uniformly from
    ``box_range`` (inclusive) at positions drawn from ``rng``.  Classes
    cycle deterministically over the object counter so every class is
    represented even in tiny datasets.
    """
    import cv2

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, annos = [], []
    aid = 1
    for i in range(n_images):
        h, w = image_sizes[i % len(image_sizes)]
        img = rng.randint(40, 200, (h, w, 3)).astype(np.uint8)
        n_obj = 1 if max_objects <= 1 else int(rng.randint(1, max_objects + 1))
        for _ in range(n_obj):
            cls = (aid - 1) % n_classes
            bw = int(rng.randint(box_range[0], box_range[1] + 1))
            bh = int(rng.randint(box_range[0], box_range[1] + 1))
            x = int(rng.randint(0, w - bw))
            y = int(rng.randint(0, h - bh))
            img[y:y + bh, x:x + bw] = _class_color(cls)
            annos.append({"id": aid, "image_id": i + 1,
                          "category_id": cls + 1,
                          "bbox": [float(x), float(y), float(bw), float(bh)],
                          "area": float(bw * bh), "iscrowd": 0})
            aid += 1
        fname = f"im{i:04d}.jpg"
        cv2.imwrite(os.path.join(img_dir, fname), img)
        images.append({"id": i + 1, "file_name": fname,
                       "width": w, "height": h})
    anno = {"images": images, "annotations": annos,
            "categories": [{"id": c + 1, "name": f"c{c}"}
                           for c in range(n_classes)]}
    anno_path = os.path.join(root, "train.json")
    with open(anno_path, "w") as f:
        json.dump(anno, f)
    return anno_path, img_dir + "/"
