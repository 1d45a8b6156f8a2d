"""COCO test-dev submission json of the port (the root ``test_dev.py``).

    python -m ppyolo_tpu_torch.entry.test_dev --config 0 [--precision int8]

Detects every image of ``cfg.test_path`` and writes
``<result_dir>/bbox_detections.json`` for the evaluation server:
``entry.eval.main`` with ``type_='test_dev'``, the same flags.
"""
from __future__ import annotations

from typing import Optional

from .eval import main as eval_main


def main(argv: Optional[list] = None):
    return eval_main(argv, type_="test_dev")


if __name__ == "__main__":
    from ..utils.logger import setup_logger

    setup_logger()
    main()
