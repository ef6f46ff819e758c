"""Structured per-epoch records beside the console lines.

The reference only prints (handler.py:167-168,83-84); the engine keeps
those lines and adds a JSONL stream of per-epoch records (loss, LR, epoch
time, windows/s, validation metrics). A copy of stemgnn_tpu/utils/logging.py
`JsonlLogger`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, record: Dict[str, Any]) -> None:
        if not self.path:
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
