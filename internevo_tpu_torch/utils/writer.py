"""Scalar writer: tensorboard where ``torch.utils.tensorboard`` imports, a
JSONL file otherwise (port of ``internevo_tpu/utils/writer.py``; reference
``internlm/utils/writer.py:17-184``).  ``add_scalar`` logs and drops its
errors, as the reference's does."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .logger import get_logger

logger = get_logger(__name__)


class Writer:
    def __init__(self, job_name: str = "job", launch_time: str = "",
                 tensorboard_folder: Optional[str] = None, enable_tb: bool = True):
        self.enable_tb = enable_tb
        self.tb_writer = None
        self.jsonl_file = None
        if not enable_tb:
            return
        folder = tensorboard_folder or os.path.join("tb_logs", f"{job_name}_{launch_time}")
        os.makedirs(folder, exist_ok=True)
        self.folder = folder
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb_writer = SummaryWriter(log_dir=folder)
        except Exception:  # no tensorboard package: the JSONL file (JAX writer.py:27-33)
            self.jsonl_file = open(os.path.join(folder, "scalars.jsonl"), "a")

    def add_scalar(self, key: str, value, step: int):
        try:
            if self.tb_writer is not None:
                self.tb_writer.add_scalar(key, float(value), step)
            elif self.jsonl_file is not None:
                self.jsonl_file.write(json.dumps({"t": time.time(), "key": key,
                                                  "value": float(value), "step": step}) + "\n")
        except Exception as e:  # swallow (reference behaviour)
            logger.warning("writer.add_scalar failed: %s", e)

    def add_scalars(self, key: str, value: dict, step: int):
        for k, v in value.items():
            self.add_scalar(f"{key}/{k}", v, step)

    def add_text(self, key: str, value: str, step: int = 0):
        try:
            if self.tb_writer is not None:
                self.tb_writer.add_text(key, value, step)
        except Exception as e:
            logger.warning("writer.add_text failed: %s", e)

    def flush(self):
        if self.tb_writer is not None:
            self.tb_writer.flush()
        if self.jsonl_file is not None:
            self.jsonl_file.flush()

    def close(self):
        if self.tb_writer is not None:
            self.tb_writer.close()
        if self.jsonl_file is not None:
            self.jsonl_file.close()
