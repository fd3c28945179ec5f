"""TensorBoard writer with a lazy import and a no-op fallback (port of
`taxoexpan_tpu/utils/writer.py`): without a TensorBoard backend (torch's
`torch.utils.tensorboard` needs the `tensorboard` package, or
`tensorboardX`) every call does nothing. `set_step` tags train/valid mode
and emits a wall-clock steps_per_sec scalar."""
from __future__ import annotations

import logging
import time

logger = logging.getLogger(__name__)


class TensorboardWriter:
    def __init__(self, log_dir, enabled: bool = True):
        self.writer = None
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(str(log_dir))
            except Exception:
                try:
                    from tensorboardX import SummaryWriter
                    self.writer = SummaryWriter(str(log_dir))
                except Exception:
                    logger.warning(
                        "TensorBoard writer unavailable (install tensorboard "
                        "or tensorboardX to enable); logging scalars to the "
                        "python logger only.")
        self.step = 0
        self.mode = ""
        self._last = time.time()

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        self.step = step
        now = time.time()
        if step != 0 and now > self._last:
            self.add_scalar("steps_per_sec", 1.0 / (now - self._last))
        self._last = now

    def _tag(self, tag: str) -> str:
        return f"{tag}/{self.mode}" if self.mode else tag

    def add_scalar(self, tag: str, value) -> None:
        if self.writer is not None:
            self.writer.add_scalar(self._tag(tag), float(value), self.step)

    def add_histogram(self, tag: str, values) -> None:
        if self.writer is not None:
            self.writer.add_histogram(self._tag(tag), values, self.step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
