"""The model's work in the window (counted from its shapes and valid rows
by `benchmark/work.py`) over the window's seconds, as a share of the
chip's float32-accurate peak (3xTF32, 165 TFLOP/s); the units of a traced
section, and its time, are left out."""
from benchmark import work


def read(rec):
    if not rec.get("ops"):
        return None
    return work.mfu_pct(rec["ops"] - rec.get("traced", {}).get("ops", 0.0),
                        rec["window_s"] - rec.get("traced_s", 0.0))
