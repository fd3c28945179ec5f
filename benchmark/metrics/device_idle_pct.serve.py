"""1 - the union of the kernels' intervals over the wall time of the
traced stretch's device-only section (CUDA activity alone, no host ranges;
from sync to sync), in %."""


def read(rec):
    sec = rec.get("idle_summary")
    if not sec or not sec["launches"] or sec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sec["busy_s"] / sec["window_s"])
