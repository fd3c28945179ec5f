"""The propagation layers' least time (`benchmark/work.py`, bounded by the
HBM rate or the 3xTF32 rate) over the device time of the kernels those
layers launched in the traced section (attributed by launch, see
`benchmark/tracing.py`), in %."""


def read(rec):
    t = rec.get("prop_kernel_s")
    if not t or not rec.get("prop_bound_s"):
        return None
    return 100.0 * rec["prop_bound_s"] / t
