"""The chip's peaks, the least time of a piece of work and the device-busy
reading of a profiler trace: frozen copies of `chip_smoke.py`'s
`PEAK_*` constants, `_bound` and `trace_split` at commit c6a9a8c.

`bound` takes the work's bytes and operations and returns the least time
the chip could take for it; `trace_split` takes the events of a Chrome
trace (the list, not the file) and returns the window's wall ms, the union
of its kernels' intervals and the top device operations.
"""
from __future__ import annotations

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bandwidth; the float32 work is float32-accurate, its products on the
# tensor cores in 3xTF32 (three TF32 products a float32 one), so it is
# bounded at a third of the dense TF32 rate; the float32 FMA rate outside
# the tensor cores beside it
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3
PEAK_BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, flops: float, tensor_cores: bool = False,
          bf16: bool = False) -> dict:
    """The least time for the work: its bytes at the HBM rate or its
    operations at the peak rate of the units that run them, whichever is
    longer (`bound_ms`)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    res = {"bytes": nbytes, "operations": flops}
    if bf16:
        rate, res["bound_rate"] = PEAK_BF16_FLOP_PER_S, "bf16 989 TFLOP/s"
    elif tensor_cores:
        rate = PEAK_3XTF32_FLOP_PER_S
        res["bound_rate"] = "3xTF32 165 TFLOP/s"
        res["bound_fma_ms"] = max(
            t_bytes, flops / PEAK_F32_FLOP_PER_S * 1e3)
    else:
        rate, res["bound_rate"] = PEAK_F32_FLOP_PER_S, "float32 67 TFLOP/s"
    t_ops = flops / rate * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def kernel_intervals(events: list) -> list:
    """(start us, end us, name) of every kernel event, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") == "kernel")


def union_us(intervals) -> float:
    """The length of the union of (start, end, ...) intervals sorted by
    start."""
    busy, end = 0.0, float("-inf")
    for iv in intervals:
        a, b = iv[0], iv[1]
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def trace_split(events: list) -> dict:
    """A profiler window's events read back: its wall ms (the span of its
    events, host and device), the device-busy ms (the union of its
    kernels' intervals), the device's idle share (1 - busy / wall), and
    the device operations with the most total time. None without a
    kernel."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = kernel_intervals(timed)
    if not kernels:
        return None
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e["dur"] for e in timed)
    busy = union_us(kernels)
    by_name: dict = {}
    for a, b, name in kernels:
        calls, total = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, total + (b - a))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "kernel_launches": len(kernels),
            "top_device_ops": [{"name": name, "calls": calls,
                                "ms": total / 1e3}
                               for name, (calls, total) in top]}
