"""The 95th percentile (linear between order statistics) of the latency
of the window's requests outside a traced section, from send to the
top-k on the host (a closed loop: the service time of a request)."""
import numpy as np


def read(rec):
    lat = rec.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))
