"""The median host time of the window's steps outside a traced section:
the wait for the batch plus the step's call, in ms. Steadier than
`train_egonets_per_s` when the host is shared: a stretch of slow steps
moves the mean, not the median."""
import numpy as np


def read(rec):
    log = [w + c for w, c, _epoch, traced in rec.get("step_log", ())
           if not traced]
    if not log:
        return None
    return float(np.median(np.asarray(log)))
