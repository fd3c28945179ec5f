"""Real egonets (cand_mask true) of every train step completed in the
window, over the window's seconds; the window ends in a device sync."""


def read(rec):
    if "egonets" not in rec or rec["window_s"] <= 0:
        return None
    return rec["egonets"] / rec["window_s"]
