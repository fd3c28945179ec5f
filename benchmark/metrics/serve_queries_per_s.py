"""New concepts whose top-k parents reached the host in the window, over
the window's seconds."""


def read(rec):
    if "queries" not in rec or rec["window_s"] <= 0:
        return None
    return rec["queries"] / rec["window_s"]
