"""Mean ms a window step waited on the feed's `next()` for its device
batch (the benchmark's span around it)."""


def read(rec):
    waits = rec.get("spans", {}).get("feed_wait")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
