"""Mean ms of a full-catalog `encode_all_anchors` in the window (the
benchmark's span; the call ends in a device sync)."""


def read(rec):
    spans = rec.get("spans", {}).get("encode")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
