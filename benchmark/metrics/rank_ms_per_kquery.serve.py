"""ms of `predict_parents` (the ranking: the matcher's products and the
top-k) per 1,000 new concepts, over the window's requests outside a traced
section (the benchmark's span)."""


def read(rec):
    spans = rec.get("spans", {}).get("rank")
    queries = rec.get("queries", 0) - rec.get("traced", {}).get("queries", 0)
    if not spans or queries <= 0:
        return None
    return 1e3 * sum(spans) / (queries / 1e3)
