"""Device kernels a train step launched in the traced section."""


def read(rec):
    sec = rec.get("section_summary")
    if not sec or not rec.get("section_units") or not sec["launches"]:
        return None
    return sec["launches"] / rec["section_units"]
