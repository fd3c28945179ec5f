"""Seconds from the process's start to the window's first timed unit:
data generation, the program's build and kernel loads, warm-up."""


def read(rec):
    return rec.get("setup_s")
