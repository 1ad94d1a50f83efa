"""setup_s (s): process start to the first measured call."""


def read(rec):
    return rec.get("setup_s")
