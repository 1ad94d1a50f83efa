"""idle.in_program_share.pdcch (share): the device's idle seconds of the
blind-decoding cell's span window (``spans.span_window``, run by its
traffic after the traced window) during which the host was inside a
span of the program, over all of its idle seconds (the rest is
``caller``: the benchmark's loop)."""


def read(rec):
    w = rec.get("span_window")
    if not w or w["idle_s"] <= 0:
        return None
    return w["idle_in_program_s"] / w["idle_s"]
