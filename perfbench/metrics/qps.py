"""Queries whose answers reached the host inside the window, over the
window's seconds (host clock)."""


def read(rec):
    return rec["window"].qps()
