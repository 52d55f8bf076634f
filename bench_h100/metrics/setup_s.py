"""Seconds from the process's start to the window's: imports, weights on
the card, the kernel build (first run in a checkout), captures, warm-up."""


def read(ctx):
    return ctx["setup_s"]
