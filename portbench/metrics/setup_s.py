"""Seconds from the process's start to the window's: loading, drawing the
weights and inputs, building the service or trainer, warming up."""


def read(ctx):
    return ctx["setup_s"]
