"""setup_s: process start to the window's opening: imports, weights made on
the card, the server and its cache, the kernel library loaded (built on a
checkout's first run), the warm-up, the load's ramp."""


def read(run):
    return run.setup_s
