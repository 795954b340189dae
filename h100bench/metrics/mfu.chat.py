"""mfu.chat: model FLOPs of the window's tokens over the window at the bf16
peak, in % (h100bench/layers.py:mfu_window)."""

from h100bench import layers


def read(run):
    return layers.mfu_window(run)
