"""tick_ms.chat: mean host wall of a tick, outside the profiled slice
(h100bench/layers.py:tick_ms)."""

from h100bench import layers


def read(run):
    return layers.tick_ms(run)
