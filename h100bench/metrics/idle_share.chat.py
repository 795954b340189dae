"""idle_share.chat: device idle share of the profiled slice, in %
(h100bench/layers.py:idle_share)."""

from h100bench import layers


def read(run):
    return layers.idle_share(run)
