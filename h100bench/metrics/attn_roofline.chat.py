"""attn_roofline.chat: the tick attention's bounds over the lanes split's
device time, in % (h100bench/layers.py:attn_roofline)."""

from h100bench import layers


def read(run):
    return layers.attn_roofline(run)
