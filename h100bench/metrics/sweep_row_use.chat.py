"""sweep_row_use.chat: prompt rows hydrated over rows swept by the window's
sweeps and chunks, in % (h100bench/layers.py:sweep_row_use)."""

from h100bench import layers


def read(run):
    return layers.sweep_row_use(run)
