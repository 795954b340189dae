"""admit_ms.chat: mean CUDA-event span of an admission step that ran a chunk
(h100bench/layers.py:admit_ms)."""

from h100bench import layers


def read(run):
    return layers.admit_ms(run)
