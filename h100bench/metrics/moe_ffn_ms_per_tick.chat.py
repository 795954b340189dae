"""moe_ffn_ms_per_tick.chat: CUDA-event time of the MoE FFN per tick
(h100bench/layers.py:moe_ffn_ms_per_tick)."""

from h100bench import layers


def read(run):
    return layers.moe_ffn_ms_per_tick(run)
