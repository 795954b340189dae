from .cache import KVCache
from .fast import (FastScales, FastWeights, decode_step_fast, fast_supported,
                   fast_weights_from_numpy, load_fast_weights, prefill_fast)

__all__ = ["KVCache", "FastScales", "FastWeights", "decode_step_fast",
           "fast_supported", "fast_weights_from_numpy", "load_fast_weights",
           "prefill_fast"]
