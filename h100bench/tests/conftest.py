"""Shared set-up of the benchmark's tests: the repository root on the path,
the `cuda` marker, and a tiny configuration the CPU runs (the port's plain
versions) in a few seconds.

Run: python -m pytest h100bench/tests -q   (tests marked `cuda` skip
without a card; on the card they run the cells' checks at full size)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card and skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


TINY_ROUTE_LIMIT = 0.02   # sound tiny runs read 0, the fp8 control 0.03-0.08

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
            max_position_embeddings=1024)


def tiny_files(moe: bool = False, gap_max: float = 0.05) -> dict:
    """A run's files for the tiny configuration: Mistral's (or Mixtral's, 4
    experts, top 2) at small widths, 4 lanes, short requests."""
    from h100bench import harness
    f = copy.deepcopy(harness.files("mistral7b-fp8.sharegpt"))
    f["cfg"].update(TINY)
    if moe:
        f["cfg"].update(num_local_experts=4, num_experts_per_tok=2)
    f["cell"] = dict(batch=4, trace_seconds=1.0,
                     check=dict(tokens=100, requests=3, prefix=16, tokens_min=10, gap_max=gap_max,
                                route_differ_share=TINY_ROUTE_LIMIT))
    lengths = dict(prompt_tokens=dict(dist="lognormal", median=40, sigma=0.6, min=8, max=300),
                   output_tokens=dict(dist="uniform", min=8, max=24), greedy_share=0.5,
                   sampled=f["mix"]["sampled"], reorder_span=4)
    f["mix"] = dict(kind="closed", clients=4, **lengths)
    return f
