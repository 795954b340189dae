"""The plain reference against the port's float32 oracle
(`yalm_tpu_torch.models.transformer.prefill`) on a tiny seeded
configuration on the CPU, dense and MoE: the same weights, the same
function to float32 rounding. The test imports the port; the reference
does not."""

import pytest
import torch

from h100bench.reference.judge import control_gaps, served_gaps
from h100bench.reference.model import Reference
from h100bench.weights import synth

from .conftest import tiny_files


def _oracle_logits(cfg: dict, w: dict, tokens: list[int]) -> torch.Tensor:
    from yalm_tpu_torch.models.cache import KVCache
    from yalm_tpu_torch.models.transformer import prefill
    from yalm_tpu_torch.models.weights import LayerWeights, Weights
    from h100bench.serve import port_config
    mc = port_config(cfg)
    qd, kd, h = mc.q_dim, mc.kv_dim, mc.hidden_dim
    f32 = {k: (v.float() if v is not None else None) for k, v in w.items()}
    wqkv, w13 = f32["wqkv"], f32["w13"]
    layers = LayerWeights(
        rms_att=f32["rms_att"], rms_ffn=f32["rms_ffn"], wq=wqkv[:, :qd], wk=wqkv[:, qd:qd + kd],
        wv=wqkv[:, qd + kd:], wo=f32["wo"], w1=w13[..., :h, :], w2=f32["w2"],
        w3=w13[..., h:, :], moegate=f32["moegate"])
    weights = Weights(embed=f32["embed"], layers=layers, final_norm=f32["final_norm"],
                      lm_head=f32["lm_head"])
    cache = KVCache.init(mc, torch.float32, "cpu")
    out, _ = prefill(mc, weights, tokens, 0, len(tokens), cache, logits_mode="all",
                     compute_dtype=torch.float32)
    return out


@pytest.mark.parametrize("moe", [False, True])
def test_reference_is_the_port_oracle_function(moe):
    cfg = tiny_files(moe=moe)["cfg"]
    w = synth(cfg, "cpu", 2**31 + 3)
    g = torch.Generator().manual_seed(1)
    tokens = [1] + torch.randint(3, cfg["vocab_size"], (70,), generator=g).tolist()
    want = _oracle_logits(cfg, w, tokens)
    got = Reference(cfg, w).logits([tokens], [list(range(len(tokens)))])[0]
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-5 * scale


def test_gaps_of_the_reference_own_argmax_are_zero_and_control_reads_more():
    cfg = tiny_files()["cfg"]
    w = synth(cfg, "cpu", 17)
    g = torch.Generator().manual_seed(2)
    prompt = [1] + torch.randint(3, cfg["vocab_size"], (40,), generator=g).tolist()
    seq = list(prompt)
    ref = Reference(cfg, w)
    for _ in range(24):                      # the reference's own greedy stream
        seq.append(int(ref.logits([seq], [[len(seq) - 1]])[0][0].argmax()))
    sample = [(prompt, seq[len(prompt):])]
    assert max(served_gaps(cfg, w, sample)[0]) == 0.0
    assert max(control_gaps(cfg, w, sample)[0]) > 0.0
