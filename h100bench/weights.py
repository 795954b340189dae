"""Random weights of a configuration, made on the card from the seed in the
type they are served in (after `chip_smoke.py:synth_fast_weights`): layer
matrices N(0, 0.02) rounded to fp8-e5m2, in a few large chunks with no
full-size bf16 temporary; norm weights 1 + 0.1 N(0, 1) in float32, so a
path that drops a norm weight shows. Stacks follow the configuration:
wqkv (L, q + 2 kv, dim) = [Wq; Wk; Wv], wo (L, dim, q), w13 (L, [E,] 2
hidden, dim) = [W1; W3], w2 (L, [E,] dim, hidden), the router moegate (L, E,
dim). The program and the reference both read these tensors; neither
derives them from the other."""

from __future__ import annotations

import torch

CHUNK_ELEMENTS = 1 << 27   # bf16 temporaries of at most 256 MiB
STD = 0.02


def synth(cfg: dict, device, seed: int) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    fp8 = torch.float8_e5m2

    def mat(*shape):
        out = torch.empty(shape, dtype=fp8, device=device)
        flat = out.view(-1, shape[-1])
        step = max(1, CHUNK_ELEMENTS // shape[-1])
        for i in range(0, flat.shape[0], step):
            rows = flat[i:i + step]
            rows.copy_((torch.randn(rows.shape, generator=gen, device=device,
                                    dtype=torch.bfloat16) * STD).to(fp8))
        return out

    def norm(*shape):
        return 1 + 0.1 * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    L, d, h = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    hq, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // hq
    E = (cfg["num_local_experts"],) if cfg.get("num_local_experts") else ()
    w = dict(embed=mat(cfg["vocab_size"], d), lm_head=mat(cfg["vocab_size"], d),
             wqkv=mat(L, (hq + 2 * hk) * hd, d), wo=mat(L, d, hq * hd),
             w13=mat(L, *E, 2 * h, d), w2=mat(L, *E, d, h),
             moegate=mat(L, *E, d) if E else None)
    w.update(rms_att=norm(L, d), rms_ffn=norm(L, d), final_norm=norm(d))
    return w


def nbytes(w: dict) -> int:
    return sum(t.numel() * t.element_size() for t in w.values() if t is not None)
