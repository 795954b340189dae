"""Operations and bytes behind every roofline share and `mfu`, and the
table of peaks. Counts follow the shapes of each call: every input byte
read once, every output byte written once, 2 operations per multiply-add.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit: 989 TFLOP/s in bf16 on the tensor cores (the port's
GEMMs widen fp8-e5m2 weights to bf16 and run bf16 wgmma), 3.35 TB/s of HBM3.
A run reports the card's power limit beside every share.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor rate."""
    return max(n_bytes / PEAK_HBM_BYTES, n_flops / PEAK_BF16_FLOPS)


def gemm_counts(M: int, N: int, K: int, w_itemsize: int, glu: bool = False,
                residual: bool = False) -> tuple[int, int]:
    """(bytes, operations) of one `gemm_kernel` call: the (N, K) weight
    matrix, X (M, K) as the bf16 rows the kernel reads, Y (M, N) in f32 (the
    GLU pair's (M, N / 2)), and an f32 residual (M, N) where one is added."""
    n_out = N // 2 if glu else N
    n_bytes = N * K * w_itemsize + M * K * 2 + M * n_out * 4 + (M * N * 4 if residual else 0)
    return n_bytes, 2 * M * N * K


def attn_counts(kv_lens, n_heads: int, n_kv_heads: int, head_dim: int,
                kv_itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of one call of the tick's attention (K8: the
    lanes split, `lanes_scores_kernel` + `lanes_values_kernel`) over lanes
    whose cache lengths are `kv_lens`: each lane's K and V rows once, its q,
    new k/v and output rows in f32; q.k and p.v over every cached slot."""
    slots = sum(kv_lens)
    n_bytes = (2 * slots * n_kv_heads * head_dim * kv_itemsize
               + len(kv_lens) * (2 * n_heads + 2 * n_kv_heads) * head_dim * 4)
    return n_bytes, 4 * slots * n_heads * head_dim


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by: per layer wqkv, wo and the FFN of the
    experts it is routed to (all of a dense model's), and the router; the
    LM head once. The embedding is a gather, not a product."""
    d, h = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // hq
    attn = d * (hq + 2 * hk) * hd + hq * hd * d
    experts = cfg.get("num_local_experts", 0)
    ffn = 3 * d * h * (cfg["num_experts_per_tok"] if experts else 1)
    router = experts * d
    return cfg["num_hidden_layers"] * (attn + ffn + router) + cfg["vocab_size"] * d


def token_flops(cfg: dict, context: int) -> float:
    """Model operations of one token whose attention reads `context` cached
    positions (itself included): 2 per weight it multiplies by, plus q.k and
    p.v over the context in every layer. Routed experts only: an MoE token
    counts the experts its router picks, not the masked sweep's eight."""
    hq = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // hq
    attn = 4 * context * hq * hd * cfg["num_hidden_layers"]
    return 2.0 * matmul_params_per_token(cfg) + attn


def prompt_flops(cfg: dict, n: int) -> float:
    """Model operations of a prompt of n tokens (token i reads i + 1)."""
    hq = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // hq
    return (2.0 * matmul_params_per_token(cfg) * n
            + 4.0 * hq * hd * cfg["num_hidden_layers"] * n * (n + 1) / 2)
