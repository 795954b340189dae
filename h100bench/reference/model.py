"""Plain PyTorch reference of the Mistral family's forward pass: Mistral-7B
and Mixtral-8x7B (top-k routed experts), as the published configurations
and the original Mistral reference code describe it. It imports neither
`jax` nor any package of this repository: it reads the configuration file
(`h100bench/configs/<config>.json`) and the raw weights the benchmark made
from the seed (`h100bench/weights.py`), and works out the rest itself.

- float32 throughout, TF32 off; fp8-e5m2 weights are widened exactly;
- RMSNorm with eps inside the root, times the norm weight;
- RoPE on interleaved pairs (2p, 2p+1) with inverse frequencies
  theta^(-2p / head_dim), angles in float64;
- grouped-query attention: query head h reads kv head h // (n_heads /
  n_kv_heads), softmax over the causal positions, scaled by head_dim^-0.5;
- SwiGLU FFN silu(x W1^T) * (x W3^T) W2^T; W1 and W3 are the two halves of
  the stacked (2 * hidden, dim) matrix the benchmark makes;
- MoE: router logits x Wg^T, the top-k experts of each token weighted by a
  softmax over their k logits, each expert run on the tokens routed to it;
  given the program's routing it uses the program's experts, weighted by
  its own float32 logits, and measures how far they lie from its own.

Weights are widened one layer (and one expert) at a time and the sequences
run through the stack layer by layer, so the reference fits beside nothing
else on the card. `act` rounds every matmul input and q, k, v: None keeps
float32; `control.fp8` gives the lower-precision control.
"""

from __future__ import annotations

import contextlib
import math

import torch

FFN_ROWS = 4096      # rows of the FFN per block
ATTN_ROWS = 1024     # query rows per attention block


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 while active."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) rotated at positions pos (T,), interleaved pairs."""
    D = x.shape[-1]
    j = torch.arange(0, D, 2, dtype=torch.float64, device=x.device)
    ang = pos.to(torch.float64)[:, None] * torch.exp(-math.log(theta) * j / D)[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape)


def causal_attention(q, k, v, act) -> torch.Tensor:
    """q (T, Hq, D), k and v (T, Hk, D) of one sequence; (T, Hq * D)."""
    T, Hq, D = q.shape
    Hk = k.shape[1]
    g = Hq // Hk
    qg = q.reshape(T, Hk, g, D)
    out = torch.empty((T, Hk, g, D), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for r0 in range(0, T, ATTN_ROWS):
        r1 = min(T, r0 + ATTN_ROWS)
        s = torch.einsum("tkgd,skd->kgts", qg[r0:r1], k[:r1]) * scale
        mask = torch.arange(r1, device=q.device)[None, :] <= torch.arange(r0, r1,
                                                                        device=q.device)[:, None]
        s = s.masked_fill(~mask, -math.inf)
        p = torch.softmax(s, dim=-1)
        out[r0:r1] = torch.einsum("kgts,skd->tkgd", p, v[:r1])
    return act(out.reshape(T, Hq * D))


class Reference:
    """The reference over `weights` (the benchmark's raw tensors: embed,
    lm_head, wqkv, wo, w13, w2, moegate, rms_att, rms_ffn, final_norm)."""

    def __init__(self, cfg: dict, weights: dict, act=None):
        self.cfg = cfg
        self.w = weights
        self.act = act or (lambda t: t)
        self.dim = cfg["hidden_size"]
        self.hidden = cfg["intermediate_size"]
        self.n_heads = cfg["num_attention_heads"]
        self.n_kv = cfg["num_key_value_heads"]
        self.head_dim = self.dim // self.n_heads
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.experts = int(cfg.get("num_local_experts", 0))
        self.top_k = int(cfg.get("num_experts_per_tok", 0))

    def logits(self, seqs: list[list[int]], rows: list[list[int]],
               routes: list | None = None) -> list[torch.Tensor]:
        """For each sequence of token ids, the (len(rows[i]), vocab) float32
        logits predicting the token after each position in rows[i].

        routes (MoE): for each sequence a (len, n_layers, k) tensor of the
        experts to use at each position and layer, -1 where the reference
        routes by itself. Afterwards `route_margin_max` holds how far, at
        most, a given expert's router logit lay below the reference's own
        k-th best, `route_differ` of `route_rows` (row, layer) pairs were
        given other experts than its own top k, and `chosen` holds the
        experts used, in the same form as routes."""
        with exact_f32(), torch.no_grad():
            return self._logits(seqs, rows, routes)

    def _logits(self, seqs, rows, routes):
        w, act = self.w, self.act
        dev = w["wqkv"].device
        lens = [len(s) for s in seqs]
        starts = [sum(lens[:i]) for i in range(len(lens))]
        self.route_margin_max = 0.0
        self.route_rows = self.route_differ = 0
        self._given = torch.cat(routes).to(dev) if routes is not None else None
        self._chosen = []
        ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=dev)
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        x = w["embed"][ids].float()
        qd, kd = self.n_heads * self.head_dim, self.n_kv * self.head_dim
        for layer in range(self.cfg["num_hidden_layers"]):
            wqkv = w["wqkv"][layer].float()
            qkv = act(rmsnorm(x, w["rms_att"][layer], self.eps)) @ wqkv.T
            del wqkv
            q = act(rope(qkv[:, :qd].reshape(-1, self.n_heads, self.head_dim), pos, self.theta))
            k = act(rope(qkv[:, qd:qd + kd].reshape(-1, self.n_kv, self.head_dim), pos,
                         self.theta))
            v = act(qkv[:, qd + kd:].reshape(-1, self.n_kv, self.head_dim))
            del qkv
            mixed = torch.cat([causal_attention(q[a:a + n], k[a:a + n], v[a:a + n], act)
                               for a, n in zip(starts, lens)])
            del q, k, v
            x = x + mixed @ w["wo"][layer].float().T
            del mixed
            xb = act(rmsnorm(x, w["rms_ffn"][layer], self.eps))
            x = x + (self._moe(xb, layer) if self.experts else self._ffn(xb, w["w13"][layer],
                                                                          w["w2"][layer]))
        picks = torch.tensor([a + r for a, rs in zip(starts, rows) for r in rs],
                             dtype=torch.long, device=dev)
        xn = act(rmsnorm(x[picks], w["final_norm"], self.eps))
        out = xn @ w["lm_head"].float().T
        if self._chosen:
            self.chosen = list(torch.split(torch.stack(self._chosen, dim=1).cpu(), lens))
        return list(torch.split(out, [len(r) for r in rows]))

    def _ffn(self, xb, w13, w2) -> torch.Tensor:
        """SwiGLU over xb's rows, in blocks of FFN_ROWS."""
        w13, w2 = w13.float(), w2.float()
        H = self.hidden
        out = torch.empty_like(xb)
        for r0 in range(0, xb.shape[0], FFN_ROWS):
            h13 = xb[r0:r0 + FFN_ROWS] @ w13.T
            h = self.act(torch.nn.functional.silu(h13[:, :H]) * h13[:, H:])
            out[r0:r0 + FFN_ROWS] = h @ w2.T
        return out

    def _moe(self, xb, layer: int) -> torch.Tensor:
        """The routed experts' sum for every row of xb."""
        w = self.w
        logits = xb @ w["moegate"][layer].float().T                  # (N, E)
        top, idx = torch.topk(logits, self.top_k, dim=-1)
        if self._given is not None:
            given = self._given[:, layer]
            have = given[:, 0] >= 0
            if have.any():
                picked = logits.gather(1, given.clamp(min=0)).min(dim=-1).values
                margin = torch.where(have, top[:, -1] - picked, torch.zeros_like(picked))
                self.route_margin_max = max(self.route_margin_max, float(margin.max()))
                same = (torch.sort(given, dim=-1).values == torch.sort(idx, dim=-1).values).all(-1)
                self.route_rows += int(have.sum())
                self.route_differ += int((have & ~same).sum())
            idx = torch.where(have[:, None], given, idx)
        self._chosen.append(idx)
        gates = torch.softmax(logits.gather(1, idx), dim=-1)
        out = torch.zeros_like(xb)
        for e in range(self.experts):
            hit = idx == e
            rows = torch.nonzero(hit.any(dim=-1)).reshape(-1)
            if rows.numel() == 0:
                continue
            gate = (gates * hit).sum(dim=-1)[rows]
            out[rows] += gate[:, None] * self._ffn(xb[rows], w["w13"][layer, e], w["w2"][layer, e])
        return out

    @property
    def route_readings(self) -> dict:
        """The routing numbers of the last call (MoE, given routes)."""
        return {"route_margin_max": self.route_margin_max,
                "route_differ_share": self.route_differ / max(1, self.route_rows)}
