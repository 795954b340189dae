"""Device mesh over a torch.distributed world (port of
`yalm_tpu/parallel/mesh.py`).

One process drives one device. By default the world's ranks form a
('dp', 'ep', 'tp') grid in JAX's reshape order, `tp` fastest:

  dp : data parallelism (the scheduler's request lanes)
  ep : expert parallelism (an MoE model's experts)
  tp : tensor parallelism (attention heads, the FFN hidden width, the vocab)

so rank r sits at tp = r % tp, ep = (r // tp) % ep, dp = r // (ep * tp).
Each axis the step bodies reduce over has a process group of the ranks that
share the other coordinates: `tp`, `ep`, `ep_tp` (an MoE FFN's sum over
experts and hidden slices) and `dp`. Where JAX lets NamedSharding insert
the collectives, the port calls them itself (parallel/fast_tp.py).

A mesh may also name its own axes in grid order, as jax.make_mesh does:
{"sp": 2, "tp": 2} for the ring prefill (parallel/ring.py), {"pp": 4} for
the pipelined tick (parallel/pipeline.py); each named axis has its group.
`Mesh.shift` is JAX's ppermute to the next rank along an axis.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.ep * self.tp


# the process groups a mesh holds: axis name -> the grid axes it spans
GROUPS = {"tp": ("tp",), "ep": ("ep",), "ep_tp": ("ep", "tp"), "dp": ("dp",)}


def local_rank() -> int:
    """This process's index on its node (torchrun's LOCAL_RANK; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def mesh_device(device=None) -> torch.device:
    """The device of this rank: cuda:LOCAL_RANK by default (raising without
    a GPU, never falling back to the CPU), or the caller's."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on device 'cuda' was requested but no CUDA GPU is "
                               "available (pass device='cpu' to run the plain versions)")
        return torch.device("cuda", local_rank())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA GPU is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:   # as the tensors made on it say
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def grid_axes(mcfg) -> tuple[dict, dict]:
    """(axis name -> size in grid order, group name -> the axes it spans) of
    a MeshConfig (the ('dp', 'ep', 'tp') grid and GROUPS) or of a dict of
    named axes (one group per axis)."""
    if isinstance(mcfg, MeshConfig):
        return {"dp": mcfg.dp, "ep": mcfg.ep, "tp": mcfg.tp}, GROUPS
    shape = {str(a): int(n) for a, n in dict(mcfg).items()}
    if not shape or min(shape.values()) < 1:
        raise ValueError(f"mesh axes {shape}: at least one axis, every size >= 1")
    return shape, {a: (a,) for a in shape}


class Mesh:
    """This rank's view of the grid: `shape` and `coords` are dicts keyed by
    axis name in grid order (as JAX's mesh.shape), `ranks` the grid of world
    ranks, `device` the rank's device and `groups` one process group per
    group name (None where the group is this rank alone: its collectives
    are the identity and are skipped). `config` is the MeshConfig of a
    ('dp', 'ep', 'tp') mesh, None for named axes."""

    def __init__(self, mcfg, ranks: np.ndarray, rank: int, device: torch.device,
                 backend: str, groups: dict, nodes: dict | None = None):
        self.config = mcfg if isinstance(mcfg, MeshConfig) else None
        self.shape = grid_axes(mcfg)[0]
        self.axes = tuple(self.shape)
        self.ranks = ranks
        self.rank = rank
        at = tuple(int(i[0]) for i in np.nonzero(ranks == rank))
        self.coords = dict(zip(self.axes, at))
        # the rank's place in grid order (load_fast_weights' `rank`)
        self.position = int(np.ravel_multi_index(at, ranks.shape))
        # each axis' (previous, next) world rank: shift's peers
        self.peers = {}
        for i, a in enumerate(self.axes):
            prev, nxt = list(at), list(at)
            prev[i], nxt[i] = (at[i] - 1) % self.shape[a], (at[i] + 1) % self.shape[a]
            self.peers[a] = (int(ranks[tuple(prev)]), int(ranks[tuple(nxt)]))
        self.device = device
        self.backend = backend
        self.groups = groups
        self.nodes = nodes or {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def leader(self) -> bool:
        """The rank that owns the host side (the CLI's output, the scheduler)."""
        return self.rank == int(self.ranks.flat[0])

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum t over the ranks of `axis`'s group, in place; returns t."""
        g = self.groups[axis]
        if g is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """JAX's ppermute over `axis` with perm [(i, (i + 1) % n)]: this
        rank's t goes to the next rank along the axis (the last to the
        first) and the previous rank's block, of t's shape and type, comes
        back, bit for bit (it travels as its bytes: NCCL sends no int16). nccl,
        and gloo on CPU tensors, send and receive in one batch; gloo sends
        only CPU tensors, so a CUDA block on gloo (two ranks sharing a card)
        goes through a host copy. Every rank of the axis calls it."""
        if self.shape[axis] == 1:
            return t
        prev, nxt = self.peers[axis]
        g = self.groups[axis]
        src = t.contiguous().view(torch.uint8)
        via_host = self.backend == "gloo" and src.device.type != "cpu"
        if via_host:
            src = src.cpu()
        out = torch.empty_like(src)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, nxt, g),
                                         dist.P2POp(dist.irecv, out, prev, g)]):
            w.wait()
        if via_host:
            out = out.to(t.device)
        return out.view(t.dtype)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks t of every rank along `axis`, concatenated along `dim`
        in coordinate order, on every rank of the axis: n - 1 shifts, so
        each block arrives bit for bit."""
        n, c = self.shape[axis], self.coords[axis]
        blocks = [None] * n
        blocks[c] = cur = t
        for s in range(1, n):
            cur = self.shift(cur, axis)
            blocks[(c - s) % n] = cur
        return torch.cat(blocks, dim=dim)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The leader's t on every rank of the mesh, in place; returns t."""
        if self.size > 1:
            dist.broadcast(t, src=int(self.ranks.flat[0]), group=self.groups["world"])
        return t

    def broadcast_int(self, v: int) -> int:
        """The leader's integer v on every rank (e.g. a sampling seed)."""
        t = torch.tensor([int(v)], dtype=torch.int64, device=self.device)
        return int(self.broadcast(t)[0])

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({axes}, rank={self.rank}, coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(mcfg: MeshConfig | dict | None = None, *, device=None, order=None,
              nodes: dict | None = None) -> Mesh:
    """Build this rank's mesh over the initialized torch.distributed world
    (parallel/distributed.initialize): a ('dp', 'ep', 'tp') MeshConfig, or
    a dict of axis names and sizes in grid order ({"sp": 2, "tp": 2}; one
    process group per axis).

    With no MeshConfig every rank goes to `tp`. `order` lists the world's
    ranks in grid order (default 0..n-1; make_hybrid_mesh passes its node
    sort). device: None runs on cuda:LOCAL_RANK (raising without a GPU);
    "cpu" runs the plain versions; an explicit "cuda:i" is taken as given
    (two ranks sharing one card). Every rank must call this with the same
    arguments: each creates every group, as torch.distributed requires."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world "
                           "(yalm_tpu_torch.parallel.distributed.initialize)")
    world = dist.get_world_size()
    if mcfg is None:
        mcfg = MeshConfig(tp=world)
    shape, spans = grid_axes(mcfg)
    axes = tuple(shape)
    if int(np.prod(list(shape.values()))) != world:
        raise ValueError(f"mesh {mcfg} wants {int(np.prod(list(shape.values())))} devices, "
                         f"have {world}")
    dev = mesh_device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs CUDA tensors; this rank's device is {dev}")
    order = list(range(world)) if order is None else [int(r) for r in order]
    if sorted(order) != list(range(world)):
        raise ValueError(f"order {order} is not a permutation of the world's {world} ranks")
    ranks = np.asarray(order).reshape(tuple(shape.values()))
    rank = dist.get_rank()
    groups: dict = {"world": None if world == 1 else dist.group.WORLD}
    for name, over in spans.items():
        keep = [i for i, a in enumerate(axes) if a not in over]
        size = int(np.prod([shape[a] for a in over]))
        # the other axes first: each row is one group, in grid order
        members = np.moveaxis(ranks, keep, list(range(len(keep)))).reshape(-1, size)
        mine = None
        for row in members:
            row = [int(r) for r in row]
            # every rank creates every group, in the same order
            g = dist.new_group(row) if len(row) > 1 else None
            if rank in row:
                mine = g
        groups[name] = mine
    return Mesh(mcfg, ranks, rank, dev, backend, groups, nodes)


def grid_mesh(mcfg: MeshConfig | dict, position: int, device="cpu") -> Mesh:
    """Rank `position` of a grid (a MeshConfig or named axes) without
    process groups: what cutting one rank's shard in a single process reads
    (its collectives must not be called)."""
    shape, spans = grid_axes(mcfg)
    ranks = np.arange(int(np.prod(list(shape.values())))).reshape(tuple(shape.values()))
    return Mesh(mcfg, ranks, position, torch.device(device), "none",
                {k: None for k in (*spans, "world")})


def validate_divisibility(cfg, mcfg: MeshConfig) -> None:
    """Fail fast on shardings that cannot divide the model dims."""
    if cfg.n_kv_heads % mcfg.tp and mcfg.tp % cfg.n_kv_heads:
        raise ValueError(f"tp={mcfg.tp} incompatible with n_kv_heads={cfg.n_kv_heads}")
    if cfg.hidden_dim % mcfg.tp:
        raise ValueError(f"tp={mcfg.tp} must divide hidden_dim={cfg.hidden_dim}")
    if cfg.is_moe and cfg.n_experts % mcfg.ep:
        raise ValueError(f"ep={mcfg.ep} must divide n_experts={cfg.n_experts}")
    if not cfg.is_moe and mcfg.ep != 1:
        raise ValueError("ep > 1 requires an MoE model")
