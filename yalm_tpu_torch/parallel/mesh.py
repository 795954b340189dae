"""Device mesh over a torch.distributed world (port of
`yalm_tpu/parallel/mesh.py`).

One process drives one device. The world's ranks form a ('dp', 'ep', 'tp')
grid in JAX's reshape order, `tp` fastest:

  dp : data parallelism (the scheduler's request lanes)
  ep : expert parallelism (an MoE model's experts)
  tp : tensor parallelism (attention heads, the FFN hidden width, the vocab)

so rank r sits at tp = r % tp, ep = (r // tp) % ep, dp = r // (ep * tp).
Each axis the step bodies reduce over has a process group of the ranks that
share the other coordinates: `tp`, `ep`, `ep_tp` (an MoE FFN's sum over
experts and hidden slices) and `dp`. Where JAX lets NamedSharding insert
the collectives, the port calls them itself (parallel/fast_tp.py).
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


AXES = ("dp", "ep", "tp")
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


class Mesh:
    """This rank's view of the ('dp', 'ep', 'tp') grid: `shape` and `coords`
    are dicts keyed by axis name (as JAX's mesh.shape), `ranks` the grid of
    world ranks, `device` the rank's device and `groups` one process group
    per entry of GROUPS (None where the group is this rank alone: its
    collectives are the identity and are skipped)."""

    def __init__(self, mcfg: MeshConfig, ranks: np.ndarray, rank: int, device: torch.device,
                 backend: str, groups: dict, nodes: dict | None = None):
        self.config = mcfg
        self.shape = {"dp": mcfg.dp, "ep": mcfg.ep, "tp": mcfg.tp}
        self.ranks = ranks
        self.rank = rank
        d, e, t = (int(i[0]) for i in np.nonzero(ranks == rank))
        self.coords = {"dp": d, "ep": e, "tp": t}
        # the rank's place in grid order (load_fast_weights' `rank`)
        self.position = (d * mcfg.ep + e) * mcfg.tp + t
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
        return (f"Mesh(dp={self.shape['dp']}, ep={self.shape['ep']}, tp={self.shape['tp']}, "
                f"rank={self.rank}, coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(mcfg: MeshConfig | None = None, *, device=None, order=None,
              nodes: dict | None = None) -> Mesh:
    """Build this rank's ('dp', 'ep', 'tp') mesh over the initialized
    torch.distributed world (parallel/distributed.initialize).

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
    if mcfg.n_devices != world:
        raise ValueError(f"mesh {mcfg} wants {mcfg.n_devices} devices, have {world}")
    dev = mesh_device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs CUDA tensors; this rank's device is {dev}")
    order = list(range(world)) if order is None else [int(r) for r in order]
    if sorted(order) != list(range(world)):
        raise ValueError(f"order {order} is not a permutation of the world's {world} ranks")
    ranks = np.asarray(order).reshape(mcfg.dp, mcfg.ep, mcfg.tp)
    rank = dist.get_rank()
    groups: dict = {"world": None if world == 1 else dist.group.WORLD}
    for name, axes in GROUPS.items():
        keep = [i for i, a in enumerate(AXES) if a not in axes]
        size = int(np.prod([ranks.shape[AXES.index(a)] for a in axes]))
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


def grid_mesh(mcfg: MeshConfig, position: int, device="cpu") -> Mesh:
    """Rank `position` of a (dp, ep, tp) grid without process groups: what
    cutting one rank's shard in a single process reads (its collectives
    must not be called)."""
    ranks = np.arange(mcfg.n_devices).reshape(mcfg.dp, mcfg.ep, mcfg.tp)
    return Mesh(mcfg, ranks, position, torch.device(device), "none",
                {k: None for k in (*GROUPS, "world")})


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
