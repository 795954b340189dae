"""Multi-process start-up and the multi-node layout (port of
`yalm_tpu/parallel/distributed.py`).

- `initialize()` wraps `torch.distributed.init_process_group`: with no
  arguments it reads torchrun's environment (RANK, WORLD_SIZE,
  MASTER_ADDR, MASTER_PORT); explicit arguments name a manual cluster. The
  backend follows the device: nccl on CUDA, gloo on the CPU; a caller may
  name it (two gloo ranks sharing one card). Nothing picks a backend by
  trying one and catching its failure.
- `make_hybrid_mesh` lays out ('dp', 'ep', 'tp') so that `tp` groups stay
  inside one node (NVLink) and `dp`/`ep` span nodes; a node is a rank over
  the local world size, where JAX has its process index.
- `local_batch_slice` gives this node's rows of a global batch.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import MeshConfig, make_mesh, mesh_device

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device=None) -> str:
    """nccl for CUDA ranks (the default device), gloo for CPU ranks."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device=None, timeout: float | None = None) -> None:
    """Bring up the process group (once per process, before make_mesh).

    No arguments: torchrun's environment, or, outside torchrun, a world of
    one (so a mesh of one device works in a plain process; set
    YALM_REQUIRE_DISTRIBUTED to make that an error). coordinator_address:
    "host:port" (tcp) or an init_method URL ("file:///path/pg"), with
    num_processes and process_id. num_processes <= 1 is a world of one. An
    explicit cluster that fails to start raises: degrading a real
    multi-process job to one process would hang the other ranks. backend:
    default_backend(device) unless named; an nccl rank is bound to
    cuda:LOCAL_RANK first, so two ranks of one node never share cuda:0.
    timeout: seconds a collective may wait (the backend's default if
    None)."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(mesh_device(device))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    explicit = coordinator_address is not None or num_processes is not None
    if num_processes is not None and num_processes <= 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
        return
    if not explicit:
        if all(k in os.environ for k in _TORCHRUN):
            try:
                dist.init_process_group(backend, init_method="env://", **kw)
            except (ValueError, RuntimeError) as e:
                raise RuntimeError(f"torch.distributed.init_process_group failed: {e}") from e
            return
        if os.environ.get("YALM_REQUIRE_DISTRIBUTED"):
            raise RuntimeError("YALM_REQUIRE_DISTRIBUTED is set but no cluster was given "
                               "(torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT, or "
                               "coordinator_address, num_processes and process_id)")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a manual cluster needs coordinator_address, num_processes and "
                         "process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    try:
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id), **kw)
    except (ValueError, RuntimeError) as e:
        raise RuntimeError(f"torch.distributed.init_process_group failed: {e}") from e


def local_world_size() -> int:
    """Ranks per node (torchrun's LOCAL_WORLD_SIZE; 1 outside torchrun)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def process_index() -> int:
    """This process's node: its rank over the local world size."""
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
    return rank // local_world_size()


def hybrid_order(mcfg: MeshConfig, nodes: list[int], process_is_granule: bool = True):
    """The world's ranks in grid order: sorted by (node, rank), so the
    contiguous ranks of a node become the tp groups; raises where a tp group
    would straddle nodes. nodes[r] is rank r's node. Returns the (dp, ep,
    tp) array of ranks."""
    if mcfg.n_devices != len(nodes):
        raise ValueError(f"mesh {mcfg} wants {mcfg.n_devices} devices, have {len(nodes)}")
    ranks = list(range(len(nodes)))
    if process_is_granule:
        ranks.sort(key=lambda r: (nodes[r], r))
    per_node: dict = {}
    for r in ranks:
        per_node.setdefault(nodes[r], []).append(r)
    n_local = len(next(iter(per_node.values())))
    if len(per_node) > 1:
        # tp groups must tile exactly into nodes (or nodes into groups),
        # else some group straddles the node boundary and every block's sum
        # crosses it
        ok = (mcfg.tp <= n_local and n_local % mcfg.tp == 0) or \
             (mcfg.tp > n_local and mcfg.tp % n_local == 0)
        if not ok:
            raise ValueError(
                f"tp={mcfg.tp} does not pack into nodes with {n_local} local "
                f"devices; tp groups would straddle nodes")
    return np.asarray(ranks).reshape(mcfg.dp, mcfg.ep, mcfg.tp)


def make_hybrid_mesh(mcfg: MeshConfig, *, nodes: list[int] | None = None, device=None,
                     process_is_granule: bool = True):
    """A ('dp', 'ep', 'tp') mesh whose tp groups stay inside a node and
    whose dp/ep axes span nodes (hybrid_order). nodes: each rank's node
    (default: rank // LOCAL_WORLD_SIZE)."""
    if nodes is None:
        n = dist.get_world_size() if dist.is_initialized() else mcfg.n_devices
        nodes = [r // local_world_size() for r in range(n)]
    arr = hybrid_order(mcfg, nodes, process_is_granule)
    return make_mesh(mcfg, device=device, order=arr.reshape(-1).tolist(),
                     nodes={r: nodes[r] for r in range(len(nodes))})


def local_batch_slice(global_batch: int, mesh) -> slice:
    """The [start, stop) rows of the global batch this node owns (for
    feeding per-node request queues under dp sharding)."""
    procs = sorted({mesh.nodes.get(int(r), int(r) // local_world_size())
                    for r in np.asarray(mesh.ranks).flat})
    me = process_index()
    if me not in procs:
        raise RuntimeError("this process owns no devices in the mesh")
    n = len(procs)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} nodes")
    per = global_batch // n
    idx = procs.index(me)
    return slice(idx * per, (idx + 1) * per)
