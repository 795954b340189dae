"""Meshes over torch.distributed (port of `yalm_tpu/parallel`): tensor,
expert and data parallelism on the kernels (mesh, sharding, distributed and
fast_tp's decode, prefill and tick, the paged pool's tick and prefill and
the speculative verify sweeps), the sequence-parallel ring prefill
(ring.py), the pipeline-parallel tick (pipeline.py) and the sharded parity
oracle (oracle.py, JAX's GSPMD path)."""

from .mesh import MeshConfig, make_mesh
from .sharding import cache_splits, fast_weight_splits, weight_splits

__all__ = ["MeshConfig", "make_mesh", "weight_splits", "cache_splits", "fast_weight_splits"]
