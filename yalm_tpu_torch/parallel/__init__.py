"""Meshes over torch.distributed: tensor, expert and data parallelism on
the kernels (port of `yalm_tpu/parallel`: mesh, sharding, distributed and
fast_tp's decode, prefill and tick; the paged pool and speculation on a
mesh, ring.py and pipeline.py are a later slice, ROADMAP.md item 13)."""

from .mesh import MeshConfig, make_mesh
from .sharding import cache_splits, fast_weight_splits, weight_splits

__all__ = ["MeshConfig", "make_mesh", "weight_splits", "cache_splits", "fast_weight_splits"]
