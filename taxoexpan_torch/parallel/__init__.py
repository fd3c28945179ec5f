"""Parallelism of the port: the process group and its collectives
(`distributed`), the dp x mp process layout (`mesh`), the row-partitioned
feature table (`partition`) and its ring halo exchange on K6 (`halo`)."""
from .distributed import is_multiprocess, maybe_initialize, rank_share
from .mesh import DataParallel, Layout, layout

__all__ = ["DataParallel", "Layout", "is_multiprocess", "layout",
           "maybe_initialize", "rank_share"]
