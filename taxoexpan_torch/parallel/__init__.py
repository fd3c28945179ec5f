"""Data parallelism of the port: the process group and its collectives
(`distributed`), the data-parallel group (`mesh`), the row-partitioned
feature table (`partition`) and its ring halo exchange on K6 (`halo`)."""
from .distributed import is_multiprocess, maybe_initialize, rank_share
from .mesh import DataParallel, data_parallel

__all__ = ["DataParallel", "data_parallel", "is_multiprocess",
           "maybe_initialize", "rank_share"]
