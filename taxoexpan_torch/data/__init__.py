from .egobatch import EgoBatch, GroupBatch
from .sampler import MaskedGraphSampler
from .taxonomy import Taxon, Taxonomy

__all__ = ["Taxon", "Taxonomy", "EgoBatch", "GroupBatch",
           "MaskedGraphSampler"]
