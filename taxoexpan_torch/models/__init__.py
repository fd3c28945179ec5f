from .taxoexpan import TaxoExpan

__all__ = ["TaxoExpan"]
