from .dto import Hit, HitBatch

__all__ = ["Hit", "HitBatch"]
