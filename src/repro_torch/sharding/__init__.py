"""Placement of expert-stacked state over the 1-D ``expert`` mesh."""
from .context import leading_sharding

__all__ = ["leading_sharding"]
