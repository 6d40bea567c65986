from .api import BaseModel, build_model
from .common import ArchConfig

__all__ = ["BaseModel", "build_model", "ArchConfig"]
