from . import processing

__all__ = ["processing"]
