from .io import load

__all__ = ["load"]
