from .trainer import SpmdTrainer

__all__ = ["SpmdTrainer"]
