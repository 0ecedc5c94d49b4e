"""Framework-free helpers of the port (its own copies: the port imports
nothing of the JAX package)."""
from .config import Config, ConfigDict, DictAction

__all__ = ['Config', 'ConfigDict', 'DictAction']
