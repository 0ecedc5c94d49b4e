"""Box geometry, codecs and coordinate transforms of the port."""
from . import boxes, coders, transforms

__all__ = ['boxes', 'coders', 'transforms']
