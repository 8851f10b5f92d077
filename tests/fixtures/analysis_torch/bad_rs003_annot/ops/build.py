"""BAD: an argument of a compile-cached load annotated as a list
(RS003)."""
import ctypes
import functools


@functools.cache
def load(paths: list[str]):
    return [ctypes.CDLL(p) for p in paths]
