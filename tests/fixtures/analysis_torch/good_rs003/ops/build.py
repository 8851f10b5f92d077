"""GOOD: every argument of the compile-cached functions is hashable."""
import ctypes
import functools
import subprocess


@functools.lru_cache(maxsize=None)
def build(source, flags: tuple[str, ...] = ("-O3", "-arch=sm_90a")):
    subprocess.run(["nvcc", *flags, source], check=True)
    return source + ".so"


class Loader:
    @functools.cache
    def load(self, paths: tuple[str, ...]):
        return tuple(ctypes.CDLL(p) for p in paths)


def not_cached(flags=["-O3"]):
    return list(flags)
