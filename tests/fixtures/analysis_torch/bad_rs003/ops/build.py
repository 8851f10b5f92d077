"""BAD: an unhashable default on an argument of a compile-cached build
(RS003)."""
import functools
import subprocess


@functools.lru_cache(maxsize=None)
def build(source, flags=["-O3", "-arch=sm_90a"]):
    subprocess.run(["nvcc", *flags, source], check=True)
    return source + ".so"
