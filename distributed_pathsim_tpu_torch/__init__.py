"""distributed_pathsim_tpu_torch — meta-path similarity on a CUDA card.

The PyTorch port of ``distributed_pathsim_tpu`` (the JAX package, kept
beside it as the reference): typed-HIN data model, metapath compiler,
sparsity-aware chain planner, a host f64 oracle backend, dense and
streaming torch backends whose hot path runs on hand-written CUDA
kernels for Hopper (``csrc/``), native C++ host code for the loader and
the fold (``native/``), tuning dispatch, the multi-metapath ensemble,
the serving tier and the router fleet. It imports neither JAX nor the
JAX package.
"""

__version__ = "0.1.0"

from .config import RunConfig  # noqa: F401
from .data.schema import HINGraph, HINSchema  # noqa: F401
from .data.encode import EncodedHIN, encode_hin  # noqa: F401
from .data.gexf import read_gexf  # noqa: F401
from .ops.metapath import MetaPath, compile_metapath  # noqa: F401
from .backends.base import available_backends, create_backend  # noqa: F401
from .driver import PathSimDriver  # noqa: F401
from .engine import build, load_dataset  # noqa: F401
