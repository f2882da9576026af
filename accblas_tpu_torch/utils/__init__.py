from .compare import compare, norm1, relative_error, tree_reduce
from .matrix import MatrixInfo, format_mtx, gen_mtx, write_random
from . import devgen, interop, prng

__all__ = [
    "MatrixInfo",
    "gen_mtx",
    "write_random",
    "format_mtx",
    "tree_reduce",
    "compare",
    "norm1",
    "relative_error",
    "devgen",
    "interop",
    "prng",
]
