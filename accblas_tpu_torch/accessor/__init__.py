from .dtypes import canon, check_arithmetic, is_df, promote, torch_dtype
from .range import Range, ReducedRowMajor, make_range

__all__ = ["canon", "check_arithmetic", "is_df", "promote", "torch_dtype", "Range",
           "ReducedRowMajor", "make_range"]
