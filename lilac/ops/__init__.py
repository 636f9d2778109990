from lilac.ops import dfloat  # noqa: F401
from lilac.ops.spmv import spmv  # noqa: F401
