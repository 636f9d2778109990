"""Kernel registry — the analogue of the reference's libspmv backend zoo.

The reference selects an SpMV implementation by linking a different shared
library behind one ABI (reference libspmv/Makefile:37-39) plus a
runtime SVM gate (reference libspmv/mkl-model.c:152). Here kernels are
Python callables registered by name; lilac.plan.SpmvPlan picks one per
matrix (heuristically or via the autotune predictor) and jit caches the
compiled executable — the analogue of the reference's marshalling caches.
"""

from lilac.kernels.registry import KERNELS, register_kernel, get_kernel  # noqa: F401
from lilac.kernels import xla  # noqa: F401  (registers xla_* kernels)
