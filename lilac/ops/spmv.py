"""Functional sparse ops — the framework's uniform `spmv_harness_` ABI.

The reference funnels every workload through one C symbol
(/root/reference/libspmv/native.c:3). Here the uniform surface is
`spmv(A, x)` / `spmv_t(A, x)` over any registered container, plus
`spmm(A, X)` for multi-vector right-hand sides. Workloads either call these
directly or build a `SpmvPlan` (lilac.plan) for kernel selection,
df64 packing, and mesh distribution.
"""

from __future__ import annotations

import jax

from lilac.formats.sparse import BSR, BucketELL, COO, CSR, ELL


def spmv(A, x):
    """y = A @ x, dispatching on container type (single chip, values dtype
    follows the container)."""
    from lilac.kernels import xla

    if isinstance(A, CSR):
        return xla.csr_spmv(A, x)
    if isinstance(A, ELL):
        return xla.ell_spmv(A, x)
    if isinstance(A, COO):
        return xla.coo_spmv(A, x)
    if isinstance(A, BSR):
        return xla.bsr_spmv(A, x)
    if isinstance(A, BucketELL):
        return xla.bucket_ell_spmv(A, x)
    raise TypeError(f"unsupported container {type(A)}")


def spmv_t(A, x):
    """y = A.T @ x (true transpose product)."""
    from lilac.kernels import xla

    if isinstance(A, CSR):
        return xla.csr_spmv_t(A, x)
    if isinstance(A, ELL):
        return xla.ell_spmv_t(A, x)
    if isinstance(A, COO):
        return xla.coo_spmv_t(A, x)
    raise TypeError(f"unsupported container {type(A)}")


def spmm(A, X):
    """Y = A @ X for a dense [n, k] block of right-hand sides (vmapped)."""
    return jax.vmap(lambda col: spmv(A, col), in_axes=1, out_axes=1)(X)
