"""SpmvPlan — staged, immutable matrix execution plans.

The reference's native backends cache device mirrors of the matrix and
invalidate them with mprotect/SIGSEGV traps when the host mutates the data
(reference libspmv/gpu.c:140-209, mkl.c:15-26); SparseX additionally
runs a one-time tuning pass (reference libspmv/sparsex.c:68-70). The
counterpart here is this plan object: built once from host CSR, it
(1) chooses a kernel + device format (the libspmv backend zoo + SVM gate,
mkl-model.c:152), (2) packs/pads/uploads device buffers, and (3) exposes
jit-compatible matvec closures. Matrices are immutable by construction —
mutate the host data, build a new plan (explicit re-tune instead of traps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from lilac.formats import convert
from lilac.formats.sparse import CSR, ELL
from lilac.kernels import xla as _xla  # noqa: F401  (registers kernels)
from lilac.ops import dfloat as df


def require_x64(dtype: str) -> None:
    """A plan asked for f64 must store f64: with jax_enable_x64 off, JAX
    would silently store float32 and the run could not verify."""
    if dtype == "f64" and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype='f64' needs 64-bit JAX: call "
            "jax.config.update('jax_enable_x64', True) before any array "
            "is created"
        )


class SpmvPlan:
    """Single-device plan. For distributed plans see lilac.parallel.

    Parameters
    ----------
    indptr, indices, data : host CSR (0-based canonical), data float64/float32
    shape : (nrows, ncols)
    dtype : 'f32' | 'f64' | 'bf16' | 'df64' value policy on device
    kernel : 'auto' | registry name
    """

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        data: np.ndarray,
        shape: Tuple[int, int],
        *,
        dtype: str = "f32",
        kernel: str = "auto",
    ):
        require_x64(dtype)
        self.shape = tuple(shape)
        self.nnz = int(len(indices))
        self.dtype = dtype
        counts = np.diff(indptr)
        self.row_stats = dict(
            nrows=shape[0],
            nnz=self.nnz,
            max_row=int(counts.max()) if len(counts) else 0,
            mean_row=float(counts.mean()) if len(counts) else 0.0,
            std_row=float(counts.std()) if len(counts) else 0.0,
        )
        if kernel == "auto":
            kernel = self._select_kernel()
        self.kernel = kernel

        if kernel == "xla_ell":
            jt = {"f32": np.float32, "f64": np.float64, "bf16": np.float32}[dtype]
            self.A = convert.ell_device(
                indptr, indices, data, shape, dtype=jt, row_pad=8
            )
        elif kernel == "xla_ell_df":
            hi = data.astype(np.float32)
            lo = (data - hi.astype(np.float64)).astype(np.float32)
            vals = np.stack([hi, lo], axis=-1)  # [nnz, 2]
            v, c = convert.csr_to_ell_arrays(indptr, indices, vals, shape, row_pad=8)
            self.A = ELL(data=jnp.asarray(v), indices=jnp.asarray(c), shape=self.shape)
        elif kernel == "xla_csr":
            jt = {"f32": np.float32, "f64": np.float64, "bf16": np.float32}[dtype]
            self.A = convert.csr_device(indptr, indices, data, shape, dtype=jt)
        elif kernel == "xla_sell":
            jt = {"f32": np.float32, "f64": np.float64, "bf16": np.float32}[dtype]
            self.A = convert.bucket_ell_device(indptr, indices, data, shape, dtype=jt)
        elif kernel == "xla_sell_df":
            hi = data.astype(np.float32)
            lo = (data - hi.astype(np.float64)).astype(np.float32)
            vals = np.stack([hi, lo], axis=-1)
            self.A = convert.bucket_ell_device(indptr, indices, vals, shape)
        else:
            raise ValueError(f"kernel {kernel!r} not wired into SpmvPlan yet")

        if dtype == "bf16":
            # bf16 value policy: store matrix values (and any staged float
            # planes) in bfloat16; accumulation stays in the kernel's
            # compute dtype. One tree-level cast covers every container.
            self.A = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16)
                if jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                self.A,
            )

    def _select_kernel(self) -> str:
        """Kernel/format gate: the trained lilac.autotune model when one
        is installed (≙ the generated mkl-model.c SVC,
        reference libspmv/mkl-model.c:152-165), else a heuristic on
        row-length spread."""
        s = self.row_stats
        spread = s["max_row"] > 1.5 * max(s["mean_row"], 1.0) + 4
        if self.dtype == "df64":
            return "xla_sell_df" if spread else "xla_ell_df"
        from lilac import autotune

        choice = autotune.predict(s["nrows"], s["nnz"], s["mean_row"], s["std_row"])
        if choice is not None:
            return choice
        # plain ELL pads every row to max_row; bucket-sliced ELL caps the
        # padding when row lengths are spread
        if spread:
            return "xla_sell"
        return "xla_ell"

    # -- value conversion helpers -------------------------------------------

    def vec_in(self, x: np.ndarray):
        """Host f64 vector -> device value in the plan's dtype policy."""
        if self.dtype == "df64":
            return df.from_f64(x)
        jt = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[self.dtype]
        return jnp.asarray(np.asarray(x), dtype=jt)

    def vec_out(self, y) -> np.ndarray:
        if self.dtype == "df64":
            return df.to_f64(y)
        return np.asarray(y, dtype=np.float64)

    # -- matvec closures (jit-compatible; A is a pytree argument) -----------

    def matvec_with(self, A, x):
        """Pure matvec with the container passed explicitly (for jit args)."""
        from lilac.kernels.registry import get_kernel

        return get_kernel(self.kernel).fn(A, x)

    def matvec_t_with(self, A, x):
        """y = A^T x, via the registry's transpose slot. Kernels without a
        scatter-add transpose raise — build the transpose as its own
        forward plan with transposed_plan()."""
        from lilac.kernels.registry import get_kernel

        t = get_kernel(self.kernel).transpose
        if t is None:
            raise ValueError(
                f"kernel {self.kernel!r} has no registered transpose; "
                "use lilac.plan.transposed_plan(...) to stage A^T as "
                "its own forward plan"
            )
        return t(A, x)

    def matvec(self, x):
        return self.matvec_with(self.A, x)

    def matvec_t(self, x):
        return self.matvec_t_with(self.A, x)

    def __call__(self, x):
        return self.matvec(x)


def transposed_plan(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    **kw,
) -> SpmvPlan:
    """Stage A^T as its own forward SpmvPlan (host CSR -> CSC transpose).

    This is the first-class route to the transpose product for kernels
    whose forward accumulation has no scatter form (df64 compensated
    sums): both directions stay on the fast forward path, at
    the cost of a second plan's device memory — the same trade the
    reference's BiCG dodges by silently substituting A for A^T
    (SURVEY.md section 3.5; we keep honest semantics)."""
    from lilac.formats.convert import coo_to_csr_arrays

    rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr))
    t_ip, t_ix, t_v = coo_to_csr_arrays(indices, rows, data, (shape[1], shape[0]))
    return SpmvPlan(t_ip, t_ix, t_v, (shape[1], shape[0]), **kw)


class FactoredNPBPlan:
    """Plan for the factored NPB operator (kernels/factored.py): same
    interface as SpmvPlan, built from the class name instead of CSR."""

    def __init__(self, class_name: str, *, dtype: str = "f64",
                 segmode: str | None = None):
        from lilac.generate.npb import CLASSES
        from lilac.kernels import factored as _f

        require_x64(dtype)
        cls = CLASSES[class_name.upper()]
        self.shape = (cls.na, cls.na)
        self.dtype = dtype
        self.A, self.nnz = _f.build_factored(class_name, dtype=dtype,
                                             segmode=segmode)
        self.kernel = "factored_xla" + ("_df" if dtype == "df64" else "")

    def matvec_with(self, A, x):
        from lilac.kernels import factored as _f

        if self.dtype == "df64":
            return _f.factored_spmv_df(A, x)
        return _f.factored_spmv(A, x)

    def matvec(self, x):
        return self.matvec_with(self.A, x)

    def vec_in(self, x):
        if self.dtype == "df64":
            return df.from_f64(np.asarray(x))
        jt = {"f32": jnp.float32, "f64": jnp.float64}[self.dtype]
        return jnp.asarray(np.asarray(x), dtype=jt)

    def vec_out(self, y):
        if self.dtype == "df64":
            return df.to_f64(y)
        return np.asarray(y, dtype=np.float64)

    def __call__(self, x):
        return self.matvec(x)
