"""Distributed (multi-chip) SpMV and solver execution.

The reference suite is single-node (SURVEY.md section 2.4 — no MPI/NCCL
anywhere); distribution is this framework's new first-class capability. The
design follows the scaling-book recipe: pick a mesh, shard the matrix by row
blocks, let the collectives (NCCL on GPUs) move the vectors.

v1 scheme (all-gather):
  * rows padded to ndev * rows_per_shard, ELL-packed with GLOBAL column ids,
    stored as [ndev, rps, K] arrays sharded on the leading mesh axis;
  * vectors are [n_pad] sharded on the same axis;
  * matvec: x_full = all_gather(x_local), then the local ELL
    gather-reduce — the counterpart of the halo exchange the NPB MPI CG
    does with its firstrow/lastrow bookkeeping (cg.f:116-119);
  * dot products: local partial + psum (the distributed form of the serial
    reduction loops at cg.f:504-506, 573-576);
  * df64 dots: partials are all-gathered and re-summed with compensated
    df-addition so cross-device reduction doesn't lose the low words.

Solvers run UNCHANGED inside one shard_map: `DistAlg` wraps a base algebra
with mesh reductions and the matvec closure hides the all-gather, so the
whole CG is a single SPMD program (collectives fused into the XLA schedule).

Halo-index (ppermute ring) exchange replaces all-gather in
lilac.parallel.halo for matrices whose column footprint per shard is
small; all-gather is optimal for NPB-CG-like matrices where every shard
touches most columns.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lilac.formats import convert
from lilac.formats.sparse import ELL
from lilac.ops import dfloat as df
from lilac.solvers.algebra import DF64Alg, get_algebra


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


class DistAlg:
    """Mesh-aware algebra: local elementwise ops + collective dot products."""

    def __init__(self, base, axis: str = "x"):
        self.base = base
        self.axis = axis
        self.dtype = getattr(base, "dtype", None)

    def dot(self, u, v):
        local = self.base.dot(u, v)
        if isinstance(self.base, DF64Alg):
            # gather df partials and re-sum compensated (psum of hi/lo
            # separately would drop the low words)
            his = jax.lax.all_gather(local.hi, self.axis)
            los = jax.lax.all_gather(local.lo, self.axis)
            return df.sum_df(df.DF(his, los), axis=0)
        return jax.lax.psum(local, self.axis)

    def __getattr__(self, name):
        return getattr(self.base, name)


@dataclasses.dataclass
class DistSpmvPlan:
    """Row-block distributed ELL plan.

    Device arrays are globally-shaped [ndev, rps, K] with NamedSharding on
    the leading axis; inside shard_map each shard sees [1, rps, K].
    """

    mesh: Mesh
    axis: str
    data: jax.Array  # [ndev, rps, K] (or [ndev, rps, K, 2] for df64)
    indices: jax.Array  # [ndev, rps, K] int32 global col ids
    shape: Tuple[int, int]
    n_pad: int
    dtype: str
    kernel: str = "xla_ell"

    @staticmethod
    def build(
        indptr: np.ndarray,
        indices: np.ndarray,
        data: np.ndarray,
        shape: Tuple[int, int],
        mesh: Mesh,
        *,
        dtype: str = "f32",
        axis: str = "x",
    ) -> "DistSpmvPlan":
        from lilac.plan import require_x64

        require_x64(dtype)
        ndev = mesh.shape[axis]
        n = shape[0]
        assert shape[0] == shape[1], "distributed plan assumes square matrices"
        rps = convert.round_up(-(-n // ndev), 8)
        n_pad = ndev * rps

        if dtype == "df64":
            hi = data.astype(np.float32)
            lo = (data - hi.astype(np.float64)).astype(np.float32)
            vals = np.stack([hi, lo], axis=-1)
        else:
            np_t = {"f32": np.float32, "f64": np.float64}[dtype]
            vals = data.astype(np_t)

        ev, ec = convert.csr_to_ell_arrays(indptr, indices, vals, shape, row_pad=n_pad)
        k = ev.shape[1]
        ev = ev.reshape((ndev, rps, k) + ev.shape[2:])
        ec = ec.reshape(ndev, rps, k)

        sh3 = NamedSharding(mesh, P(axis, *(None,) * (ev.ndim - 1)))
        shi = NamedSharding(mesh, P(axis, None, None))
        # host arrays go straight to their shards: a jnp.asarray first
        # would stage the whole matrix on device 0
        return DistSpmvPlan(
            mesh=mesh,
            axis=axis,
            data=jax.device_put(ev, sh3),
            indices=jax.device_put(ec, shi),
            shape=tuple(shape),
            n_pad=n_pad,
            dtype=dtype,
        )

    # -- vectors --------------------------------------------------------

    def vec_in(self, x: np.ndarray):
        """Host f64 [n] -> padded sharded device vector."""
        xp = np.zeros(self.n_pad, dtype=np.float64)
        xp[: self.shape[0]] = np.asarray(x, dtype=np.float64)
        sh = NamedSharding(self.mesh, P(self.axis))
        if self.dtype == "df64":
            hi = xp.astype(np.float32)
            lo = (xp - hi.astype(np.float64)).astype(np.float32)
            return df.DF(
                jax.device_put(hi, sh), jax.device_put(lo, sh)
            )
        jt = {"f32": np.float32, "f64": np.float64}[self.dtype]
        return jax.device_put(xp.astype(jt), sh)

    def vec_out(self, y) -> np.ndarray:
        if self.dtype == "df64":
            return df.to_f64(y)[: self.shape[0]]
        return np.asarray(y, dtype=np.float64)[: self.shape[0]]

    # -- per-shard matvec (call INSIDE shard_map) ------------------------

    def local_matvec(self, A_local, x_local):
        """A_local: ([1, rps, K...], [1, rps, K]) shard views; x_local [rps]."""
        data, idx = A_local
        if self.dtype == "df64":
            x_full = df.DF(
                jax.lax.all_gather(x_local.hi, self.axis, tiled=True),
                jax.lax.all_gather(x_local.lo, self.axis, tiled=True),
            )
            a = df.DF(data[0, ..., 0], data[0, ..., 1])
            xg = df.DF(x_full.hi[idx[0]], x_full.lo[idx[0]])
            t = df.mul(a, xg)
            return df.sum_df(t, axis=1)
        x_full = jax.lax.all_gather(x_local, self.axis, tiled=True)
        ell = ELL(data=data[0], indices=idx[0], shape=(data.shape[1], self.n_pad))
        from lilac.kernels import xla as kx

        return kx.ell_spmv(ell, x_full)

    def alg(self) -> DistAlg:
        return DistAlg(get_algebra(self.dtype), self.axis)

    @property
    def a_specs(self):
        ax = self.axis
        dspec = P(ax, None, None, None) if self.data.ndim == 4 else P(ax, None, None)
        return (dspec, P(ax, None, None))

    @property
    def a_arrays(self):
        return (self.data, self.indices)

    def vspec(self):
        return P(self.axis)


def dist_npb_power_method(plan: DistSpmvPlan, x0, shift: float, niter: int):
    """NPB outer power iteration as one SPMD program over the mesh.

    x0 from plan.vec_in(...). Returns (zetas, rnorms, x_final) with scalar
    histories replicated and x_final sharded.
    """
    from lilac.solvers.cg import npb_power_method

    alg = plan.alg()
    ax = plan.axis
    vs = jax.tree.map(lambda _: P(ax), x0)

    def body(A_local, x_local):
        return npb_power_method(
            plan.local_matvec, alg, A_local, x_local, shift, niter
        )

    # scalar histories: each leaf is [niter]-shaped, replicated
    if plan.dtype == "df64":
        hist_spec = df.DF(P(), P())
    else:
        hist_spec = P()
    out_specs = (hist_spec, hist_spec, vs)
    f = jax.jit(
        jax.shard_map(
            body,
            mesh=plan.mesh,
            in_specs=(plan.a_specs, vs),
            out_specs=out_specs,
            check_vma=False,
        )
    )
    return f(plan.a_arrays, x0)


def dist_cg_solve(plan: DistSpmvPlan, b, *, maxit=100, rtol=1e-6):
    """General CG over the mesh (SparseBench semantics, distributed)."""
    from lilac.solvers.cg import cg_solve

    alg = plan.alg()
    ax = plan.axis
    vs = jax.tree.map(lambda _: P(ax), b)
    if plan.dtype == "df64":
        scal_spec = df.DF(P(), P())
    else:
        scal_spec = P()

    def body(A_local, b_local):
        return cg_solve(plan.local_matvec, alg, A_local, b_local, maxit=maxit, rtol=rtol)

    f = jax.jit(
        jax.shard_map(
            body,
            mesh=plan.mesh,
            in_specs=(plan.a_specs, vs),
            out_specs=(vs, P(), scal_spec),
            check_vma=False,
        )
    )
    return f(plan.a_arrays, b)


def dist_transposed_plan(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    shape: Tuple[int, int],
    mesh: Mesh,
    **kw,
) -> DistSpmvPlan:
    """Aᵀ staged as its own row-block distributed plan (host CSC
    transpose), so BOTH product directions keep the all-gather +
    local-gather-reduce path and every value policy (incl. df64's
    compensated sums) works unchanged."""
    rows = np.repeat(np.arange(shape[0], dtype=np.int64), np.diff(indptr))
    t_ip, t_ix, t_v = convert.coo_to_csr_arrays(
        indices, rows, data, (shape[1], shape[0])
    )
    return DistSpmvPlan.build(t_ip, t_ix, t_v, (shape[1], shape[0]), mesh, **kw)


def dist_bicg_solve(
    plan: DistSpmvPlan,
    plan_t: DistSpmvPlan,
    b,
    *,
    maxit: int = 100,
    rtol: float = 1e-6,
):
    """Distributed BiCG (SparseBench iter.f semantics) as one SPMD
    program: both A·p and the exact Aᵀ·p̂ (the reference's harness
    substitutes A for Aᵀ — SURVEY.md section 3.5; here the transpose is
    staged honestly) run row-sharded with psum/all-gather collectives.
    Returns (x sharded, its, hist, rnorm)."""
    from lilac.solvers.bicg import bicg_solve

    alg = plan.alg()
    ax = plan.axis
    vs = jax.tree.map(lambda _: P(ax), b)
    if plan.dtype == "df64":
        scal_spec = df.DF(P(), P())
    else:
        scal_spec = P()
    x0 = jax.tree.map(jnp.zeros_like, b)

    # bicg_solve takes one operator argument: thread both shard views as
    # a pair and split inside the closures
    def body2(A_local, At_local, b_local, x0_local):
        x, its, hist, rn, _state = bicg_solve(
            lambda pair, v: plan.local_matvec(pair[0], v),
            lambda pair, v: plan_t.local_matvec(pair[1], v),
            alg,
            (A_local, At_local),
            b_local,
            x0_local,
            maxit=maxit,
            rtol=rtol,
        )
        return x, its, hist, rn

    f = jax.jit(
        jax.shard_map(
            body2,
            mesh=plan.mesh,
            in_specs=(plan.a_specs, plan_t.a_specs, vs, vs),
            out_specs=(vs, P(), P(), scal_spec),  # hist is plain f32
            check_vma=False,
        )
    )
    return f(plan.a_arrays, plan_t.a_arrays, b, x0)
