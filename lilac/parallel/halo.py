"""Halo-exchange distributed SpMV: ppermute ring instead of all-gather.

DistSpmvPlan (dist.py) all-gathers x every matvec — optimal when each row
shard references most columns (NPB CG's uniformly random pattern). For
matrices with column locality (stencils: SparseBench structure=1,
regular meshes — the reference's `regular.f` family), each shard's column
footprint outside its own block is a thin halo; gathering everything wastes
interconnect bandwidth. This plan precomputes, per ring distance k, exactly
which x entries travel, and exchanges them with lax.ppermute — the
collective form of the MPI-NPB halo bookkeeping the serial reference inherited
(cg.f:116-119) but never exercised.

Per-DISTANCE halos: the exchange for ring distance k is padded to
H_k = max over source shards of that distance's segment, and distances
nobody references are skipped entirely — a 1-D-sharded stencil therefore
does exactly two neighbour ppermutes (k = 1 and ndev-1) instead of
ndev-1 max-padded ones, and the ghost region is the true two-plane halo.

Ghost layout: kept distances' segments concatenate after the local block
in distance order, and ELL column ids are remapped at plan-build time
into the [local | ghost] space — so the device matvec is gather-free
beyond the usual ELL gather, with zero scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lilac.formats import convert
from lilac.solvers.algebra import get_algebra
from lilac.parallel.dist import DistAlg


def halo_tables(ev, ec, ndev: int, rps: int):
    """Per-distance halo bookkeeping from the row-block ELL split.

    ev/ec: [ndev, rps, K] ELL values / global column ids.
    Returns (dist_ks, halos, send_tbls, new_ec):
      dist_ks : kept ring distances (k: src s -> dst (s+k) % ndev)
      halos   : H_k per kept distance
      send_tbls: [ndev, H_k] int64 local positions each src sends at k
      new_ec  : ELL ids remapped into [local rps | ghost segments]
    """
    owner = ec // rps
    needed = {}  # (dst, src) -> sorted unique local positions on src
    # d-independent: hoisted out of the loop (recomputing it per shard
    # made plan build O(ndev^2 * rps * K))
    used_mask = ev != 0.0 if ev.ndim == 3 else (ev[..., 0] != 0.0)
    for d in range(ndev):
        for s in range(ndev):
            if s == d:
                continue
            sel = used_mask[d] & (owner[d] == s)
            cols = np.unique(ec[d][sel]) if sel.any() else np.empty(0, np.int64)
            needed[(d, s)] = cols - s * rps

    dist_ks, halos, send_tbls = [], [], []
    for k in range(1, ndev):
        H_k = max(len(needed[((s + k) % ndev, s)]) for s in range(ndev))
        if H_k == 0:
            continue
        tbl = np.zeros((ndev, H_k), dtype=np.int64)
        for s in range(ndev):
            pos = needed[((s + k) % ndev, s)]
            tbl[s, : len(pos)] = pos
        dist_ks.append(k)
        halos.append(H_k)
        send_tbls.append(tbl)

    # ghost offsets per kept distance
    off = {}
    acc = rps
    for k, H_k in zip(dist_ks, halos):
        off[k] = acc
        acc += H_k

    new_ec = np.zeros_like(ec)
    for d in range(ndev):
        local = owner[d] == d
        new_ec[d] = np.where(local, ec[d] - d * rps, 0)
        for k in dist_ks:
            s = (d - k) % ndev
            pos = needed[(d, s)]
            lookup = np.zeros(rps, dtype=np.int64)
            lookup[pos] = off[k] + np.arange(len(pos))
            sel = owner[d] == s
            new_ec[d] = np.where(
                sel, lookup[np.clip(ec[d] - s * rps, 0, rps - 1)], new_ec[d]
            )
        # padding slots (value 0) may point anywhere valid
    return tuple(dist_ks), tuple(halos), send_tbls, new_ec


@dataclasses.dataclass
class HaloSpmvPlan:
    """Row-block ELL plan with ring halo exchange (f32/f64)."""

    mesh: Mesh
    axis: str
    data: jax.Array  # [ndev, rps, K]
    indices: jax.Array  # [ndev, rps, K] int32 ids into [local | ghost]
    send_tbls: Tuple[jax.Array, ...]  # per kept distance [ndev, H_k] int32
    dist_ks: Tuple[int, ...]
    halos: Tuple[int, ...]
    shape: Tuple[int, int]
    n_pad: int
    rps: int
    dtype: str

    @property
    def halo(self) -> int:
        """Largest per-distance halo (0 when no exchange is needed)."""
        return max(self.halos, default=0)

    @property
    def total_ghost(self) -> int:
        return sum(self.halos)

    @staticmethod
    def build(indptr, indices, data, shape, mesh, *, dtype="f32", axis="x"):
        from lilac.plan import require_x64

        require_x64(dtype)
        ndev = mesh.shape[axis]
        n = shape[0]
        assert shape[0] == shape[1]
        rps = convert.round_up(-(-n // ndev), 8)
        n_pad = ndev * rps
        np_t = {"f32": np.float32, "f64": np.float64}[dtype]
        ev, ec = convert.csr_to_ell_arrays(
            indptr, indices, data.astype(np_t), shape, row_pad=n_pad
        )
        K = ev.shape[1]
        ev = ev.reshape(ndev, rps, K)
        ec = ec.reshape(ndev, rps, K).astype(np.int64)

        dist_ks, halos, send_tbls, new_ec = halo_tables(ev, ec, ndev, rps)

        sh3 = NamedSharding(mesh, P(axis, None, None))
        sh2 = NamedSharding(mesh, P(axis, None))
        return HaloSpmvPlan(
            mesh=mesh,
            axis=axis,
            # host arrays go straight to their shards (no device-0 staging)
            data=jax.device_put(ev, sh3),
            indices=jax.device_put(new_ec.astype(np.int32), sh3),
            send_tbls=tuple(
                jax.device_put(np.asarray(t, dtype=np.int32), sh2)
                for t in send_tbls
            ),
            dist_ks=dist_ks,
            halos=halos,
            shape=tuple(shape),
            n_pad=n_pad,
            rps=rps,
            dtype=dtype,
        )

    # -- vectors ---------------------------------------------------------

    def vec_in(self, x: np.ndarray):
        xp = np.zeros(self.n_pad, dtype=np.float64)
        xp[: self.shape[0]] = np.asarray(x, dtype=np.float64)
        jt = {"f32": np.float32, "f64": np.float64}[self.dtype]
        sh = NamedSharding(self.mesh, P(self.axis))
        return jax.device_put(xp.astype(jt), sh)

    def vec_out(self, y) -> np.ndarray:
        return np.asarray(y, dtype=np.float64)[: self.shape[0]]

    # -- per-shard matvec (call INSIDE shard_map) --------------------------

    def ghost_concat(self, x_local, sends):
        """x_ext = [local | per-distance ghosts] via ppermute ring legs."""
        ndev = self.mesh.shape[self.axis]
        ghosts = []
        for k, send in zip(self.dist_ks, sends):
            buf = x_local[send[0]]
            perm = [(i, (i + k) % ndev) for i in range(ndev)]
            ghosts.append(jax.lax.ppermute(buf, self.axis, perm))
        return jnp.concatenate([x_local] + ghosts) if ghosts else x_local

    def local_matvec(self, A_local, x_local):
        data, idx = A_local[0], A_local[1]
        x_ext = self.ghost_concat(x_local, A_local[2:])
        gathered = x_ext[idx[0]]
        return jnp.sum(data[0] * gathered, axis=1)

    def alg(self) -> DistAlg:
        return DistAlg(get_algebra(self.dtype), self.axis)

    @property
    def a_specs(self):
        ax = self.axis
        return (P(ax, None, None), P(ax, None, None)) + tuple(
            P(ax, None) for _ in self.send_tbls
        )

    @property
    def a_arrays(self):
        return (self.data, self.indices) + self.send_tbls

    def vspec(self):
        return P(self.axis)


def halo_matvec(plan: HaloSpmvPlan, x):
    """Whole-mesh SPMD matvec (jit + shard_map wrapper)."""
    ax = plan.axis

    f = jax.jit(
        jax.shard_map(
            plan.local_matvec,
            mesh=plan.mesh,
            in_specs=(plan.a_specs, P(ax)),
            out_specs=P(ax),
            check_vma=False,
        )
    )
    return f(plan.a_arrays, x)
