"""lilac — a JAX sparse linear-algebra framework for NVIDIA GPUs.

A from-scratch JAX/XLA re-design with the capabilities of the
mob-group/lilac-benchmarks suite (CC 2020 "Automatically Harnessing Sparse
Acceleration"): CSR/COO/ELL/BSR sparse formats, SpMV/SpMM/SpGEMM with a
pluggable kernel registry and auto-selecting planner (the analogue of the
reference's libspmv backend zoo, reference libspmv/native.c:3), an
iterative-solver library (NPB CG, BiCG, GMRES, Jacobi/ILU preconditioning),
and SpMV-driven graph workloads (PageRank, BFS, PATHSAMPLE committor),
distributed over multi-device meshes via shard_map + XLA collectives.

Layer map (reference layer -> here):
  libspmv ABI (spmv_harness_)     -> lilac.ops.spmv(A, x)
  backend .so zoo                 -> lilac.kernels registry
  mprotect mutation caches        -> immutable arrays + SpmvPlan staging
  SVM platform predictor          -> lilac.autotune predictor
  workloads (CG/BiCG/PR/BFS/...)  -> lilac.workloads
  run_all + results analysis      -> lilac.bench
"""

__version__ = "0.1.0"

from lilac.formats.sparse import COO, CSR, ELL, BSR  # noqa: F401
from lilac.ops.spmv import spmv  # noqa: F401
from lilac.plan import SpmvPlan  # noqa: F401
