from lilac.workloads import npb_cg, sparsebench  # noqa: F401
