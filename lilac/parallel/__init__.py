from lilac.parallel.dist import (  # noqa: F401
    DistAlg,
    DistSpmvPlan,
    dist_cg_solve,
    dist_npb_power_method,
    make_mesh,
)
