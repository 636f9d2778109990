from lilac.generate import npb, random_crs, stencil  # noqa: F401
