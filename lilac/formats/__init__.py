from lilac.formats.sparse import COO, CSR, ELL, BSR, SlicedELL, BucketELL  # noqa: F401
from lilac.formats import convert  # noqa: F401
