"""``mx.nd.linalg``: the short names of the flat ``linalg_*`` ops.

Counterpart of ``mxnet_tpu/ndarray/linalg.py`` (the reference's
``python/mxnet/ndarray/linalg.py`` over ``la_op.cc``); each name is the
op of :mod:`.legacy_ops`.
"""
from .legacy_ops import (  # noqa: F401
    linalg_det as det,
    linalg_extractdiag as extractdiag,
    linalg_extracttrian as extracttrian,
    linalg_gelqf as gelqf,
    linalg_gemm as gemm,
    linalg_gemm2 as gemm2,
    linalg_inverse as inverse,
    linalg_makediag as makediag,
    linalg_maketrian as maketrian,
    linalg_potrf as potrf,
    linalg_potri as potri,
    linalg_slogdet as slogdet,
    linalg_sumlogdiag as sumlogdiag,
    linalg_syevd as syevd,
    linalg_syrk as syrk,
    linalg_trmm as trmm,
    linalg_trsm as trsm,
)

__all__ = ["det", "extractdiag", "extracttrian", "gelqf", "gemm", "gemm2",
           "inverse", "makediag", "maketrian", "potrf", "potri", "slogdet",
           "sumlogdiag", "syevd", "syrk", "trmm", "trsm"]
