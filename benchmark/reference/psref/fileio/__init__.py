"""Host-side model file readers (NumPy copies of `pocketsphinx_tpu.fileio`)."""

from .s3 import S3File
from .bin_mdef import BinMdef, read_bin_mdef, read_text_mdef
from .acoustic import (Gauden, MixtureWeights, Tmat, read_gauden,
                       read_sendump, read_mixw_quantized, read_tmat,
                       read_lda)
from .dictionary import Dictionary

__all__ = [
    "S3File", "BinMdef", "read_bin_mdef", "read_text_mdef", "Gauden",
    "MixtureWeights", "Tmat", "read_gauden", "read_sendump",
    "read_mixw_quantized", "read_tmat", "read_lda", "Dictionary",
]
