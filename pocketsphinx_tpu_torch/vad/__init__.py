"""Voice activity detection and endpointing: host code, copied from
`pocketsphinx_tpu.vad`."""

from .vad import Vad
from .endpointer import Endpointer

__all__ = ["Vad", "Endpointer"]
