"""vorbispizza_tpu — an Ogg Vorbis decode framework on an accelerator.

Built from scratch in JAX/XLA with the capability surface of
TechPizzaDev/VorbisPizza (see SURVEY.md). Host side: Ogg framing, packet
assembly, setup parsing, Huffman/VQ entropy decode. Device side: batched
floor synthesis, coupling inverse, IMDCT, windowed overlap-add.
"""

__version__ = "0.2.0"

from .config import VorbisConfig
from .decoder import StreamDecoder
from .errors import (
    EndOfStreamError,
    InvalidDataError,
    NotSeekableError,
    PrerollPacketError,
    SeekOutOfRangeError,
    VorbisError,
)
from .reader import VorbisReader
from .stats import StreamStats
from .tags import TagData

__all__ = [
    "VorbisConfig",
    "StreamDecoder",
    "VorbisReader",
    "StreamStats",
    "TagData",
    "VorbisError",
    "InvalidDataError",
    "EndOfStreamError",
    "SeekOutOfRangeError",
    "NotSeekableError",
    "PrerollPacketError",
]
