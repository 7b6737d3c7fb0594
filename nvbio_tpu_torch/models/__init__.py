"""Mapper params, MAPQ and the single-end mappers: the flagship
(seed + FM search), the MEM ("nvMem") and the q-gram mappers."""

from .mapper import Mapper, MapResult  # noqa: F401
from .mem_mapper import MemMapper  # noqa: F401
from .params import MapperParams  # noqa: F401
from .qgram_mapper import QGramMapper  # noqa: F401
