"""Scoring types, the plain banded Gotoh DP, the traceback walk, the
host CIGAR/MD helpers and the scalar alignment oracle."""

from .types import (  # noqa: F401
    AlignmentType,
    GotohScheme,
    NEG_INF,
    BOWTIE2_LOCAL_SCHEME,
    gap_penalties,
)
from .oracle import align_oracle  # noqa: F401
from .cigar import traceback_banded, cigar_to_string, make_md_string  # noqa: F401
