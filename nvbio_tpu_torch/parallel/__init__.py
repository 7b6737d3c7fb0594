"""Scale-out: device meshes (``mesh``), the process group, input sharding
and the ordered SAM merge (``distributed``)."""

from .mesh import make_mesh, shard_reads, replicate  # noqa: F401
from .distributed import (  # noqa: F401
    init_distributed,
    shard_fastq,
    read_fastq_range,
    merge_sam_shards,
)
