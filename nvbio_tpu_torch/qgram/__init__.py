"""Q-gram index and filter (sorted keys and positions on the device,
batched ``torch.searchsorted`` queries)."""

from .index import QGramIndex, build_qgram_index, qgram_filter  # noqa: F401
