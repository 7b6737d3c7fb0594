"""FM-index: host construction (``build``, ``sharded``) and batched
queries (``index``, ``backtrack``).

The package imports none of its modules itself, so that a process-pool
worker of the sharded build loads ``build`` (numpy and the native
library) without torch."""
