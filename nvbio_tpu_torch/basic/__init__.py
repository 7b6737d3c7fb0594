"""Alphabets and 2-bit packing: copies of ``nvbio_tpu/basic/alphabet.py``
and ``packed.py`` for the port, which imports nothing of ``nvbio_tpu``."""
