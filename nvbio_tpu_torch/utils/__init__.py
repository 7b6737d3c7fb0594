"""Read simulation: a copy of ``nvbio_tpu/utils/simulate.py``."""
