"""Command-line tools: build_index, map_reads, mem_map, qmap, set_bwt,
sw_benchmark, protein_sw, correct_reads, bwa_export, bwa_import,
extract_reads, aln_diff, sam_merge, self_test and fm_server (``python -m
nvbio_tpu_torch.tools.<name>``; the device tools take ``--device
cuda|cpu``, default cuda)."""
