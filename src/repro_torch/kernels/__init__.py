"""Hand-written CUDA kernels for the store's read and compaction paths
and the model stack's prefill.

Each kernel package holds ``ops.py`` (the wrapper: a CPU tensor goes to
the plain version, a CUDA tensor launches the kernel or raises) and
``ref.py`` (the plain PyTorch version of the same function).  The CUDA
sources are in ``repro_torch/csrc``; ``native`` builds and loads them.

  cascade     fused all-levels bloom + fence + GLORAN lookup cascade
  merge       merge rank of queries in a sorted run (compaction merges)
  bloom       batched Bloom-filter probe of one SSTable filter
  interval    point stab of one disjoint DR-tree level
  ssd         Mamba2 SSD intra-chunk outputs and chunk states
  flash_attention  causal / sliding-window GQA attention
"""
