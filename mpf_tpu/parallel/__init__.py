"""Multi-chip distribution (north-star addition; the reference is strictly
single GPU, `MPF.cu:77`).

``mesh``         — device mesh construction + capability probe (analogue
                   of `check_cooperative_groups.cu`)
``block_cyclic`` — 2D block-cyclic layout utilities
``dist_lu``      — shard_map distributed blocked LU over XLA collectives
"""
