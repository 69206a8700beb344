"""kernel.blend_ms: device time per action of the program's hand-written
kernels (csrc/*.cu: the tile blend B1/B2, the CSR blend B3/B4, the dual walk
B5 and the bin B6), ms."""

from benchmark.harness.trace import kernel_us

NAMES = (
    "tile_fwd_partials_kernel", "tile_fwd_combine_kernel",  # B1
    "tile_bwd_suffix_kernel", "tile_bwd_walk_kernel",  # B2
    "csr_partials_kernel", "csr_combine_kernel",  # B3, B5
    "csr_bwd_pieces_kernel", "csr_bwd_walk_kernel",  # B4
    "bin_count_kernel", "bin_slots_kernel",  # B6
)


def read(ctx):
    us = kernel_us(ctx.stretch, NAMES)
    return us / ctx.actions * 1e-3 if us > 0 else None
