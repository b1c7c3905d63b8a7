"""The work of one ``min_dist_grid`` launch (``csrc/min_dist_grid.cu``,
``ops/kernels.py::min_dist_grid(grid, points)``), counted from its
arguments: 8 flop-equivalents a (cell, point) pair (four float32
instructions, 3 FFMA and 1 FMNMX, at the FFMA rate of 2 flops each; a frozen
copy of ``chip_smoke.py``'s ``MIN_DIST_FLOPS_PER_PAIR``), and each cell's
three coordinates and each point's three read once, each cell's distance
written once, in float32."""

OPS = ("min_dist_grid_kernel",)
FLOPS_PER_PAIR = 8


def work(args, kwargs):
    grid, points = args[0], args[1]
    g, n = grid.shape[0], points.shape[0]
    return float(FLOPS_PER_PAIR * g * n), float(4 * (3 * g + 3 * n + g))
