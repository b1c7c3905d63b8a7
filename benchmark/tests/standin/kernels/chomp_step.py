"""A stand-in kernel's work for the harness's tests: a ``chomp_step``
launch counted as one operation and four bytes an entry of its
trajectory."""

OPS = ("chomp_step_kernel",)


def work(args, kwargs):
    n = args[0].numel()
    return float(n), 4.0 * n
