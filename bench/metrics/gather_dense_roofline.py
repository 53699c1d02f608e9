"""Share of its byte roofline of the min search's dense gather form: the
relabel sweep, and the sweeps of phase 2 and the cut."""
from bench.lib import readers

#: the program's entry, wrapped in the traced request
ENTRY = "repro_torch.kernels.ops:tile_min_neighbor_gather"
#: the parts of the kernel's device symbol
SYMBOL = ("dense_kernel", "KeyGather")


def bytes_of(avq, indptr, heads, res, h, *, n):
    """What any dense call moves at the least, from the shapes alone:
    ``indptr`` and ``res`` of every arc read once, ``minh`` and
    ``argarc`` of every vertex written once, 4 bytes a word.  The heads
    of arcs with ``res > 0`` and the heights they index depend on the
    data and are left out, so the share is a floor.  ``None`` for the
    AVQ form (``avq`` given), another kernel."""
    if avq is not None:
        return None
    a = res.shape[-1]
    rows = res.numel() // a
    return 4.0 * rows * ((n + 1) + a + 2 * n)


def read(ctx):
    return readers.roofline(ctx, "gather_dense_roofline")
