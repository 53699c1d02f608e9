"""Share of its byte roofline of the min search's rev entry, the paper-
faithful BCSR cycle's min search, push decision and reverse arc."""
from bench.lib import readers

#: the program's entry, wrapped in the traced request
ENTRY = "repro_torch.kernels.ops:tile_min_neighbor_gather_rev"
#: the parts of the kernel's device symbol
SYMBOL = ("avq_kernel", "KeyGather, true")


def bytes_of(avq, indptr, heads, tails, res, h, *, n, deg_max):
    """What any call moves at the least, from the shapes alone: every
    lane of the queue read once and its three outputs (``minh``,
    ``argarc``, ``rev``) written once, 4 bytes a word.  What a queued
    vertex reads of its segment depends on the data and is left out, so
    the share is a floor."""
    return 16.0 * avq.numel()


def read(ctx):
    return readers.roofline(ctx, "gather_rev_roofline")
