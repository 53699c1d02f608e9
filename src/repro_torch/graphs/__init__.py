from repro_torch.graphs.generators import (  # noqa: F401
    bipartite_random,
    genrmf,
    grid_road,
    powerlaw,
    random_sparse,
    washington_rlg,
)
