"""Contract analysis of the port: the op census of one run
(:mod:`~repro_torch.analysis.ir`), the contract rules
(:mod:`~repro_torch.analysis.rules`), the 25 dispatch surfaces
(:mod:`~repro_torch.analysis.surfaces`), collective wire bytes
(:mod:`~repro_torch.analysis.collectives`), the AST lint
(:mod:`~repro_torch.analysis.lint`) and the per-mode op baselines
(:mod:`~repro_torch.analysis.baselines`), behind ``python -m
repro_torch.launch.analyze``."""
