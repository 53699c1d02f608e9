"""The paper's own workload as an --arch config: WBPR max-flow.

Shapes are graph scales (see launch/shapes.py GRAPH_SHAPES); the dry-run
runs one rank's distributed vertex-centric push-relabel superstep.

A copy of the JAX package's ``repro.configs.wbpr_maxflow``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    name: str = "wbpr-maxflow"
    family: str = "graph"
    layout: str = "bcsr"
    mode: str = "vc"


CONFIG = GraphConfig()
SMOKE = dataclasses.replace(CONFIG, name="wbpr-maxflow-smoke")
