"""Architecture configs selectable by ``--arch`` (port of the JAX
package's ``repro.configs``): the ten language-model configs, each exact
(``CONFIG``) and reduced (``SMOKE``), and the max-flow workload,
``wbpr-maxflow``."""
