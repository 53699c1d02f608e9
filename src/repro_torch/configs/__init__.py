"""Architecture configs selectable by ``--arch`` (port of the JAX
package's ``repro.configs``): so far the max-flow workload,
``wbpr-maxflow``; the language-model configs are not ported yet."""
