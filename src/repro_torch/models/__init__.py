"""The language models (port of the JAX package's ``repro.models``): so
far the layers and the dense transformer (``attn+mlp`` blocks), in
train, prefill and decode modes with their caches."""
