"""Logical-axis sharding rules of the multi-device LM (``rules``)."""
