"""Capacity updates on a solved flow (port of the host half of the JAX
package's ``repro.streaming``; the device drain and the streaming
sessions wait in ROADMAP.md Queue 1)."""
