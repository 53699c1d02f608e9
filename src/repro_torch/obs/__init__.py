"""Device-side solver telemetry (port of the counter half of the JAX
package's ``repro.obs``)."""
