"""Observability: span tracer and metrics registry (copies of the JAX
package's ``obs/``, with torch device hooks)."""
