"""Metrics, image writers and the JAX parameter bridge."""
