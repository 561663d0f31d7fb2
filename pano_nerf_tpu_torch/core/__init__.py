"""Rays, device selection and the dot-key config system."""
