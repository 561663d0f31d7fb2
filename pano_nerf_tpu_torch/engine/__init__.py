"""Render system (chunked eval renderer) and validation."""
