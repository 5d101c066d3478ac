"""Rendering: mesh loading and preparation, rasterization, shading."""
