"""Rendering: mesh preparation, rasterization, shading."""
