"""Pose, camera and crop geometry, and the LM pose solver."""
