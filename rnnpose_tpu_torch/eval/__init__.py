"""Pose evaluation: metrics, ICP and the per-class evaluators."""
