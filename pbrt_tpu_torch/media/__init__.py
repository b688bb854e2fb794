"""Participating media (port of pbrt_tpu/media): the Henyey-Greenstein
phase function (phase.py), the scene-level medium and the shape-bounded
interior media (medium.py)."""
