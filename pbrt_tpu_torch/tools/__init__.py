"""Command-line tools of the port (pbrt_tpu/tools): the render CLI,
imgtool, format_scene, plytool, lenstool, pspec, cyhair2pbrt and
nanovdb2pbrt."""
