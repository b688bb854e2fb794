"""pbrt_tpu_torch — the PyTorch + CUDA port of pbrt_tpu for NVIDIA Hopper.

A second package beside `pbrt_tpu/` (the JAX reference, which stays as it
is). Module paths and public names mirror the reference: a reader finds
`pbrt_tpu/lights/buffers.py::LightBuffers.sample_li` at
`pbrt_tpu_torch/lights/buffers.py::LightBuffers.sample_li`.

What is ported (the forward spectral path trace of the diffuse Cornell
box, of the killeroo-class mesh scene and of pbrt-v4 scene files with
instanced meshes):
  core/      tensor dataclasses, pcg4d RNG, CIE/sRGB colour, rgb2spec,
             vector maths, sampling warps, transforms
  samplers/  the independent sampler
  cameras/   perspective camera ray generation
  shapes/    triangle geometry buffers + Interaction
  materials/ material table, the GGX and Fresnel terms, and the diffuse and
             conductor BxDFs of the select chain
  lights/    area lights and the uniform infinite light (uniform / power
             selection)
  ops/       K1, the small-scene intersection kernel (csrc/smallscene.cu),
             K2, the Morton cluster kernel (csrc/cluster.cu), and K3, the
             instanced sweep kernel (csrc/sweep.cu), each with its plain
             PyTorch twin
  accel/     closest / any-hit queries on the small-scene, cluster and
             sweep tiers, the ray sort, instanced attribute resolution and
             the Morton order
  models/    the path integrator (NEE + MIS + RR), primal only
  films/     spectrum -> sRGB film
  io/        the .pbrt parser's subset (load_pbrt) and PLY reading and
             writing
  scenes/    the Cornell box (diffuse variant) and the procedural meshes

Anything outside that slice raises NotImplementedError at parse, build or
convert time, naming the ROADMAP Queue 1 item that will port it.

Conventions: float32 everywhere (TF32 matmuls stay off:
torch.backends.cuda.matmul.allow_tf32 is False, and `render` refuses to run
on a GPU when it is on); the device is chosen by the caller and never
picked silently; randomness is the reference's stateless pcg4d hash,
reproduced bit for bit. This package never imports jax.
"""

__version__ = "0.1.0"
