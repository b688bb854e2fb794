"""pbrt_tpu_torch — the PyTorch + CUDA port of pbrt_tpu for NVIDIA Hopper.

A second package beside `pbrt_tpu/` (the JAX reference, which stays as it
is). Module paths and public names mirror the reference: a reader finds
`pbrt_tpu/lights/buffers.py::LightBuffers.sample_li` at
`pbrt_tpu_torch/lights/buffers.py::LightBuffers.sample_li`.

What is ported (the forward spectral path trace of the Cornell box, of
the killeroo-class mesh scene, of the furnace and of pbrt-v4 scene files
with static and moving instances, every shape family, shape alpha and
the scene-file lights, the volumetric path of the cloud and of
scene-file media, the light-tracing integrators, and the default
gradient path):
  core/      tensor dataclasses, pcg4d RNG, CIE/sRGB colour, rgb2spec,
             vector maths, sampling warps, transforms (animated ones with
             quaternions), ULP stepping, error-free products and interval
             arithmetic
  samplers/  the independent sampler
  cameras/   perspective camera ray generation (a moving camera too)
  shapes/    the geometry buffers of every shape family + Interaction,
             curve flattening and Loop subdivision
  materials/ material table, the GGX and Fresnel terms, and the diffuse and
             conductor BxDFs of the select chain
  lights/    area, sphere, point, spot, projection, goniometric and
             distant lights, the uniform infinite light, the image infinite
             light (envmap.py) and the portal light (portal.py), with
             uniform or power selection
  ops/       K1, the small-scene intersection kernel (csrc/smallscene.cu),
             K2, the Morton cluster kernel (csrc/cluster.cu), K3, the
             instanced sweep kernel (csrc/sweep.cu), and K4, the BVH
             traversal kernel (csrc/traverse.cu), each with its plain
             PyTorch twin; the staged compaction of masked walks
  accel/     closest / any-hit queries on the small-scene, cluster, sweep,
             kd-tree and BVH tiers, or the dense watertight tester, with
             the alpha restart loop, the moving instances and the analytic
             families merged; the BVH and kd-tree builds, the ray sort,
             instanced attribute resolution and the Morton order
  media/     homogeneous, grid, rgbgrid and procedural-cloud media with
             DDA majorants, interior-media stacks, the HG phase function
  models/    the path integrator (NEE + MIS + RR) and its remat gradient;
             the volumetric path integrator (delta and ratio tracking,
             interface-aware shadow rays) and its differentiable variant
  films/     spectrum -> sRGB film
  io/        the .pbrt parser's subset (load_pbrt), PLY reading and
             writing, and PFM reading (images of lights too)
  parallel/  the single-device training step
  scenes/    the Cornell box (diffuse variant), the procedural meshes, the
             furnace (analytic.py), the many-light hall and the cloud and
             fog box (cloud.py)

Anything outside that slice raises NotImplementedError at parse, build or
convert time, naming the ROADMAP Queue 1 item that will port it.

Conventions: float32 everywhere (TF32 matmuls stay off:
torch.backends.cuda.matmul.allow_tf32 is False, and `render` refuses to run
on a GPU when it is on); the device is chosen by the caller and never
picked silently; randomness is the reference's stateless pcg4d hash,
reproduced bit for bit. This package never imports jax.
"""

__version__ = "0.1.0"
