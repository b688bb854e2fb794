#!/usr/bin/env python3
"""Chip smoke test of pbrt_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N]

(--seed: the seed of phase e14's generated inputs, 0 by default.) It
builds every CUDA kernel of the port from the sources in the checkout,
checks each against its plain PyTorch twin, renders the Cornell box (on
the small tier and on the kd-tree), the killeroo-class mesh scene (on the
cluster tier and on the BVH tier), the instanced field (a .pbrt file
through the port's parser) and the golden scene files spot.pbrt,
envmap.pbrt, plymesh.pbrt, dielectric.pbrt, spheres.pbrt, texture.pbrt
and imagetex.pbrt, the many-light hall (power and light-BVH samplers),
the volumetric cloud, fog.pbrt, the families box (hair, subsurface,
measured, mix and retroreflective materials), the light tracers (the
light path, BDPT, AO, the spectral bands), the shapes box (every shape
family and shape alpha), the moving instanced field and the Cornell box
through every camera family (lens, omni, eye, orthographic, spherical,
RTF; the GBuffer's channels) and the io scenes (EXR, PNG, QOI and Ptex
textures, an EXR environment map, a NanoVDB medium) on the card against
the committed JAX goldens, holds every sampler kind's draws bit for bit
against the CPU's and the JAX package's, renders
the golden scene files conductor.pbrt, plymesh.pbrt, spot.pbrt,
envmap.pbrt, box.pbrt, dielectric.pbrt, spheres.pbrt, texture.pbrt,
imagetex.pbrt, fog.pbrt, bdpt.pbrt, sppm.pbrt and mlt.pbrt (the last
three through the file entry, render.render_file) against the pbrt-v4
C++ goldens and the
furnace scene and the fog box against their closed forms, holds the backward pass's image-loss gradients
against the JAX gradient golden, across tiers and, through delta lights
(and a glass sphere), against the CPU, and through the coated materials'
layered walk against their JAX golden, a medium's absorption
gradient and the moving field's gradients against their JAX goldens,
times the forward render of each timed
configuration (the mesh gallery's glass torus, texture.pbrt, bench's
many-light hall, bench's volumetric cloud, the families box, BDPT,
SPPM, MLT, the shapes box, the moving field, the Cornell box through a
lens, the eye's spectral bands and the io scenes among them) and the
Cornell
forward+backward pass, takes three training steps, renders box.pbrt
and plymesh.pbrt through the render CLI (against the C++ goldens and
render_file) and times its first image from a shell, renders and trains
over a device mesh and over process groups (gloo and NCCL), and holds
the native tokenizer and Morton sort against their twins. Each phase prints
one JSON line;
any failure raises, so the script exits non-zero and never prints the
final line. Without a CUDA device it exits non-zero at
once. It never imports JAX.

Phases:
  a   device: name, nvidia-smi name and power limit, torch/CUDA versions
  b   build: nvcc builds of K1 (csrc/smallscene.cu), K2 (csrc/cluster.cu),
      K3 (csrc/sweep.cu), K4 (csrc/traverse.cu) and the micro-benchmarks'
      kernels (csrc/micro_pairs.cu, micro_mosaic.cu, micro_mosaic2.cu,
      micro_dyn.cu, micro_entry.cu), started together, with their ptxas
      summaries (registers, shared memory and spills of every template
      instance)
  m1  the micro-benchmarks (pbrt_tpu_torch/micro/, the ports of
      scripts/micro/'s six pallas_calls) at the probes' full constants:
      each module's timed run (the main path of `python -m
      pbrt_tpu_torch.micro.<probe>`), its launches counted from zero;
      then every kernel in every mode (micro_mosaic2 at n_it 1024)
      against its plain version on the card, bit-equal with NaN equal
      (micro_entry's accumulator scratch and its loop's own acc too),
      with ms, ns per iteration, the plain version's ms and the bound.
      Where the probe's inputs leave a mode's output saturated or
      constant, a second comparison at the same shapes whose values are
      finite and depend on the data: loop reduce and cond on an x whose
      block max crosses 1e30, micro_dyn matmul_small over 24 iterations
      (its acc overflows near 34), micro_entry mt_only, no_write, full
      and while on a table whose triangles every ray hits. A comparison
      with an output that is entirely non-finite counts for no mode, and
      m1 fails unless every mode has one that counts. Last, the SASS of
      micro_dyn keeps dynstore's global store and smemwrite's shared
      store (more STG than dynload, more STS than smemread)
  d29 the render CLI (pbrt_tpu_torch.tools.pbrt_render.main, --device
      cuda) on box.pbrt (K1; 512 spp) and plymesh.pbrt (K2; 256 spp) at
      their own 64x64 in passes of 32: each EXR within d10's / d7's
      bounds of the C++ golden and bit-equal to render_file's image of the
      same file and arguments, the kernel's CLI launches counted from
      zero; `--gbuffer --spectral-buckets 6` on box.pbrt equal to
      render_aovs (the spectral buckets, atomic sums, within rtol 1e-5);
      `--debugstart 3,5,1` within rtol 1e-4 of the CPU's record
  e16 the CLI's time to first image from a shell: `python -m
      pbrt_tpu_torch.tools.pbrt_render tests/goldens/box.pbrt --spp 64
      --device cuda` in a child (-X importtime; kernels built by b): wall
      to exit and to the written EXR, the parse and render seconds it
      prints, torch's import seconds, no jax in the child; then one CLI
      render inside utils/profile.capture with the scope "cli/render":
      the Chrome trace holds the scope and K1's kernel
  p1  the single-process mesh [cuda:0, cuda:0] (parallel/): the Cornell
      box at 64x64, 8 spp, depth 5, 8 lanes; render_tile_sharded
      bit-equal to the one-device image, render_spp_sharded within rtol
      2e-5 / atol 2e-6 of it and bit-equal over two calls,
      training_step(mesh=...) within rtol 2e-4 / atol 1e-7 of the
      one-device step (loss 1e-5); 11 K1 launches a shard a wave
  p2  the process groups: two parallel/mp_worker.py processes over gloo
      and one world of size 1 over NCCL, each with mesh entries [cuda:0,
      cuda:0], started together (Cornell 64x64, 4 spp, depth 3, 8 lanes,
      render and training step): the gloo images bit-equal to the NCCL
      process's, the gradients identical on both ranks and within rtol
      2e-4 of one process's, K1 launched in every process
  n1  the native tokenizer and Morton sort (pbrt_tpu_torch/native/,
      g++): equal to their twins on the 13 C++-golden scene files, the
      port's scenes and the CLI's, and on every centroid set the
      killeroo-class and instanced-field builds sort; host seconds of
      each side, and of the two builds with the twins and with the native
      code in turns
  c   K1 vs its twin on 4,194,304 rays (the Cornell pass's query shape):
      camera rays, random rays inside the box, dead lanes (tmax = 0),
      axis-parallel rays and NEE shadow segments; closest and any-hit
      modes must be bit-equal; kernel and twin times
  c2  K2 vs its twin on the killeroo-class scene (122,244 triangles):
      65,536 rays of each kind the path sends (camera, cosine rays from the
      mesh, axis-parallel, dead lanes, area-light and infinite-light shadow
      rays) in closest, any-hit and non-deferred closest modes, bit-equal;
      K2, its twin, ray_sort_perm and resolve_tri_attrs timed at the main
      path's shape (1,048,576 sorted rays), with the twin's visit counts
      (pairs; 128-ray block, 32-ray warp and lone, triangle-parallel, warp
      visits), the bound and the share of it reached; any-hit also in
      live-lane order (live_lane_order, a diagnostic off the path)
  c3  K3 vs its twin on every query of a 16x16, 4 spp pass (camera, four
      bounces and the terminal query in closest mode, five shadow queries
      with the path's dead lanes in any-hit mode), for the instanced field
      (tests/data/torch_port/instanced_field.pbrt: 37 instances, 17,191
      entries) and for with_accel(kind="sweep") on the killeroo-class
      scene, bit-equal; then K3 and its twin at the main path's shape (the
      1,048,576 camera rays of one instanced-field pass and their shadow
      rays), bit-equal key by key, timed, with c2's counts and diagnostic
  c4  K4 vs its twin on the killeroo-class scene's BVH (depth 15): 65,536
      rays of each kind of c2, unsorted, in closest and any-hit modes,
      bit-equal key by key, with the built kernel's design constants and
      stack entries; then at the main path's shape (the 1,048,576 camera
      rays of one pass and their shadow rays, unsorted, as the BVH tier
      sends them), bit-equal, timed, against the bound of K4's own walk
      and, beside it, that of the twin's walk
  c5  K2 vs its twin on the many-light hall (2,338 triangles, 2,048 of
      them emitters): every K2 query of one e8 pass (256x256, 8 spp, depth
      4, power sampler; camera, three bounces and the terminal query in
      closest mode, four shadow queries with the path's dead lanes in
      any-hit mode, 524,288 lanes each), the launches counted from zero
      over that pass, each query bit-equal key by key, kernel and twin
      timed, with c2's counts, bound and diagnostic
  c6  K1 vs its twin on every query of one pass of the volumetric path:
      the cloud (scenes/cloud.py, bench's cloud_fwd scene: a 48^3 density
      grid over a 2-triangle floor; 128x128, 8 spp, depth 6: per bounce
      the closest query and the any-hit occlusion queries of the two
      ratio-tracking transmittances, then the terminal pair; 20 queries)
      and fog.pbrt (64x64, 8 spp: per bounce the closest query and the
      four closest queries of each of the two interface-aware shadow
      walks, done lanes at tmax 0; 46 queries), launches counted from
      zero, each query bit-equal key by key, kernel and twin timed, with
      the bound
  d   Cornell 32x32, 16 spp, 32 lanes, depth 5 (default Russian roulette)
      against tests/data/torch_port/cornell32_spp16.npy: >= 99% of pixel
      values within rtol 1e-3 / atol 1e-5, and 11 K1 launches per pass
  d2  killeroo-class 64x64, 4 spp, 8 lanes, depth 5 against
      tests/data/torch_port/killeroo64_spp4.npy: the same gate, 11 K2 and
      0 K1 launches per pass
  d3  the instanced field, 64x64, 4 spp, 8 lanes, the file's integrator
      against tests/data/torch_port/instanced64_spp4.npy: the same gate, 11
      K3 and no K1 or K2 launches per pass
  d4  the killeroo-class scene on the BVH tier alone, 64x64, 4 spp, 8
      lanes, against the killeroo golden of d2: the same gate, 11 K4 and no
      K1, K2 or K3 launches per pass
  d5  tests/goldens/conductor.pbrt through the port's parser (two analytic
      conductor spheres, K1 for its four triangles), 384 spp in passes of
      32 (the same samples as passes of 8), independent sampler, against the pbrt-v4 C++ golden
      tests/goldens/conductor_ref.pfm (4096 spp): relative mean error <
      0.05, MSE < 2e-3 and 95th percentile of the 4x4-cell relative error
      < 0.2, the bounds tests/test_reference_parity.py gives this scene
  d6  the Cornell box with only the kd-tree attached, 32x32, 16 spp, 32
      lanes, against the Cornell golden of d: the same gate, no K1 launch
  d7-d10
      the golden scene files plymesh.pbrt (a point and an infinite light,
      1,282 triangles: K2), spot.pbrt (a spot light), envmap.pbrt (an
      image infinite light over sky.pfm) and box.pbrt (an area light; K1
      for the last three) through the port's parser at their 64x64 and
      depth, at tests/test_reference_parity.py's spp (256, 256, 256, 512)
      in passes of 32, against the pbrt-v4 C++ goldens with that file's
      gate and bounds (as d5); each prints its kernel's launches and the
      render's seconds
  d13-d16
      the golden scene files dielectric.pbrt (a rough glass and a thin
      dielectric sphere), spheres.pbrt (a smooth glass sphere),
      texture.pbrt (procedural checkerboard and scale textures) and
      imagetex.pbrt (a PFM image texture), K1 for each, at their CASES spp
      (384, 384, 256, 256) in passes of 32 against the C++ goldens, as
      d7-d10
  d11 the furnace (scenes/analytic.py: a point light at the centre of a
      diffuse unit sphere, no triangles), 64x64, 4 spp, depth 16 without
      Russian roulette, 32 lanes: the mean spectral radiance within 1 +-
      0.025, the reference's own gate, and no triangle kernel launched
  d12 spot.pbrt, envmap.pbrt and plymesh.pbrt at 32x32, 4 spp, 8 lanes,
      the file's integrator, against the JAX goldens of
      scripts/make_torch_port_golden_lights.py: d's gate, 9 K1 (K2 for
      plymesh) launches per pass
  d17 dielectric.pbrt, spheres.pbrt, texture.pbrt and imagetex.pbrt at
      32x32, 4 spp, 8 lanes, the file's integrator, against the JAX goldens
      of scripts/make_torch_port_golden_materials.py: d's gate, 2 x depth +
      1 K1 launches per pass
  g   the gradient golden: Cornell 32x32, 4 spp in passes of 2, depth 5
      without Russian roulette, 8 lanes, bench.py's loss (the MSE of
      spectrum_to_rgb against 0.25) and its gradients with respect to
      materials.albedo_coeffs and lights.area_scale, on the card, against
      tests/data/torch_port/cornell32_grad.npz (the JAX reference's, from
      scripts/make_torch_port_golden_grad.py) and against the port's own
      CPU pass: each gradient within 1e-3 of its tensor's largest
      magnitude, the loss within 1e-4, exact zeros kept; 11 K1 launches per
      forward+backward pass
  g2  the same loss and gradients on the killeroo-class scene, 64x64, 2
      spp in one pass, 8 lanes, on the cluster tier and on the BVH tier:
      finite, the tiers within 1e-3 of each gradient's largest magnitude,
      11 K2 (resp. K4) launches per forward+backward pass and no other
  g3  the same loss on spot.pbrt (a spot light, no area light: the
      area-scale gradient is empty), 16x16, 2 spp, 8 lanes, the file's
      depth 4 without Russian roulette: the albedo gradient on the card
      within 1e-5 of its largest entry of the port's CPU pass, 9 K1
      launches per forward+backward pass
  g4  g3 on spheres.pbrt (a point and a distant light; diffuse rows seen
      through the smooth glass sphere), depth 5: within 1e-6 of the
      largest entry, 11 K1 launches per forward+backward pass
  d18 the many-light hall (scenes/manylight.py: 1,024 panels, 2,048 area
      lights, a coated-diffuse floor, 2,338 triangles: K2) with the power
      and the light-BVH sampler at 32x32, 4 spp, depth 4 without Russian
      roulette, 8 lanes, against the JAX goldens of
      scripts/make_torch_port_golden_manylight.py, the layered walk on
      coarse keys as the goldens (tests/torch_port_coated.py): d's gate,
      9 K2 launches per pass; the share and mean of the render on the
      exact keys beside it (mean within EXACT_KEYS_MEAN_RTOL of the
      golden's)
  d19 tests/goldens/fog.pbrt (a homogeneous interior medium behind a
      material-less sphere, a point light; volpath) at 192 spp in passes
      of 32 against the C++ golden, as d5 (rel 0.06, MSE 5e-5, q95 0.15)
  d20 the fog box (scenes/cloud.py: an emissive quad behind a
      homogeneous slab) against its closed form Le exp(-sigma_t) within
      6% (absorbing, depth 3, 32 spp), and the absorbing-and-scattering
      slab's bounds at depth 1 and 4, tests/test_media.py's gates
  d21 the cloud (entry inset, tests/torch_port_media.py) and fog.pbrt at
      32x32, 4 spp, 8 lanes against the JAX goldens of
      scripts/make_torch_port_golden_media.py: d's gate, 20 / 46 K1
      launches per pass; the cloud's exact-entry share and mean beside it
  c7  K1 vs its twin on every query of one pass of the families box
      (tests/data/torch_port/families.pbrt: hair, subsurface, measured
      from a synthetic RGL file, mix and retroreflective surfaces; 128x128,
      8 spp, depth 5: per bounce the closest query, the subsurface probe
      (a closest query of a per-ray tmax, on every lane) and the shadow
      query, then the terminal closest; 16 queries), launches counted from
      zero, each query bit-equal key by key, kernel and twin timed
  d22 the families box at 32x32, 4 spp, 8 lanes, depth 5, the mix hash on
      coarse keys (tests/torch_port_families.py), against the JAX golden
      of scripts/make_torch_port_golden_families.py: d's gate, 16 K1
      launches per pass
  c8  K1 vs its twin on every query of one pass of each light tracer on
      its golden scene, launches counted from zero, each query bit-equal
      key by key, kernel and twin timed, with the bound: the light path
      (bdpt.pbrt's room, 128x128 paths: 11 queries), BDPT (the room,
      128x128, 1 spp: 6 camera and 5 light walk steps, 15 connections, 6
      t = 1 splats; 32), an SPPM iteration (sppm.pbrt, 128x128, its glass
      sphere answered by the sphere block after K1: 15) and an MLT step
      (mlt.pbrt, 256 chains: 11)
  d23 bdpt.pbrt (256 spp in passes of 16), sppm.pbrt (32 iterations) and
      mlt.pbrt (256 mutations per pixel) through the parser and
      render.render_file, seed 1, against the pbrt-v4 C++ goldens with
      tests/test_reference_parity.py's MC_CASES bounds (relative mean
      error and MSE); MLT runs the file's 256 chains unless their 2,304
      steps would take more than 60 s at the time of the first steps, and
      then 4,096 (the phase prints which)
  d24 the light path, BDPT, AO and the spectral bands on the room at
      16x16 against the JAX goldens of
      scripts/make_torch_port_golden_lighttransport.py: d's gate
  g6  tests/test_gradients.py's medium gradient: the fog box (sigma_a
      0.8, 8x8, 48 spp, depth 2, no NEE, 32 steps, differentiable=True),
      the mean radiance and its derivative in medium.sigma_a_scale on the
      card against tests/data/torch_port/fogbox8_grad.npz and the CPU
      pass, within 1e-3 of the golden's; 4 K1 launches per
      forward+backward pass
  g5  the bench's loss and gradients on the coated Cornell box (coated
      diffuse walls, a coated gold conductor; tests/torch_port_coated.py),
      32x32, 4 spp in passes of 2, depth 5, 8 lanes, coarse walk keys,
      against tests/data/torch_port/coated_cornell32_grad.npz and the
      port's CPU pass (computed by a child process started after e16)
      with g's tolerance; 11 K1 launches per
      forward+backward pass, a forward's
  e   timed Cornell forward at its benchmark configuration (256x256, 128
      spp in passes of 64, depth 5, no Russian roulette) at 8 and 32 lanes
  e2  timed killeroo-class forward at its benchmark configuration (512x512,
      8 spp in passes of 4, depth 5, no Russian roulette, 8 lanes): Mrays/s,
      first-pass seconds, peak memory, K2's and the ray sorts' shares
  e3  timed instanced-field forward (the file's 512x512 and 8 spp, in passes
      of 4, depth 5, no Russian roulette, 8 lanes): Mrays/s, peak memory,
      K3's launches and share, and the first image's seconds from the parse
      on (PLY reads, sweep build and upload included)
  e4  timed killeroo-class forward on the BVH tier at e2's configuration:
      Mrays/s, first-pass seconds from build_bvh on (K4's packed rows and
      the upload included; the packing's own seconds beside them), peak
      memory, K4's launches and share
  e_timed_fwdbwd
      bench.py's cornell_fwdbwd_8lane (256x256, 16 spp, bench's 64 cut, in
      passes of 2, depth 5, no Russian roulette, 8 lanes, value and
      gradient with respect to both parameters): Mrays/s as bench.py counts
      it (a forward pass's rays per pass over the forward+backward wall),
      the forward alone at the same shape, the backward's share of the
      wall, K1 launches per pass, peak memory, the card and its power limit
  e5  plymesh.pbrt timed (512x512, 8 spp in passes of 4, 8 lanes, the
      file's depth 4 without Russian roulette, seed 0): Mrays/s, K2
      launches per pass, peak memory, and the layers' device ms of one
      pass (CUDA events around each layer's calls, as
      scripts/profile_torch_pass.py takes them): lights against BxDF
  e6  the mesh gallery timed (scenes/meshes.py mesh_gallery_scene at
      512x512, subdiv 4: 15,620 triangles, K2; 8 spp in passes of 4, depth
      5 without Russian roulette, 8 lanes, seed 0): Mrays/s, K2 launches
      per pass, peak memory and e5's layers, the BxDF's with the
      dielectric branch
  e7  texture.pbrt timed (512x512, 8 spp in passes of 4, the file's depth
      4 without Russian roulette, 8 lanes, seed 0): Mrays/s, K1 launches
      per pass, peak memory, the texture layer's device ms
      (evaluate_albedo_coeffs with its per-ray fit) and kernel launches in
      one pass, and e5's layers
  e8  bench.py's manylight_fwd timed: the hall at 256x256, one pass of 8
      spp (bench's 16 cut; 524,288 camera rays a pass), depth 4 without Russian
      roulette, 8 lanes, the cluster tier, with the power sampler and with
      the light BVH: Mrays/s as bench.py counts rays, K2 launches per pass
      and K2's share of the wall, peak memory, the layers' device ms with
      the coated walk split from the BxDF's and light selection from the
      lights' (and the sorted dispatch's whole call), kernel launches per
      pass and the device's busy share (torch.profiler); then the power
      pass with sorted_shading=False against the sorted default, one
      timed pass each after a warm-up, the first pass's image of each
      bit-equal
  e9  bench.py's cloud_fwd timed: the cloud at 128x128, one pass of 8 spp
      (bench's 16 cut; 131,072 camera rays a pass), depth 6, the DDA walk, Russian
      roulette from 3, 8 lanes: Mrays/s as bench.py counts rays, K1
      launches per pass, the walks' host reads per pass, peak memory, the
      layers' device ms (camera, closest, the delta walk, the ratio
      walks, lights, phase, BxDF, RNG, film), kernel launches per pass and
      the busy share (profiled at 64x64), the delta walk's live lanes per
      step at bounce 0;
      then the compacted walks against the lockstep walks, one timed pass
      each after a warm-up, the first pass's image of each bit-equal
  e10 the families box timed at 512x512, 8 spp in passes of 4, depth 5
      without Russian roulette, 8 lanes, seed 0: Mrays/s, K1 launches per
      pass, peak memory, the first pass's seconds, the layers' device ms
      with the BxDF's split by the sorted dispatch's family segments and
      the subsurface step's and its probe query's ms, kernel launches per
      pass and the device's busy share (torch.profiler); then sorted
      against lockstep shading, each timed after a warm-up, the first
      pass's image of each bit-equal
  e11 the light tracers timed, each with K1 launches and ms per pass,
      peak memory, its layers' device ms (BDPT: walks, connection
      queries, BxDF, splats; SPPM: camera pass, grid, photon pass and its
      deposits; MLT: the contribution's path trace), kernel launches per
      pass and the busy share: BDPT on the room at 256x256, 8 spp in
      passes of 4 (paths/s); SPPM on sppm.pbrt at 256x256, 4 iterations
      (iterations/s, photons/s); MLT on mlt.pbrt, 16 steps of 256 and of
      4,096 chains (mutations/s)
  c9  K1 vs its twin on every query of one pass of the shapes box
      (tests/data/torch_port/shapes.pbrt: 336 triangles, 126 curve
      segments, a disk, a cylinder, a bilinear patch, a texture-alpha
      screen and an alpha 0.5 panel; 128x128, 8 spp, depth 5: every
      closest and shadow query is a first query and 3 alpha restarts, 44
      queries) and K3 vs its twin on every query of one pass of the
      moving field (tests/data/torch_port/motion.pbrt: 7 static
      instances on K3, 2 moving ones; 32x32, 4 spp; 44 queries),
      launches counted from zero, each query bit-equal key by key,
      kernel and twin timed, with the bound
  d25 the shapes box (the alpha test on coarse keys,
      tests/torch_port_shapes.py) and the moving field at 32x32, 4 spp, 8
      lanes, depth 5 against the JAX goldens of
      scripts/make_torch_port_golden_shapes.py: d's gate, 44 K1 (shapes)
      or K3 (motion) launches per pass
  g7  the bench's loss and gradients on the moving field, 32x32, 4 spp in
      passes of 2, depth 5, 8 lanes, against
      tests/data/torch_port/motion32_grad.npz with g's tolerance; 44 K3
      launches per forward+backward pass
  e12 the shapes box and the moving field timed at 512x512, one pass of
      4 spp, depth 5 without Russian roulette, 8 lanes, seed 0:
      Mrays/s, the wall a pass, K1 / K3 launches a pass, peak memory,
      the layers' device ms with the queries split (the triangle tier
      with its alpha loop, the animated pass, the curve and disk /
      cylinder / patch merges, the analytic shadow occlusion; K1 / K3,
      K3's sorts and resolution, the alpha evaluations), kernel launches
      per pass and the busy share, the card's name and power limit
  c10 K1 vs its twin on every query of one cornell_lens pass (64x64, 4
      spp: the Cornell box through tests/data/torch_port/doublet.dat with
      its exit pupil, zsobol, a gaussian filter; 11 queries, the
      vignetted lanes traced) and of the GBuffer pass (render_aovs at
      32x32, 2 spp: the path's 11 and the first-hit closest query),
      launches counted from zero, each query bit-equal key by key, kernel
      and twin timed, with the bound
  d26 the Cornell box through each camera family
      (tests/torch_port_cameras.py) at 32x32 against the JAX goldens of
      scripts/make_torch_port_golden_cameras.py: the doublet with its exit
      pupil (zsobol, gaussian), the omni .json lens with its microlens
      array (sobol, triangle), orthographic (halton, mitchell), spherical
      (pmj02bn) and RTF (fitted to the doublet, the reference's
      coefficients carried across; stratified, lanczos) at 4 spp, the
      Navarro eye with HURB diffraction through render_spectral (4 bands
      of 2 spp) and every channel of render_aovs: d's gate, a lit image,
      each render's share of camera rays with weight > 0 within 1e-3 of
      the reference's, 11 K1 launches a pass (12 with the GBuffer's
      closest)
  d27 every sampler kind's get_1d and get_2d of dimensions 0-40 and
      get_1d_run at 1,048,576 lanes, bit for bit the port's CPU draws
      (sha256 digests; the CPU's computed by a child process started with
      the script), and at 4,096 lanes bit for bit the committed JAX draws;
      render_resumable stopped after its first chunk and resumed, bit for
      bit the one-shot render on the card
  e13 cornell_lens timed (the Cornell box through the doublet with its
      exit pupil, zsobol, a gaussian filter; 256x256, 64 spp in passes of
      16, depth 5 without Russian roulette, 8 lanes): Mrays/s, K1
      launches, peak memory, the camera's and the lens trace's ms, the
      sampler's ms, kernel launches and busy share a pass; one pass with
      each sampler kind and with the perspective camera and the
      independent sampler (ms, sampler ms, kernel launches from a 64x64
      profiled pass); eye_bands: the Navarro eye with diffraction
      through render_spectral, 8 bands x 8 spp at 256x256: Mrays/s, the
      eye trace's ms, K1 launches, peak memory
  c11 K1 vs its twin on every query of one pass of each io scene
      (tests/data/torch_port/io: io_surfaces.pbrt, EXR, PNG and QOI
      imagemaps, an EXR environment map and Ptex textures, 11 queries;
      io_smoke.pbrt, a NanoVDB medium and a Ptex wall, 17 queries; 32x32, 4
      spp, the file's integrator), launches counted from zero, each query
      bit-equal key by key, kernel and twin timed, with the bound
  d28 both io scenes at 32x32, 4 spp, 8 lanes, the file's integrator
      (io_smoke's medium entry inset, tests/torch_port_media.py) against
      the JAX goldens of scripts/make_torch_port_golden_io.py: d's gate, a
      lit image, 11 / 17 K1 launches per pass
  e14 the io slice at full width: the inputs written at run time by the
      port's writers from --seed (tests/torch_port_io.py FULL: 1024^2
      imagemaps, 64^2 Ptex faces, a 128^3 ZIP NanoVDB grid; a 2048^2 half
      ZIP EXR map read for its reader's seconds, the scene's sky at 128^2,
      see that module), each writer's and reader's host seconds, each
      scene's load-to-Scene seconds, then io_surfaces (256x256, 8 spp in
      passes of 4) and io_smoke (256x256, one pass of 4 spp) at depth 5
      without Russian roulette, 8 lanes: Mrays/s, K1 launches a pass,
      kernel launches a pass and the busy share (torch.profiler), peak
      memory, the card's name and power limit
  g8  the textured Cornell box (tests/torch_port_grad.py: a 4x4 image
      texture on material 0; 16x16, 2 spp, depth 5, 8 lanes) under the
      default estimator: the bench loss's gradients with respect to
      albedo_coeffs, area_scale and textures.img_flat against
      tests/data/torch_port/grad_modes16.npz (scripts/
      make_torch_port_golden_grad.py --which modes) with g's tolerance;
      in each of g8-g11 the K1 launches of one forward+backward pass are
      counted from zero: 0 in the backward, the primal's in the forward
  g9  the Cornell box with material 1 a rough dielectric under the
      attached estimator (replay_grad=False): albedo_coeffs, area_scale
      and materials.eta against the same file
  g10 g8's box under grad_mode="cvjp" with replay_remat "full", "dots"
      and "none": each against its golden, and against the remat
      estimator's loss (bit-equal) and gradients on the card
  g11 the families box (16x16, 2 spp, the mix hash on coarse keys; the
      attached estimator, as it holds a subsurface block): albedo_coeffs
      and area_scale against tests/data/torch_port/families16_grad.npz;
      16 K1 launches in the forward
  g12 the scene leaves of item 5e.1-5e.4 (tests/torch_port_leaves.py:
      the families and coated boxes' material leaves, texture.pbrt's,
      leaf_textures.pbrt's and io_surfaces' Ptex texture tables, the
      spot, point, infinite, image, portal, area, sphere, projection,
      goniometric and distant lights' tables, the fog box's slab and an
      8^3 density and RGB grid under the differentiable volumetric path),
      each scene under one estimator of its golden (attached where it
      has one, else remat) at the golden's settings, against
      tests/data/torch_port/leaves_*_grad.npz (scripts/
      make_torch_port_golden_leaves.py) with g's tolerance, a table
      along the golden's probe directions; 0 K1 (K2 on plymesh.pbrt)
      launches in every backward, the primal's in the forward
  g13 the rest of item 5e (tests/torch_port_leaves.py's volpath and
      sampling groups): the fog box's slab and the families box in a
      homogeneous medium with their surface, light and medium leaves,
      fog.pbrt's interior medium and the density grid's max_density
      through the differentiable volumetric path, envmap.pbrt's
      importance tables and leaf_lights.pbrt's selection pmf and cdf
      under remat and cvjp, the 16-light hall's BVH node table under
      cvjp: every case with a golden against it and against the same
      pass on the CPU, with g's tolerance, a zero golden exactly zero;
      K1 0 in every backward, the primal's in the forward (17, 46 with
      interior media, 11)
  e15 cornell_fwdbwd_8lane's shape (256x256, passes of 2 spp, 8 lanes,
      depth 5, no Russian roulette) under every estimator (remat,
      attached, cvjp full / dots / none), then the textured Cornell box
      and the families box under their default estimators: fwd+bwd
      Mrays/s over one timed pass, the backward's share, peak memory, kernel
      launches in the forward and in the backward (torch.profiler), K1
      launches in each
  e17 e15's shape and figures (one timed pass) with item 5e's leaves
      requested: the families box with every material leaf of g12's
      golden (e15 has it with the default leaves), leaf_lights.pbrt with
      its light tables and texture.pbrt with its texture tables
  e18 e17's shape and figures with the rest of item 5e's leaves: the
      families box in its medium through the differentiable volumetric
      path with g13's leaves, and the 16-light hall with its BVH node
      table under cvjp
  t   t_train: three training_steps (lr 1e-2) on the Cornell box, 64x64, 2
      spp, 8 lanes: each loss, every parameter finite, moved and on the card
  f   the kernels line (the six micro kernels' launches those of m1's
      timed runs; K1's launches those of e, e12's shapes box,
      e13's cornell_lens, e14's io scenes, the loss and gradient calls
      of g8-g13, e17's and e18's timed passes, d29's box.pbrt, p1's
      sharded calls
      and p2's worker processes, K2's those of e2, d29's plymesh.pbrt
      and g12's plymesh.pbrt cases, K3's those of e3 and e12's moving
      field, by path),
      the nvidia-smi line and the final result line
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port", "cornell32_spp16.npy")
GOLDEN_KILLEROO = os.path.join(ROOT, "tests", "data", "torch_port",
                               "killeroo64_spp4.npy")
K1_SOURCE = "pbrt_tpu_torch/csrc/smallscene.cu"
K1_REPLACES = "pbrt_tpu/ops/smallscene.py:73"
K2_SOURCE = "pbrt_tpu_torch/csrc/cluster.cu"
K2_REPLACES = "pbrt_tpu/ops/cluster.py:177"
K3_SOURCE = "pbrt_tpu_torch/csrc/sweep.cu"
K3_REPLACES = "pbrt_tpu/ops/sweep.py:308"
K4_SOURCE = "pbrt_tpu_torch/csrc/traverse.cu"
K4_REPLACES = "pbrt_tpu/ops/traverse.py:65"
# The micro-benchmarks: kernels-line name -> (module, source, pallas_call).
MICRO_KERNELS = {
    "micro_pairs": ("micro_pairs", "pbrt_tpu_torch/csrc/micro_pairs.cu",
                    "scripts/micro/micro_pairs.py:54"),
    "micro_mosaic_loop": ("micro_mosaic",
                          "pbrt_tpu_torch/csrc/micro_mosaic.cu",
                          "scripts/micro/micro_mosaic.py:77"),
    "micro_mosaic_dense": ("micro_mosaic",
                           "pbrt_tpu_torch/csrc/micro_mosaic.cu",
                           "scripts/micro/micro_mosaic.py:93"),
    "micro_mosaic2": ("micro_mosaic2", "pbrt_tpu_torch/csrc/micro_mosaic2.cu",
                      "scripts/micro/micro_mosaic2.py:57"),
    "micro_dyn": ("micro_dyn", "pbrt_tpu_torch/csrc/micro_dyn.cu",
                  "scripts/micro/micro_dyn.py:88"),
    "micro_entry": ("micro_entry", "pbrt_tpu_torch/csrc/micro_entry.cu",
                    "scripts/micro/micro_entry.py:105"),
}
GOLDEN_FILES = os.path.join(ROOT, "tests", "goldens")
# The C++-golden phases: (phase, scene file, spp, samples per pass, bounds
# on relative mean error, MSE and q95 cell error, the triangle kernel that
# must launch). spp and bounds are tests/test_reference_parity.py's CASES
# rows for the file, copied, not imported.
CXX_GOLDENS = (
    ("d5_golden_conductor", "conductor", 384, 32, (0.05, 2e-3, 0.2), "k1"),
    ("d7_golden_plymesh", "plymesh", 256, 32, (0.04, 1e-3, 0.15), "k2"),
    ("d8_golden_spot", "spot", 256, 32, (0.035, 5e-4, 0.15), "k1"),
    ("d9_golden_envmap", "envmap", 256, 32, (0.05, 2e-3, 0.35), "k1"),
    ("d10_golden_box", "box", 512, 32, (0.04, 0.035, 0.6), "k1"),
    ("d13_golden_dielectric", "dielectric", 384, 32, (0.05, 2e-3, 0.25), "k1"),
    ("d14_golden_spheres", "spheres", 384, 32, (0.035, 1e-4, 0.15), "k1"),
    ("d15_golden_texture", "texture", 256, 32, (0.04, 1e-3, 0.15), "k1"),
    ("d16_golden_imagetex", "imagetex", 256, 32, (0.04, 1e-3, 0.15), "k1"),
    ("d19_golden_fog", "fog", 192, 32, (0.06, 5e-5, 0.15), "k1"),
)
# d12 and d17: golden files against the JAX goldens of
# scripts/make_torch_port_golden_lights.py and
# scripts/make_torch_port_golden_materials.py (32x32, 4 spp, 8 lanes, seed
# 0), with the triangle kernel each launches.
JAX_LIGHT_GOLDENS = (("spot", "k1"), ("envmap", "k1"), ("plymesh", "k2"))
JAX_MATERIAL_GOLDENS = (("dielectric", "k1"), ("spheres", "k1"),
                        ("texture", "k1"), ("imagetex", "k1"))
GOLDEN_INSTANCED = os.path.join(ROOT, "tests", "data", "torch_port",
                                "instanced64_spp4.npy")
GOLDEN_GRAD = os.path.join(ROOT, "tests", "data", "torch_port",
                           "cornell32_grad.npz")
MAIN_PATH_RAYS = 256 * 256 * 64  # one forward pass of the bench config
# The killeroo and instanced-field passes: 512x512 at 4 samples per pixel.
PASS_RES, PASS_SPP = 512, 4
PASS_RAYS = PASS_RES * PASS_RES * PASS_SPP
K2_SAMPLE = 65536  # rays of each kind held against the twin

# The card's limits for the kernels' bounds (NVIDIA's data sheet, H100 SXM
# at 700 W): 3.35 TB/s of HBM, and 67 TFLOP/s of FP32 outside the tensor
# cores, which counts an FMA as two operations, so 33.5e12 of the kernels'
# separate (un-fused) FP32 operations per second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# FP32 operations of one Moller-Trumbore ray/triangle test as K1 and K2
# write it: 9 (p = d x e2) + 5 (det) + 1 (|det| > eps) + 1 (1/det) + 3 (tv)
# + 6 (u) + 9 (q = tv x e1) + 6 (v) + 6 (t) + 7 (the hit and best-t
# comparisons, with u + v).
MT_OPS = 53
# FP32 operations of a slab test (the twin's, of a popped node): 6 (box -
# o) + 6 (times 1/d) + 6 (per-axis min and max) + 4 (largest entry,
# smallest exit) + 1 (max(tmin, 0)) + 2 (the two comparisons); and of the
# twin's entry distance of a child: 6 + 6 + 3 (per-axis min) + 2
# (largest) + 1 (clamp) + 1 (the near/far comparison).
BOX_OPS = 25
ENTRY_OPS = 19
# K4's walk culls children when it pushes them: one slab test (BOX_OPS,
# its t_best part made at push) for each ray's root and for each child of
# an inner visit (the twin's "entries"), and one near/far comparison per
# sibling pair. A pop's tmin < t_best comparison is left out, so the bound
# stays a lower bound. The twin's walk (BOX_OPS per popped node, ENTRY_OPS
# per child, which K4 did before it culled at push) is reported beside it.
PAIR_OPS = 1


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "script_seconds": time.perf_counter() - START}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (after a warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: dict, want: dict) -> float:
    """Largest absolute difference of a kernel's float outputs (t where the
    twin's is finite; u, v, n where present) from its twin's."""
    import torch

    finite = torch.isfinite(want["t"])
    err = (float(torch.abs(got["t"][finite] - want["t"][finite]).max())
           if bool(finite.any()) else 0.0)
    for k in ("u", "v", "n"):
        if k in want:
            err = max(err, float(torch.max(torch.abs(got[k] - want[k]))))
    return err


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("a_device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_build():
    """Build every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pbrt_tpu_torch.ops import nvcc_build

    names = ("smallscene", "cluster", "sweep", "traverse", "micro_pairs",
             "micro_mosaic", "micro_mosaic2", "micro_dyn", "micro_entry")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(nvcc_build.load_library, names))
    wall = time.perf_counter() - t0
    result = {}
    for name in names:
        seconds, log = nvcc_build.BUILD_LOG.get(name, (0.0, ""))
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        result[name] = {"seconds": seconds, "ptxas": ptxas, "cached": not log}
    emit("b_build", wall_seconds=wall, **result)
    return result


def _k1_rays(scene, camera, dev):
    """4,194,304 rays of the kinds the forward pass sends to K1."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.accel.dense import shadow_segment
    from pbrt_tpu_torch.ops.smallscene import smallscene_intersect_ref
    from pbrt_tpu_torch.render import camera_rays_full

    rng = np.random.default_rng(0)
    nx, ny = camera.resolution
    n_cam = nx * ny
    n_axis = 65536
    n_rand = (MAIN_PATH_RAYS - n_cam - n_axis) // 2
    n_shadow = MAIN_PATH_RAYS - n_cam - n_axis - n_rand

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pixel = torch.arange(n_cam, device=dev)
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    o_rand = t(rng.uniform(0.02, 0.98, (n_rand, 3)))
    d_rand = t(rng.normal(size=(n_rand, 3)))
    d_rand = d_rand / torch.linalg.norm(d_rand, dim=-1, keepdim=True)
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_axis)]
    d_axis = t(axes * rng.choice([-1.0, 1.0], (n_axis, 1)))
    o_axis = t(rng.uniform(0.02, 0.98, (n_axis, 3)))
    # Shadow segments: hit points of the random rays (from the twin) to
    # light samples, offset and re-aimed as the integrator does.
    hits = smallscene_intersect_ref(
        scene.small, o_rand[:n_shadow], d_rand[:n_shadow],
        torch.full((n_shadow,), float("inf"), device=dev),
    )
    p = torch.where(
        (hits["prim"] >= 0)[:, None],
        o_rand[:n_shadow] + hits["t"][:, None] * d_rand[:n_shadow], 0.5,
    )
    lam = torch.full((n_shadow, 1), 550.0, device=dev)
    ls = scene.lights.sample_li(
        p, lam, t(rng.uniform(0, 1, n_shadow)), t(rng.uniform(0, 1, (n_shadow, 2)))
    )
    so, wi_sh, smax = shadow_segment(p, hits["n"], ls.wi, ls.dist)
    o = torch.cat([o_cam, o_rand, o_axis, so]).contiguous()
    d = torch.cat([d_cam, d_rand, d_axis, wi_sh]).contiguous()
    tmax = torch.cat([
        torch.full((n_cam + n_rand + n_axis,), float("inf"), device=dev), smax,
    ])
    tmax[n_cam::5] = 0.0  # dead lanes, as the integrator masks them
    return o, d, tmax.contiguous()


def phase_kernel_vs_twin(dev):
    import torch

    from pbrt_tpu_torch.ops.smallscene import (
        STATS, smallscene_intersect, smallscene_intersect_ref,
    )
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(256, 256))
    scene = scene.with_accel().to(dev)
    camera = camera.to(dev)
    o, d, tmax = _k1_rays(scene, camera, dev)
    result = {}
    for any_hit in (False, True):
        got = smallscene_intersect(scene.small, o, d, tmax, any_hit=any_hit)
        want = smallscene_intersect_ref(scene.small, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        mode = "any_hit" if any_hit else "closest"
        diff = {k: int((got[k] != want[k]).sum()) for k in want}
        err = max_abs_err(got, want)
        if any(diff.values()):
            raise AssertionError(f"K1 {mode} differs from its twin: {diff}")
        result[mode] = {"rays": int(o.shape[0]), "hits": int((want["prim"] >= 0).sum()),
                        "mismatches": diff, "max_abs_err": err}
    STATS.reset()
    ms = cuda_ms(lambda: smallscene_intersect(scene.small, o, d, tmax), reps=20)
    ms_any = cuda_ms(
        lambda: smallscene_intersect(scene.small, o, d, tmax, any_hit=True), reps=20
    )
    plain_ms = cuda_ms(lambda: smallscene_intersect_ref(scene.small, o, d, tmax), reps=3)
    STATS.reset()
    # Bound of the timed closest call: every ray tests every row (K1 has
    # no culling); 28 B of ray in, 36 B of hit out, the table once.
    n, rows = int(o.shape[0]), scene.small.n_tris
    bound = _bound(n * rows * MT_OPS, n * (28 + 36) + rows * 64)
    emit("c_kernel_vs_twin", **result, ms_closest=ms, ms_any_hit=ms_any,
         plain_ms_closest=plain_ms, tests=n * rows, **bound)
    err = max(r["max_abs_err"] for r in result.values())
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}


def _bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 rate and the bytes over the HBM rate."""
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms}


def killeroo_on(dev):
    """The killeroo-class scene (clusters attached) and its 512x512 camera
    on the card: (scene, camera, build seconds)."""
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    t0 = time.perf_counter()
    scene, camera = killeroo_class_scene(resolution=(PASS_RES, PASS_RES))
    scene, camera = scene.to(dev), camera.to(dev)
    return scene, camera, time.perf_counter() - t0


def _k2_ray_kinds(scene, camera, dev, n):
    """n rays of each kind the killeroo path sends to K2, as (o, d, tmax)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.accel.dense import offset_ray_origin, shadow_segment
    from pbrt_tpu_torch.core.sampling import sample_cosine_hemisphere
    from pbrt_tpu_torch.core.vecmath import coordinate_system, from_local
    from pbrt_tpu_torch.render import camera_rays_full

    rng = np.random.default_rng(1)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    inf = torch.full((n,), float("inf"), device=dev)
    kinds = {}
    npix = camera.resolution[0] * camera.resolution[1]
    pixel = t(rng.integers(0, npix, n)).long()
    o_cam, d_cam, _, _ = camera_rays_full(camera, pixel, 0, 0)
    kinds["camera"] = (o_cam, d_cam, inf)

    # Points on the mesh, with their winding normals.
    verts = scene.geom.tri_verts
    tri = t(rng.integers(0, verts.shape[0], n)).long()
    b = t(rng.dirichlet((1.0, 1.0, 1.0), n))
    tv = verts[tri]
    p = (b[:, 0:1] * tv[:, 0] + b[:, 1:2] * tv[:, 1] + b[:, 2:3] * tv[:, 2])
    ng = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    ng = ng / torch.linalg.norm(ng, dim=-1, keepdim=True)
    side = t(rng.choice([-1.0, 1.0], (n, 1)))
    ns = ng * side
    t1, t2 = coordinate_system(ns)
    wi = from_local(sample_cosine_hemisphere(t(rng.uniform(0, 1, (n, 2)))),
                    t1, t2, ns)
    kinds["cosine"] = (offset_ray_origin(p, ng, wi), wi, inf)

    lo = torch.amin(verts.reshape(-1, 3), dim=0)
    hi = torch.amax(verts.reshape(-1, 3), dim=0)
    o_box = lo + (hi - lo) * t(rng.uniform(0, 1, (n, 3)))
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    kinds["axis"] = (o_box, t(axes * rng.choice([-1.0, 1.0], (n, 1))), inf)

    d_dead = t(rng.normal(size=(n, 3)))
    d_dead = d_dead / torch.linalg.norm(d_dead, dim=-1, keepdim=True)
    kinds["dead"] = (o_box.flip(0).contiguous(), d_dead, torch.zeros_like(inf))

    # NEE shadow segments from the mesh points: light selection is
    # uniform over [area, area, infinite], so u < 0.66 picks an area
    # triangle and u > 0.67 the infinite light.
    lam = torch.full((n, 1), 550.0, device=dev)
    u_pos = t(rng.uniform(0, 1, (n, 2)))
    for name, u_sel in (("shadow_area", rng.uniform(0.0, 0.66, n)),
                        ("shadow_infinite", rng.uniform(0.67, 1.0, n))):
        ls = scene.lights.sample_li(p, lam, t(u_sel), u_pos)
        so, wi_sh, smax = shadow_segment(p, ng, ls.wi, ls.dist)
        kinds[name] = (so, wi_sh, smax)
    # dist = inf rides through shadow_segment as a 1e30 segment.
    assert bool((kinds["shadow_infinite"][2] == 1e30).all())
    assert bool(torch.isfinite(kinds["shadow_area"][2]).all())
    return {k: tuple(x.contiguous() for x in v) for k, v in kinds.items()}


def _per_kind(label, got, want, names, kind_of) -> dict:
    """Mismatches of a kernel's outputs against its twin's and the twin's
    hits, per ray kind (kind_of[i] is the index in names of ray i); raises
    on any mismatch or on differing keys."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {set(got)} vs {set(want)}")
    per_kind = {}
    for i, name in enumerate(names):
        sel = kind_of == i
        per_kind[name] = {
            "mismatches": {k: int((got[k][sel] != want[k][sel]).sum())
                           for k in want},
            "hits": int((want["prim"][sel] >= 0).sum()),
        }
    bad = {n: pk["mismatches"] for n, pk in per_kind.items()
           if any(pk["mismatches"].values())}
    if bad:
        raise AssertionError(f"{label} differs from its twin: {bad}")
    return per_kind


def phase_k2_vs_twin(dev, killeroo):
    """K2 against its twin on every ray kind, then timed at the main path's
    shape (1,048,576 sorted rays)."""
    import torch

    from pbrt_tpu_torch.accel.api import ray_sort_perm
    from pbrt_tpu_torch.ops.cluster import (
        cluster_intersect, cluster_intersect_ref,
    )

    scene, camera, build_s = killeroo
    acc = scene.clusters
    kinds = _k2_ray_kinds(scene, camera, dev, K2_SAMPLE)
    names = list(kinds)
    o = torch.cat([kinds[k][0] for k in names])
    d = torch.cat([kinds[k][1] for k in names])
    tmax = torch.cat([kinds[k][2] for k in names])
    perm, inv = ray_sort_perm(o, d, tmax)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    kind_of = torch.arange(len(names), device=dev).repeat_interleave(
        K2_SAMPLE)[perm]
    modes = {"closest": dict(any_hit=False),
             "any_hit": dict(any_hit=True),
             "closest_attrs": dict(any_hit=False, defer_attrs=False)}
    result, err = {}, 0.0
    for mode, kw in modes.items():
        got = cluster_intersect(acc, o, d, tmax, **kw)
        torch.cuda.synchronize()
        counts = {}
        t0 = time.perf_counter()
        want = cluster_intersect_ref(acc, o, d, tmax, counts=counts, **kw)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        per_kind = _per_kind("K2 " + mode, got, want, names, kind_of)
        err = max(err, max_abs_err(got, want))
        result[mode] = {"rays": int(o.shape[0]), "per_kind": per_kind,
                        "twin_seconds": twin_s, **counts}
    emit("c2_k2_vs_twin", scene_build_seconds=build_s,
         n_clusters=acc.n_clusters, n_supers=acc.n_supers, max_abs_err=err,
         **result)
    return _k2_timed(scene, camera, dev)


def _pass_batches(scene, camera, dev, sort: bool = True):
    """The query batches of one 512x512, 4 spp pass at the main path's
    shape: its 1,048,576 camera rays (closest) and their NEE shadow rays
    (any-hit, with the path's dead lanes: origin 1e8, tmax 0), each sorted
    as the K2 / K3 path sorts them (sort=False: as the BVH tier sends them,
    unsorted). Returns ({mode: (o, d, tmax)}, the unsorted camera (o, d,
    tmax), the camera rays' hit prims)."""
    import torch

    from pbrt_tpu_torch.accel.api import closest, ray_sort_perm
    from pbrt_tpu_torch.accel.dense import shadow_segment
    from pbrt_tpu_torch.render import camera_rays_full

    n = PASS_RAYS
    npix = PASS_RES * PASS_RES
    pixel = torch.arange(npix, device=dev).repeat(PASS_SPP)
    sample = torch.arange(PASS_SPP, device=dev).repeat_interleave(npix)
    o, d, _, _ = camera_rays_full(camera, pixel, sample, 0)
    tmax = torch.full((n,), float("inf"), device=dev)
    perm = ray_sort_perm(o, d, tmax)[0] if sort else slice(None)
    rays = {"closest": (o[perm].contiguous(), d[perm].contiguous(),
                        tmax[perm].contiguous())}
    isect = closest(scene, o, d, tmax)
    gen = torch.Generator(device=dev).manual_seed(0)
    ls = scene.lights.sample_li(
        isect.p, torch.full((n, 1), 550.0, device=dev),
        torch.rand(n, device=dev, generator=gen),
        torch.rand((n, 2), device=dev, generator=gen),
    )
    so, wi, smax = shadow_segment(isect.p, isect.n, ls.wi, ls.dist)
    smax = torch.where(isect.valid, smax, 0.0)  # dead lanes, as the path sends
    so = torch.where(isect.valid[:, None], so, 1e8)
    perm_s = ray_sort_perm(so, wi, smax)[0] if sort else slice(None)
    rays["any_hit"] = (so[perm_s].contiguous(), wi[perm_s].contiguous(),
                       smax[perm_s].contiguous())
    return rays, (o, d, tmax), isect.prim


def live_lane_order(o, d, tmax):
    """The batch keyed by ray_sort_perm over its live lanes only (tmax >
    0), the dead lanes after them in their order: (o, d, tmax, perm). Not
    the path's order (its key spans the dead lanes' origins too): a
    diagnostic of what that sort costs the kernels."""
    import torch

    from pbrt_tpu_torch.accel.api import ray_sort_perm

    live = torch.nonzero(tmax > 0).squeeze(1)
    dead = torch.nonzero(tmax <= 0).squeeze(1)
    perm = torch.cat([live[ray_sort_perm(o[live], d[live], tmax[live])[0]],
                      dead])
    return (o[perm].contiguous(), d[perm].contiguous(),
            tmax[perm].contiguous(), perm)


def _timed_vs_twin(intersect, intersect_ref, stats, acc, rays, cost) -> dict:
    """Time a kernel's wrapper `intersect` and its twin `intersect_ref`
    (both returning dicts of outputs) on each batch of `rays`; the kernel
    must equal the twin on every output. `stats` is the kernel's launch
    counter; cost(counts) gives the batch's (operations, bytes, fields to
    report) from the twin's work counts, for the bound. The any-hit batch
    is also timed in live_lane_order, where the kernel's answers must be
    the same answers permuted."""
    import torch

    out = {}
    for mode, (ro, rd, rt) in rays.items():
        any_hit = mode == "any_hit"
        stats.reset()
        ms = cuda_ms(lambda: intersect(acc, ro, rd, rt, any_hit=any_hit),
                     reps=10)
        got = intersect(acc, ro, rd, rt, any_hit=any_hit)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = intersect_ref(acc, ro, rd, rt, any_hit=any_hit, counts=counts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if set(got) != set(want) or bad:
            raise AssertionError(f"{intersect.__name__} {mode} at "
                                 f"{ro.shape[0]} rays differs from its twin "
                                 f"in {bad or sorted(set(got) ^ set(want))}")
        ops, nbytes, fields = cost(counts)
        bound = _bound(ops, nbytes)
        out[mode] = {"ms": ms, "plain_ms": plain_ms, **counts, **fields,
                     "hits": int((want["prim"] >= 0).sum()),
                     "live": int((rt > 0).sum()), "mismatched_keys": bad,
                     "max_abs_err": max_abs_err(got, want), **bound,
                     "share_reached": bound["bound_ms"] / ms}
        if any_hit:
            lo, ld, lt, perm = live_lane_order(ro, rd, rt)
            out[mode]["live_order_ms"] = cuda_ms(
                lambda: intersect(acc, lo, ld, lt, any_hit=True), reps=10)
            got_live = intersect(acc, lo, ld, lt, any_hit=True)
            bad = [k for k in want if not torch.equal(got_live[k], got[k][perm])]
            if bad:
                raise AssertionError(f"{intersect.__name__} any-hit in live-lane "
                                     f"order differs in {bad}")
    stats.reset()
    return out


def _k2_timed(scene, camera, dev):
    """K2, its twin, ray_sort_perm and resolve_tri_attrs at the main path's
    shape (_pass_batches)."""
    from pbrt_tpu_torch.accel.api import ray_sort_perm, resolve_tri_attrs
    from pbrt_tpu_torch.ops import cluster

    acc = scene.clusters
    rays, (o, d, tmax), prim = _pass_batches(scene, camera, dev)
    out = {"rays": PASS_RAYS,
           "ray_sort_perm_ms": cuda_ms(lambda: ray_sort_perm(o, d, tmax), reps=10),
           "resolve_tri_attrs_ms": cuda_ms(
               lambda: resolve_tri_attrs(scene.geom, o, d, prim), reps=10)}

    out.update(_timed_vs_twin(cluster.cluster_intersect,
                              cluster.cluster_intersect_ref, cluster.STATS,
                              acc, rays, _k2_cost(acc, PASS_RAYS)))
    emit("c2_k2_timed", **out)
    return out


def _k2_cost(acc, n_rays: int):
    """K2's cost(counts) for _timed_vs_twin on a batch of n_rays."""
    def cost(counts):
        # 128 triangle tests per (ray, cluster) pair left after per-ray
        # culling; 28 B of ray in, 8 B of (t, prim) out, and the ten
        # triangle planes and the boxes read once.
        return (counts["pairs"] * 128 * MT_OPS,
                n_rays * (28 + 8) + acc.n_clusters * 128 * 10 * 4
                + (acc.n_clusters + acc.n_supers) * 32,
                {"tests": counts["pairs"] * 128})

    return cost


def phase_k2_hall_vs_twin(dev, hall):
    """c5: K2 against its twin on every query of one pass of e8's
    configuration (the hall at 256x256, 8 spp, depth 4, power sampler),
    as the path sends them: bit-equal key by key, kernel and twin timed.
    The launches are counted from zero over that pass."""
    from pbrt_tpu_torch.ops import cluster

    res, k, depth = 256, 8, 4
    scene, camera, _ = hall["power"]
    scene, camera = scene.to(dev), camera.to(dev)
    acc = scene.clusters
    cluster.STATS.reset()
    queries = _pass_queries(scene, camera, res, k, "cluster_intersect",
                            depth=depth)
    launches = cluster.STATS.launches
    if launches != 2 * depth + 1 or len(queries) != launches:
        raise AssertionError(f"hall pass: {launches} K2 launches, "
                             f"{len(queries)} queries captured")
    per_query = {}
    for name, (o, d, tmax, any_hit) in queries.items():
        mode = "any_hit" if any_hit else "closest"
        per_query[name] = {"mode": mode, "rays": int(o.shape[0]),
                           **_timed_vs_twin(
                               cluster.cluster_intersect,
                               cluster.cluster_intersect_ref, cluster.STATS,
                               acc, {mode: (o, d, tmax)},
                               _k2_cost(acc, int(o.shape[0])))[mode]}
    ms = sum(q["ms"] for q in per_query.values())
    emit("c5_k2_hall_vs_twin", triangles=int(scene.geom.tri_verts.shape[0]),
         n_clusters=acc.n_clusters, n_supers=acc.n_supers,
         resolution=res, spp=k, max_depth=depth, launches=launches,
         ms_per_pass=ms,
         plain_ms_per_pass=sum(q["plain_ms"] for q in per_query.values()),
         bound_ms_per_pass=sum(q["bound_ms"] for q in per_query.values()),
         max_abs_err=max(q["max_abs_err"] for q in per_query.values()),
         queries=per_query)


# FP32 operations of K3's world-to-object move per (ray, entered instance):
# the origin's 9 multiplies and 9 adds (the direction's 15 operations are
# left out, so the bound stays a lower bound).
XFORM_OPS = 18
K3_SAMPLE_RES = 16  # the pass whose every K3 query is held against the twin


def field_on(dev):
    """The instanced field on the card: its PLY prototypes written into a
    temporary directory, then the file parsed there by the port's parser.
    Returns (scene, camera, settings, mesh seconds, load seconds)."""
    import tempfile

    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt_string
    from tests.torch_port_instanced import field_text, write_field_meshes

    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        t0 = time.perf_counter()
        write_field_meshes("pbrt_tpu_torch", tmp)
        t1 = time.perf_counter()
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return scene, camera, settings, t1 - t0, t2 - t1


def _pass_queries(scene, camera, res: int, k: int, launcher: str,
                  depth: int = 5):
    """Every query that one res x res, k spp forward pass (8 lanes, depth
    `depth`) sends to accel.api's `launcher` (sweep_intersect or
    cluster_intersect), as the path sends it: sorted rays, tmax and mode,
    in the order sent (camera, then per bounce a shadow and a bounce
    query, then the terminal one). The queries still launch the kernel."""
    from pbrt_tpu_torch.accel import api

    queries = []
    launch = getattr(api, launcher)

    def capture(acc, o, d, tmax, any_hit=False, **kw):
        queries.append((o.clone(), d.clone(), tmax.clone(), any_hit))
        return launch(acc, o, d, tmax, any_hit=any_hit, **kw)

    setattr(api, launcher, capture)
    try:
        make_pass(scene, camera.replace(resolution=(res, res)), res, k, 8,
                  depth=depth)(0)
    finally:
        setattr(api, launcher, launch)
    names, bounce = [], 0
    for _, _, _, any_hit in queries:
        if any_hit:
            bounce += 1
            names.append(f"shadow{bounce}")
        else:
            names.append("camera" if not names else f"bounce{bounce}")
    names[-1] = "terminal"
    return dict(zip(names, queries))


def phase_k3_vs_twin(dev, field, killeroo):
    """K3 against its twin on every query of a small pass, for the
    instanced field and for the killeroo-class scene under
    with_accel(kind="sweep"); then at the main path's shape."""
    import torch

    from pbrt_tpu_torch.ops.sweep import sweep_intersect, sweep_intersect_ref

    result, err = {}, 0.0
    scenes = {"instanced_field": (field[0], field[1]),
              "killeroo_sweep": (killeroo[0].with_accel(kind="sweep"),
                                 killeroo[1])}
    for label, (scene, camera) in scenes.items():
        acc = scene.sweep
        per_query = {}
        for name, (o, d, tmax, any_hit) in _pass_queries(
                scene, camera, K3_SAMPLE_RES, 4, "sweep_intersect").items():
            got = sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
            counts = {}
            want = sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit,
                                       counts=counts)
            torch.cuda.synchronize()
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            if set(got) != set(want) or bad:
                raise AssertionError(f"K3 {label} {name} differs from its "
                                     f"twin in {bad}")
            err = max(err, max_abs_err(got, want))
            per_query[name] = {"rays": int(o.shape[0]),
                               "live": int((tmax > 0).sum()),
                               "hits": int((want["prim"] >= 0).sum()),
                               **counts}
        result[label] = {"instances": acc.n_instances,
                         "entries": acc.n_entries, "queries": per_query}
    emit("c3_k3_vs_twin", max_abs_err=err, **result)
    return _k3_timed(field[0], field[1], dev)


def _k3_timed(scene, camera, dev):
    """K3 and its twin at the main path's shape (_pass_batches) on the
    instanced field."""
    from pbrt_tpu_torch.ops import sweep

    acc = scene.sweep
    rays, _, _ = _pass_batches(scene, camera, dev)

    def cost(counts):
        # 128 triangle tests per (ray, cluster) pair and one move into
        # object space per (ray, instance) entered, after per-ray culling;
        # 28 B of ray in, 12 B of (t, prim, inst) out, and the ten triangle
        # planes, the boxes and the instance rows read once.
        return (counts["pairs"] * 128 * MT_OPS + counts["instances"] * XFORM_OPS,
                PASS_RAYS * (28 + 12) + acc.n_clusters * (128 * 10 * 4 + 32)
                + acc.n_instances * (12 + 8 + 2) * 4,
                {"tests": counts["pairs"] * 128})

    out = {"rays": PASS_RAYS,
           **_timed_vs_twin(sweep.sweep_intersect, sweep.sweep_intersect_ref,
                            sweep.STATS, acc, rays, cost)}
    emit("c3_k3_timed", **out)
    return out


def bvh_scene_of(killeroo, dev):
    """The killeroo-class scene on the BVH tier alone, on the card (the
    reference's attachment: the other tiers dropped, build_bvh over the
    triangles), and the seconds of build_bvh (K4's packed rows included)
    and the upload."""
    import torch

    from pbrt_tpu_torch.accel.bvh import build_bvh

    scene = killeroo[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bvh = build_bvh(scene.geom.tri_verts.cpu().numpy())
    scene = scene.replace(small=None, clusters=None, bvh=bvh).to(dev)
    torch.cuda.synchronize()
    return scene, time.perf_counter() - t0


def pack_seconds(bvh) -> float:
    """Seconds of packing K4's rows once more from `bvh`'s tables on the
    host, as build_bvh does (a report of that share of the build)."""
    from pbrt_tpu_torch.accel.bvh import pack_rows

    cpu = bvh.to("cpu")
    t0 = time.perf_counter()
    pack_rows(cpu)
    return time.perf_counter() - t0


_K4_KEYS = ("t", "prim", "u", "v")


def _k4_as_dict(fn):
    """A K4 entry point (returning (t, prim, u, v)) returning a dict."""
    def call(bvh, o, d, tmax, **kwargs):
        return dict(zip(_K4_KEYS, fn(bvh, o, d, tmax, **kwargs)))
    call.__name__ = fn.__name__
    return call


def phase_k4_vs_twin(dev, killeroo):
    """K4 against its twin on every ray kind of c2, unsorted as the BVH
    tier sends them, then timed at the main path's shape."""
    import torch

    from pbrt_tpu_torch.ops import traverse

    scene, build_s = bvh_scene_of(killeroo, dev)
    bvh, camera = scene.bvh, killeroo[1]
    kinds = _k2_ray_kinds(scene, camera, dev, K2_SAMPLE)
    names = list(kinds)
    o, d, tmax = (torch.cat([kinds[k][i] for k in names]) for i in range(3))
    kind_of = torch.arange(len(names), device=dev).repeat_interleave(K2_SAMPLE)
    intersect = _k4_as_dict(traverse.bvh_intersect)
    intersect_ref = _k4_as_dict(traverse.bvh_intersect_ref)
    result, err = {}, 0.0
    for mode in ("closest", "any_hit"):
        any_hit = mode == "any_hit"
        got = intersect(bvh, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        counts = {}
        t0 = time.perf_counter()
        want = intersect_ref(bvh, o, d, tmax, any_hit=any_hit, counts=counts)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        per_kind = _per_kind("K4 " + mode, got, want, names, kind_of)
        err = max(err, max_abs_err(got, want))
        result[mode] = {"rays": int(o.shape[0]), "per_kind": per_kind,
                        "twin_seconds": twin_s, **counts}
    emit("c4_k4_vs_twin", bvh_build_seconds=build_s, depth=bvh.depth,
         nodes=int(bvh.node_lo.shape[0]), slots=int(bvh.prim_id.shape[0]),
         constants=traverse.constants(bvh.depth), max_abs_err=err, **result)

    # The 1,048,576 camera rays of one pass and their shadow rays.
    rays, _, _ = _pass_batches(scene, camera, dev, sort=False)
    n_nodes, n_slots = bvh.node_lo.shape[0], bvh.prim_id.shape[0]

    def cost(counts):
        # K4's slab tests (each ray's root, each child of an inner visit),
        # its near/far comparisons and the leaf triangle tests, from the
        # twin's counts (the walks visit the same nodes and leaves); 28 B of
        # ray in, 16 B of (t, prim, u, v) out, the packed node and triangle
        # rows read once.
        nbytes = PASS_RAYS * (28 + 16) + n_nodes * 32 + n_slots * 48
        ops = ((PASS_RAYS + counts["entries"]) * BOX_OPS
               + counts["entries"] // 2 * PAIR_OPS + counts["tris"] * MT_OPS)
        twin_ops = (counts["nodes"] * BOX_OPS + counts["entries"] * ENTRY_OPS
                    + counts["tris"] * MT_OPS)
        twin = _bound(twin_ops, nbytes)
        return ops, nbytes, {"ops": ops, "twin_walk_ops": twin_ops,
                             "twin_walk_bound_ms": twin["bound_ms"]}

    out = _timed_vs_twin(intersect, intersect_ref, traverse.STATS, bvh, rays,
                         cost)
    for res in out.values():
        res["twin_walk_share_reached"] = res["twin_walk_bound_ms"] / res["ms"]
        res["nodes_per_live_ray"] = res["nodes"] / max(res["live"], 1)
        res["tris_per_live_ray"] = res["tris"] / max(res["live"], 1)
    out["rays"] = PASS_RAYS
    emit("c4_k4_timed", **out)
    return out


def _golden_gate(img, golden):
    """d's gate: the share of pixel values within rtol 1e-3 / atol 1e-5."""
    import numpy as np

    if img.shape != golden.shape or not np.all(np.isfinite(img)):
        raise AssertionError(f"bad render: shape {img.shape}, finite "
                             f"{bool(np.all(np.isfinite(img)))}")
    diff = np.abs(img - golden)
    ok = diff <= 1e-5 + 1e-3 * np.abs(golden)
    share = float(np.mean(ok))
    return share, {"share_within": share, "outliers": int(np.sum(~ok)),
                   "values": int(ok.size),
                   "largest_abs_diff": sorted(diff.ravel().tolist())[-5:],
                   "mean": float(img.mean()),
                   "golden_mean": float(golden.mean())}


def phase_golden(dev):
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    golden = np.load(GOLDEN)
    scene, camera = cornell_box(resolution=(32, 32))
    spp, per_pass = 16, 4
    STATS.reset()
    img = render(scene.with_accel(), camera, PathIntegrator(max_depth=5),
                 spp=spp, seed=0, samples_per_pass=per_pass, n_spectrum=32,
                 device=dev)
    torch.cuda.synchronize()
    launches = STATS.launches
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d_golden", **fields, launches=launches, passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if launches != 11 * (spp // per_pass):
        raise AssertionError(f"{launches} K1 launches for {spp // per_pass} passes")


def phase_golden_killeroo(dev, killeroo):
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render

    golden = np.load(GOLDEN_KILLEROO)
    scene, camera, _ = killeroo
    spp = per_pass = 4
    smallscene.STATS.reset()
    cluster.STATS.reset()
    img = render(scene, camera.replace(resolution=(64, 64)),
                 PathIntegrator(max_depth=5), spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=8, device=dev)
    torch.cuda.synchronize()
    k1, k2 = smallscene.STATS.launches, cluster.STATS.launches
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d2_golden_killeroo", **fields, k2_launches=k2, k1_launches=k1,
         passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if k2 != 11 * (spp // per_pass) or k1 != 0:
        raise AssertionError(f"{k2} K2 and {k1} K1 launches for "
                             f"{spp // per_pass} passes")


def phase_golden_instanced(dev, field):
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import cluster, smallscene, sweep
    from pbrt_tpu_torch.render import render

    golden = np.load(GOLDEN_INSTANCED)
    scene, camera, settings = field[:3]
    spp = per_pass = 4
    for counter in (smallscene.STATS, cluster.STATS, sweep.STATS):
        counter.reset()
    img = render(scene, camera.replace(resolution=(64, 64)),
                 settings["integrator"], spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=8, device=dev)
    torch.cuda.synchronize()
    k1, k2, k3 = (c.STATS.launches for c in (smallscene, cluster, sweep))
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d3_golden_instanced", **fields, k3_launches=k3, k2_launches=k2,
         k1_launches=k1, passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if k3 != 11 * (spp // per_pass) or k1 or k2:
        raise AssertionError(f"{k3} K3, {k2} K2 and {k1} K1 launches for "
                             f"{spp // per_pass} passes")


def phase_golden_bvh(dev, killeroo):
    """The killeroo-class scene on the BVH tier alone against the killeroo
    golden: the closest hits are the same surfaces whichever tier finds
    them."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import cluster, smallscene, sweep, traverse
    from pbrt_tpu_torch.render import render

    golden = np.load(GOLDEN_KILLEROO)
    scene, _ = bvh_scene_of(killeroo, dev)
    spp = per_pass = 4
    counters = (smallscene.STATS, cluster.STATS, sweep.STATS, traverse.STATS)
    for counter in counters:
        counter.reset()
    img = render(scene, killeroo[1].replace(resolution=(64, 64)),
                 PathIntegrator(max_depth=5), spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=8, device=dev)
    torch.cuda.synchronize()
    k1, k2, k3, k4 = (c.launches for c in counters)
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d4_golden_bvh", **fields, k4_launches=k4, k3_launches=k3,
         k2_launches=k2, k1_launches=k1, passes=spp // per_pass)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if k4 != 11 * (spp // per_pass) or k1 or k2 or k3:
        raise AssertionError(f"{k4} K4, {k3} K3, {k2} K2 and {k1} K1 launches "
                             f"for {spp // per_pass} passes")


def _downsample(img, f=4):
    h, w, c = img.shape
    return img[: h // f * f, : w // f * f].reshape(
        h // f, f, w // f, f, c).mean(axis=(1, 3))


def _cxx_errors(img, name):
    """(relative mean error, MSE, q95 cell error, the golden) of a host
    image of tests/goldens/<name>.pbrt against its pbrt-v4 C++ golden."""
    import numpy as np

    from pbrt_tpu_torch.io.image import read_pfm

    ref = read_pfm(os.path.join(GOLDEN_FILES, name + "_ref.pfm"))
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"bad render: shape {img.shape}, finite "
                             f"{bool(np.isfinite(img).all())}")
    rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    mse = float(np.mean((img - ref) ** 2))
    a, b = _downsample(img), _downsample(ref)
    q95 = float(np.quantile(np.abs(a - b) / (np.abs(b) + 0.05 * ref.mean()),
                            0.95))
    return rel, mse, q95, ref


def phase_golden_cxx(dev, phase, name, spp, per_pass, bounds, kernel):
    """A golden scene file through the port's parser on the card against
    the pbrt-v4 C++ golden (4096 spp), with
    tests/test_reference_parity.py's gate and this file's bounds there:
    relative mean error, MSE and the 95th percentile of the 4x4-cell
    relative error. `kernel` ("k1" or "k2") must launch."""
    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render

    rel_tol, mse_tol, q95_tol = bounds
    counter = {"k1": smallscene.STATS, "k2": cluster.STATS}[kernel]
    scene, camera, settings = load_pbrt(
        os.path.join(GOLDEN_FILES, name + ".pbrt"), device=dev)
    counter.reset()
    t0 = time.perf_counter()
    img = render(scene, camera, settings["integrator"], spp=spp,
                 samples_per_pass=per_pass, sampler_kind="independent",
                 device=dev)
    img = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    rel, mse, q95, ref = _cxx_errors(img, name)
    emit(phase, spheres=scene.geom.num_spheres,
         triangles=scene.geom.num_triangles, lights=scene.lights.n_lights,
         spp=spp, samples_per_pass=per_pass, seconds=seconds,
         rel_mean_err=rel, mse=mse, q95_cell_rel_err=q95,
         mean=float(img.mean()), golden_mean=float(ref.mean()),
         **{f"{kernel}_launches": counter.launches},
         bounds={"rel_mean_err": rel_tol, "mse": mse_tol,
                 "q95_cell_rel_err": q95_tol})
    torch.cuda.synchronize()
    if not (rel < rel_tol and mse < mse_tol and q95 < q95_tol):
        raise AssertionError(f"{name}.pbrt off the C++ golden: rel {rel}, "
                             f"MSE {mse}, q95 {q95}")
    if counter.launches == 0:
        raise AssertionError(f"{name}.pbrt launched no {kernel.upper()}")


def phase_furnace(dev):
    """d11: the furnace on the card against its closed form, as the
    reference's tests/test_integrator.py gates it: a point light I = pi
    at the centre of a diffuse unit sphere of albedo 0.5 gives radiance 1
    at every wavelength. The scene has no triangles; the sphere block
    answers every query and no triangle kernel launches."""
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import camera_rays
    from pbrt_tpu_torch.scenes.analytic import furnace_sphere_scene

    res, spp, depth, lanes = 64, 4, 16, 32
    scene, camera = furnace_sphere_scene(resolution=(res, res))
    scene, camera = scene.to(dev), camera.to(dev)
    integrator = PathIntegrator(max_depth=depth, rr_start_depth=100)
    pixel = torch.arange(res * res, device=dev)
    smallscene.STATS.reset()
    cluster.STATS.reset()
    total = 0.0
    for s in range(spp):
        o, d, wl = camera_rays(camera, pixel, s, 0, n_spectrum=lanes)
        L = integrator.trace(scene, o, d, wl, pixel, s, 0)
        if not bool(torch.isfinite(L).all()):
            raise AssertionError("furnace: non-finite radiance")
        total += float(L.mean())
    mean = total / spp
    launches = smallscene.STATS.launches + cluster.STATS.launches
    emit("d11_furnace", resolution=res, spp=spp, max_depth=depth,
         lanes=lanes, mean_radiance=mean, expected=1.0, tolerance=0.025,
         triangle_kernel_launches=launches)
    if abs(mean - 1.0) >= 0.025 or launches:
        raise AssertionError(f"furnace mean {mean}, {launches} launches")


def phase_golden_files_jax(dev, phase, files):
    """d12 and d17: golden files (name, kernel) on the card against the
    JAX goldens, with d's gate; each pass makes 2 x depth + 1 queries, all
    on the file's triangle kernel."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render

    counters = {"k1": smallscene.STATS, "k2": cluster.STATS}
    for name, kernel in files:
        golden = np.load(os.path.join(ROOT, "tests", "data", "torch_port",
                                      f"{name}32_spp4.npy"))
        scene, camera, settings = load_pbrt(
            os.path.join(GOLDEN_FILES, name + ".pbrt"), device=dev)
        for counter in counters.values():
            counter.reset()
        img = render(scene, camera.replace(resolution=(32, 32)),
                     settings["integrator"], spp=4, samples_per_pass=4,
                     seed=0, n_spectrum=8, device=dev)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        share, fields = _golden_gate(img.cpu().numpy(), golden)
        want = 2 * settings["integrator"].max_depth + 1
        emit(phase, file=name + ".pbrt", **fields,
             **{f"{k}_launches": n for k, n in launches.items()},
             expected_launches={kernel: want})
        if share < 0.99:
            raise AssertionError(f"{name}: only {share:.4f} of pixel values "
                                 "match the JAX golden")
        if launches != {k: (want if k == kernel else 0) for k in counters}:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} {kernel.upper()}")


def phase_golden_kdtree(dev):
    """The Cornell box with only the kd-tree attached against the Cornell
    golden (32x32, 16 spp, 32 lanes)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import smallscene
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    golden = np.load(GOLDEN)
    scene, camera = cornell_box(resolution=(32, 32))
    scene = scene.replace(small=None).with_kdtree()
    spp, per_pass = 16, 4
    smallscene.STATS.reset()
    t0 = time.perf_counter()
    img = render(scene, camera, PathIntegrator(max_depth=5), spp=spp, seed=0,
                 samples_per_pass=per_pass, n_spectrum=32, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d6_golden_kdtree", **fields, kd_nodes=scene.kdtree.n_nodes,
         seconds=seconds, k1_launches=smallscene.STATS.launches)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of pixel values match the golden")
    if smallscene.STATS.launches:
        raise AssertionError("the kd-tree render launched K1")


def make_pass(scene, camera, res: int, k: int, lanes: int, depth: int = 5,
              sorted_shading="auto", integrator=None, sampler=0, filt=None):
    """One forward pass at a bench configuration: k samples per pixel over
    res x res, `lanes` wavelengths, depth `depth`, no Russian roulette,
    the integrator's sorted_shading (or the given integrator), the
    independent sampler of seed 0 and the box filter unless `sampler` (a
    samplers.Sampler) and `filt` (a filters.Filter) say otherwise; the
    camera weight (the filter's sign weight, and a lens camera's 0 where
    vignetted) weighs every sample, as in render(). Returns
    render_pass(pass_idx) -> (mean RGB image, traced rays)."""
    import torch

    # Module attributes are looked up at each call, so a profiler that
    # wraps them (scripts/profile_torch_pass.py) sees the camera and film.
    from pbrt_tpu_torch import render as render_mod
    from pbrt_tpu_torch.films import rgb as film_mod
    from pbrt_tpu_torch.models.path import PathIntegrator

    dev = scene.geom.tri_verts.device
    if integrator is None:
        integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth,
                                    sorted_shading=sorted_shading)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)

    def render_pass(pass_idx: int = 0):
        sample_b = torch.arange(
            pass_idx * k, (pass_idx + 1) * k, device=dev
        ).repeat_interleave(npix)
        o, d, wl, w = render_mod.camera_rays_full(
            camera, pixel_b, sample_b, sampler, filt=filt, n_spectrum=lanes)
        radiance, stats = integrator.trace_with_stats(
            scene, o, d, wl, pixel_b, sample_b, sampler
        )
        rgb = film_mod.spectrum_to_rgb(radiance, wl) * w[:, None]
        return torch.mean(rgb.reshape(k, res, res, 3), dim=0), stats["rays"]

    return render_pass


def timed_forward(render_pass, n_passes: int, stats: dict) -> dict:
    """Time n_passes calls of an already warmed-up render_pass. `stats`
    maps a kernel name to its launch counter, whose launches and CUDA-event
    milliseconds over the timed passes are read back. Raises on a
    non-finite image."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in stats.values():
        counter.reset(timed=True)
    t0 = time.perf_counter()
    acc, rays = None, None
    for p in range(n_passes):
        img, r = render_pass(p)
        acc = img if acc is None else acc + img
        rays = r if rays is None else rays + r
    total_rays = float(rays)  # synchronizes
    seconds = time.perf_counter() - t0
    out = {"passes": n_passes, "rays": total_rays, "seconds": seconds,
           "mrays_per_s": total_rays / seconds / 1e6,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "image_mean": float(acc.mean() / n_passes)}
    for name, counter in stats.items():
        ms = counter.elapsed_ms()
        out.update({f"{name}_launches": counter.launches, f"{name}_ms": ms,
                    f"{name}_share": ms / (seconds * 1e3)})
        counter.reset()
    if not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"timed forward: non-finite image, {out}")
    return out


def phase_timed_killeroo(dev, build_seconds: float):
    """The killeroo-class forward render at its benchmark configuration
    (bench.py killeroo_fwd: 512x512, 8 spp in passes of 4, depth 5, no
    Russian roulette, 8 lanes), timed on the card, with the first pass's
    seconds from the scene build on and the ray sorts' share."""
    import torch

    from pbrt_tpu_torch.accel import api
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    res, spp, k, lanes = PASS_RES, 8, PASS_SPP, 8

    # First pass, from the scene build on (Morton sort and cluster build
    # included; the kernel was built in phase b). It is the warm-up.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, camera = killeroo_class_scene(resolution=(res, res))
    scene, camera = scene.to(dev), camera.to(dev)
    render_pass = make_pass(scene, camera, res, k, lanes)
    render_pass(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # Time the ray sorts with CUDA events around each call.
    sort_events = []
    ray_sort_perm = api.ray_sort_perm

    def timed_sort(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = ray_sort_perm(*args, **kwargs)
        ev[1].record()
        sort_events.append(ev)
        return out

    api.ray_sort_perm = timed_sort
    try:
        out = timed_forward(render_pass, spp // k,
                            {"k1": smallscene.STATS, "k2": cluster.STATS})
    finally:
        api.ray_sort_perm = ray_sort_perm
    k1, k2 = out["k1_launches"], out["k2_launches"]
    if k2 == 0 or k1 != 0:
        raise AssertionError(f"timed killeroo: K2 launches={k2} K1 launches={k1}")
    sort_ms = sum(a.elapsed_time(b) for a, b in sort_events)
    emit("e2_timed_killeroo", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, **out,
         first_pass_seconds=first_s,
         first_pass_with_build_seconds=first_s + build_seconds,
         k2_ms_per_launch=out["k2_ms"] / k2, sorts=len(sort_events),
         sort_ms=sort_ms, sort_share=sort_ms / (out["seconds"] * 1e3))
    return k2


def phase_timed_instanced(dev, mesh_seconds: float):
    """The instanced-field forward render at its file's configuration
    (512x512, 8 spp) in passes of 4, depth 5 without Russian roulette, 8
    lanes, timed on the card, with the first image's seconds from the parse
    on (the kernels were built in phase b)."""
    import tempfile

    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt_string
    from pbrt_tpu_torch.ops import cluster, smallscene, sweep
    from tests.torch_port_instanced import field_text, write_field_meshes

    k, lanes = PASS_SPP, 8
    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene, camera, settings = load_pbrt_string(field_text(), tmp,
                                                   device=dev)
        res, _ = camera.resolution
        spp = settings["spp"]
        render_pass = make_pass(scene, camera, res, k, lanes,
                                depth=settings["integrator"].max_depth)
        render_pass(0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    out = timed_forward(render_pass, spp // k,
                        {"k1": smallscene.STATS, "k2": cluster.STATS,
                         "k3": sweep.STATS})
    k1, k2, k3 = out["k1_launches"], out["k2_launches"], out["k3_launches"]
    if k3 == 0 or k1 or k2:
        raise AssertionError(f"timed instanced field: K3 launches={k3} K2 "
                             f"launches={k2} K1 launches={k1}")
    emit("e3_timed_instanced", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=settings["integrator"].max_depth,
         **out, first_image_seconds=first_s,
         first_image_with_meshes_seconds=first_s + mesh_seconds,
         k3_ms_per_launch=out["k3_ms"] / k3,
         instances=scene.sweep.n_instances, entries=scene.sweep.n_entries)
    return k3


def phase_timed_bvh(dev):
    """The killeroo-class forward render on the BVH tier alone at e2's
    configuration, timed on the card; the first pass's seconds from
    build_bvh on (upload included; K4 was built in phase b)."""
    import torch

    from pbrt_tpu_torch.ops import cluster, smallscene, sweep, traverse
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene

    res, spp, k, lanes = PASS_RES, 8, PASS_SPP, 8
    t0 = time.perf_counter()
    killeroo = killeroo_class_scene(resolution=(res, res))
    scene_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, bvh_s = bvh_scene_of(killeroo, dev)
    render_pass = make_pass(scene, killeroo[1].to(dev), res, k, lanes)
    render_pass(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = timed_forward(render_pass, spp // k,
                        {"k1": smallscene.STATS, "k2": cluster.STATS,
                         "k3": sweep.STATS, "k4": traverse.STATS})
    k1, k2, k3, k4 = (out[f"k{i}_launches"] for i in (1, 2, 3, 4))
    if k4 == 0 or k1 or k2 or k3:
        raise AssertionError(f"timed BVH tier: K4 launches={k4} K3={k3} "
                             f"K2={k2} K1={k1}")
    emit("e4_timed_bvh", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, **out,
         first_pass_seconds=first_s, bvh_build_seconds=bvh_s,
         bvh_pack_seconds=pack_seconds(scene.bvh),
         scene_build_seconds=scene_s,
         k4_ms_per_launch=out["k4_ms"] / k4, depth=scene.bvh.depth)
    return k4


def phase_timed_plymesh(dev, smi: str):
    """e5: plymesh.pbrt (a point and a uniform infinite light, K2) timed on
    the card at 512x512, 8 spp in passes of 4, 8 lanes, the file's depth 4
    without Russian roulette, seed 0; then one more pass with CUDA events
    around each layer's top-level calls (scripts/profile_torch_pass.py's
    wrappers; intersect_* are accel.api's closest and any_hit)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene

    res, spp, k, lanes = PASS_RES, 8, PASS_SPP, 8
    scene, camera, settings = load_pbrt(
        os.path.join(GOLDEN_FILES, "plymesh.pbrt"), device=dev)
    depth = settings["integrator"].max_depth
    render_pass = make_pass(scene, camera.replace(resolution=(res, res)), res,
                            k, lanes, depth=depth)
    render_pass(0)  # warm-up
    passes = spp // k
    out = timed_forward(render_pass, passes,
                        {"k1": smallscene.STATS, "k2": cluster.STATS})
    if out["k2_launches"] != passes * (2 * depth + 1) or out["k1_launches"]:
        raise AssertionError(f"timed plymesh: {out['k2_launches']} K2 and "
                             f"{out['k1_launches']} K1 launches")
    view = ptp.layer_view(lanes, render_pass)
    layers = {key.replace("k1_", "intersect_"): ms
              for key, ms in view["layers_ms"].items()}
    emit("e5_timed_plymesh", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=depth, **out,
         k2_launches_per_pass=out["k2_launches"] / passes,
         layer_pass_wall_ms=view["wall_ms"], layers_ms=layers,
         lights_ms=layers["lights"], bxdf_ms=layers["bxdf"],
         lights_over_bxdf=layers["lights"] / layers["bxdf"],
         nvidia_smi=smi)


def phase_timed_gallery(dev, smi: str):
    """e6: the mesh gallery (a copper icosphere, a smooth glass torus, a
    diffuse icosphere, a floor, a quad area light and a uniform infinite
    light; 15,620 triangles at subdiv 4: K2) timed on the card at 512x512,
    8 spp in passes of 4, depth 5 without Russian roulette, 8 lanes, seed
    0; then one pass with the layers' CUDA events (e5's), the BxDF layer
    carrying the dielectric branch."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.scenes.meshes import mesh_gallery_scene

    res, spp, k, lanes, depth = PASS_RES, 8, PASS_SPP, 8, 5
    scene, camera = mesh_gallery_scene(resolution=(res, res), subdiv=4)
    scene, camera = scene.to(dev), camera.to(dev)
    if scene.clusters is None or 2 not in scene.shaded_kinds:
        raise AssertionError("mesh gallery: no cluster tier or no glass")
    render_pass = make_pass(scene, camera, res, k, lanes, depth=depth)
    render_pass(0)  # warm-up
    passes = spp // k
    out = timed_forward(render_pass, passes,
                        {"k1": smallscene.STATS, "k2": cluster.STATS})
    if out["k2_launches"] != passes * (2 * depth + 1) or out["k1_launches"]:
        raise AssertionError(f"timed mesh gallery: {out['k2_launches']} K2 "
                             f"and {out['k1_launches']} K1 launches")
    view = ptp.layer_view(lanes, render_pass)
    layers = {key.replace("k1_", "intersect_"): ms
              for key, ms in view["layers_ms"].items()}
    emit("e6_timed_gallery", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=depth, **out,
         triangles=scene.geom.num_triangles,
         k2_launches_per_pass=out["k2_launches"] / passes,
         layer_pass_wall_ms=view["wall_ms"], layers_ms=layers,
         bxdf_ms=layers["bxdf"], lights_ms=layers["lights"], nvidia_smi=smi)


def _texture_layer(render_pass):
    """The texture layer of one pass: CUDA-event milliseconds around each
    call of textures.buffers.evaluate_albedo_coeffs (the per-ray fit
    included), and the CUDA kernel launches made inside those calls,
    counted from a torch.profiler trace of a second pass ("not measured"
    where the trace holds no launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.textures import buffers as tex

    fn = tex.evaluate_albedo_coeffs
    timer = ptp.LayerTimer()
    tex.evaluate_albedo_coeffs = timer.wrap("textures", fn)
    try:
        render_pass()
        torch.cuda.synchronize()
    finally:
        tex.evaluate_albedo_coeffs = fn
    ms = timer.totals_ms().get("textures", 0.0)
    calls = len(timer.events["textures"])

    def marked(*args, **kwargs):
        with record_function("texture_layer"):
            return fn(*args, **kwargs)

    tex.evaluate_albedo_coeffs = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render_pass()
            torch.cuda.synchronize()
    finally:
        tex.evaluate_albedo_coeffs = fn
    # The raw kineto events (prof.events() builds a Python event and its
    # tree for each, tens of seconds for a pass's 1e5 launches).
    try:
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()]
    spans = [(a, b) for name, a, b in events if name == "texture_layer"]
    launches = sum(
        1 for name, start, _ in events
        if name in _LAUNCH_CALLS and any(a <= start <= b for a, b in spans))
    return {"texture_ms": ms, "texture_calls": calls,
            "texture_launches": launches if launches else "not measured"}


def phase_timed_texture(dev, smi: str):
    """e7: tests/goldens/texture.pbrt (a checkerboard floor, a scaled
    checkerboard sphere, a point and a distant light; K1) through the
    port's parser, its resolution raised from 64x64 to 512x512, timed on
    the card: 8 spp in passes of 4, the file's depth 4 without Russian
    roulette, 8 lanes, seed 0; then the texture layer of one pass (its
    milliseconds and kernel launches) and e5's layers."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene

    res, spp, k, lanes = PASS_RES, 8, PASS_SPP, 8
    scene, camera, settings = load_pbrt(
        os.path.join(GOLDEN_FILES, "texture.pbrt"), device=dev)
    depth = settings["integrator"].max_depth
    if scene.textures is None or scene.small is None:
        raise AssertionError("texture.pbrt: no textures or no K1 table")
    render_pass = make_pass(scene, camera.replace(resolution=(res, res)), res,
                            k, lanes, depth=depth)
    render_pass(0)  # warm-up
    passes = spp // k
    out = timed_forward(render_pass, passes,
                        {"k1": smallscene.STATS, "k2": cluster.STATS})
    if out["k1_launches"] != passes * (2 * depth + 1) or out["k2_launches"]:
        raise AssertionError(f"timed texture.pbrt: {out['k1_launches']} K1 "
                             f"and {out['k2_launches']} K2 launches")
    layer = _texture_layer(render_pass)
    view = ptp.layer_view(lanes, render_pass)
    emit("e7_timed_texture", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=depth, **out,
         k1_launches_per_pass=out["k1_launches"] / passes, **layer,
         texture_share_of_pass=layer["texture_ms"] / view["wall_ms"],
         layer_pass_wall_ms=view["wall_ms"], layers_ms=view["layers_ms"],
         nvidia_smi=smi)


def phase_timed(dev, lanes: int):
    """The Cornell forward render at its benchmark configuration (bench.py
    cornell_fwd: 256x256, 128 spp in passes of 64, depth 5, no Russian
    roulette), timed on the card."""
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    res, spp, k = 256, 128, 64
    scene, camera = cornell_box(resolution=(res, res))
    render_pass = make_pass(scene.with_accel().to(dev), camera.to(dev),
                            res, k, lanes)
    render_pass(0)  # warm-up
    out = timed_forward(render_pass, spp // k, {"k1": STATS})
    if out["k1_launches"] == 0:
        raise AssertionError(f"timed Cornell forward launched no K1: {out}")
    emit("e_timed_forward", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, **out)
    return out["k1_launches"]


def grad_passes(scene, camera, res: int, k: int, lanes: int, passes: int,
                depth: int = 5, target: float = 0.25):
    """bench.py's cornell_fwdbwd loss (the mean squared error of
    spectrum_to_rgb against `target`) and its gradients with respect to
    the default trainable set, through parallel.train.render_loss_and_grad,
    one call per pass of k samples per pixel over res x res, depth `depth`
    without Russian roulette. Returns (mean loss, {path: mean gradient})."""
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.parallel.train import render_loss_and_grad

    dev = scene.geom.tri_verts.device
    integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)
    tgt = torch.full((npix * k, 3), target, device=dev)
    camera = camera.replace(resolution=(res, res)).to(dev)
    loss, grads = 0.0, {}
    for p in range(passes):
        sample_b = torch.arange(p * k, (p + 1) * k,
                                device=dev).repeat_interleave(npix)
        pl, pg = render_loss_and_grad(scene, camera, integrator, pixel_b, tgt,
                                      sample_b, 0, n_spectrum=lanes)
        loss = loss + pl
        for name, g in pg.items():
            grads[name] = grads.get(name, 0.0) + g
    return (float(loss) / passes,
            {name: (g / passes).cpu().double().numpy()
             for name, g in grads.items()})


# Phase g's tolerance: each gradient within 1e-3 of its tensor's largest
# magnitude, and the loss within a relative 1e-4.
GRAD_RTOL_OF_MAX = 1e-3
LOSS_RTOL = 1e-4


def _grad_compare(loss, grads, want_loss, want) -> dict:
    """Errors of (loss, grads) against (want_loss, want), gated at phase
    g's tolerance; rows of `want` that are exactly 0 must be 0."""
    import numpy as np

    out = {"loss_rel_err": abs(loss - want_loss) / abs(want_loss)}
    ok = out["loss_rel_err"] <= LOSS_RTOL
    for name, g in grads.items():
        w = np.asarray(want[name], np.float64)
        scale = float(np.max(np.abs(w)))
        err = np.abs(g - w)
        out[name] = {"max_abs_err": float(err.max()),
                     "max_rel_err_of_max": float(err.max()) / scale,
                     "exact_zeros_kept": bool(np.all(g[w == 0.0] == 0.0))}
        ok &= bool(np.all(np.isfinite(g))) and float(err.max()) <= \
            GRAD_RTOL_OF_MAX * scale and out[name]["exact_zeros_kept"]
    out["ok"] = bool(ok)
    return out


def phase_grad_golden(dev):
    """g: the Cornell gradient golden. The bench's loss and its gradients
    on the card against the JAX reference's
    (tests/data/torch_port/cornell32_grad.npz, scripts/
    make_torch_port_golden_grad.py) and against the port's own CPU pass,
    with 11 K1 launches per forward+backward pass."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    z = np.load(GOLDEN_GRAD)
    res, k, lanes = int(z["resolution"]), int(z["samples_per_pass"]), \
        int(z["n_spectrum"])
    passes, depth = int(z["spp"]) // k, int(z["max_depth"])
    if int(z["rr_start_depth"]) != depth:
        raise AssertionError("the golden's Russian roulette is not off")
    want = {"materials.albedo_coeffs": z["grad_albedo_coeffs"],
            "lights.area_scale": z["grad_area_scale"]}
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel()
    STATS.reset()
    loss, grads = grad_passes(scene.to(dev), camera, res, k, lanes, passes,
                              depth)
    torch.cuda.synchronize()
    launches = STATS.launches
    cpu_loss, cpu_grads = grad_passes(scene, camera, res, k, lanes, passes,
                                      depth)
    vs_jax = _grad_compare(loss, grads, float(z["loss"]), want)
    vs_cpu = _grad_compare(loss, grads, cpu_loss, cpu_grads)
    emit("g_grad_golden", resolution=res, spp=int(z["spp"]),
         samples_per_pass=k, lanes=lanes, loss=loss,
         golden_loss=float(z["loss"]), cpu_loss=cpu_loss,
         grad_area_scale=grads["lights.area_scale"].tolist(),
         vs_jax=vs_jax, vs_cpu=vs_cpu, k1_launches=launches, passes=passes,
         tolerance={"grad_of_max": GRAD_RTOL_OF_MAX, "loss_rel": LOSS_RTOL})
    if not (vs_jax["ok"] and vs_cpu["ok"]):
        raise AssertionError("card gradients disagree with the golden or "
                             "the CPU pass")
    if launches != 11 * passes:
        raise AssertionError(f"{launches} K1 launches for {passes} "
                             "forward+backward passes")


# Phase g2's tolerance between the cluster and the BVH tier: the same
# surfaces, found by another walk (t and u, v within a few ulps).
TIER_RTOL_OF_MAX = 1e-3


def phase_grad_killeroo(dev, killeroo):
    """g2: the bench's loss and gradients on the killeroo-class scene,
    64x64, 2 spp in one pass, 8 lanes, on the cluster tier (K2) and on the
    BVH tier (K4): finite on each, the tiers in agreement, and 11 launches
    of the tier's kernel per forward+backward pass."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import cluster, smallscene, sweep, traverse

    counters = {"k1": smallscene.STATS, "k2": cluster.STATS,
                "k3": sweep.STATS, "k4": traverse.STATS}
    res, k, lanes = 64, 2, 8
    out = {}
    for tier, scene, kernel in (
            ("cluster", killeroo[0], "k2"),
            ("bvh", bvh_scene_of(killeroo, dev)[0], "k4")):
        for c in counters.values():
            c.reset()
        loss, grads = grad_passes(scene, killeroo[1], res, k, lanes, 1)
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        out[tier] = (loss, grads)
        finite = bool(np.isfinite(loss)) and all(
            bool(np.all(np.isfinite(g))) for g in grads.values())
        emit("g2_grad_killeroo", tier=tier, resolution=res, spp=k,
             lanes=lanes, loss=loss, finite=finite,
             grads={name: g.tolist() for name, g in grads.items()},
             launches=launches)
        if not finite:
            raise AssertionError(f"killeroo gradients on the {tier} tier are "
                                 "not finite")
        if launches[kernel] != 11 or sum(launches.values()) != 11:
            raise AssertionError(f"{tier} tier: launches {launches}, want 11 "
                                 f"of {kernel} alone")
    (la, ga), (lb, gb) = out["cluster"], out["bvh"]
    errs = {name: float(np.max(np.abs(ga[name] - gb[name])))
            / float(np.max(np.abs(ga[name]))) for name in ga}
    loss_err = abs(la - lb) / abs(la)
    emit("g2_tiers_agree", loss_rel_err=loss_err, grad_err_of_max=errs,
         tolerance=TIER_RTOL_OF_MAX)
    if loss_err > TIER_RTOL_OF_MAX or max(errs.values()) > TIER_RTOL_OF_MAX:
        raise AssertionError("the cluster and BVH tiers' gradients disagree")


# g3's tolerance: the card's gradient within 1e-5 of the largest entry of
# the CPU pass's.
SPOT_GRAD_RTOL_OF_MAX = 1e-5
# g4's: 1e-6 of the largest entry.
SPHERES_GRAD_RTOL_OF_MAX = 1e-6


def phase_grad_file(dev, phase, name, tol):
    """g3, g4: the bench loss's gradient through delta lights. spot.pbrt
    and spheres.pbrt have no area light, so lights.area_scale is empty and
    its gradient too; the lights' sample_li branches run inside the
    checkpointed segments, and in spheres.pbrt the diffuse rows are also
    seen through the smooth glass sphere's delta lobes. The card's albedo
    gradient against the port's CPU pass, within `tol` of its largest
    entry."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops.smallscene import STATS

    scene, camera, settings = load_pbrt(
        os.path.join(GOLDEN_FILES, name + ".pbrt"), device="cpu")
    res, k, lanes = 16, 2, 8
    depth = settings["integrator"].max_depth
    STATS.reset()
    loss, grads = grad_passes(scene.to(dev), camera, res, k, lanes, 1, depth)
    torch.cuda.synchronize()
    launches = STATS.launches
    cpu_loss, cpu_grads = grad_passes(scene, camera, res, k, lanes, 1, depth)
    g = grads["materials.albedo_coeffs"]
    w = cpu_grads["materials.albedo_coeffs"]
    scale = float(np.max(np.abs(w)))
    err = float(np.max(np.abs(g - w)))
    area = grads["lights.area_scale"]
    emit(phase, file=name + ".pbrt", resolution=res, spp=k, lanes=lanes,
         max_depth=depth, loss=loss, cpu_loss=cpu_loss,
         grad_albedo_max=scale, max_abs_err=err,
         max_rel_err_of_max=err / scale if scale else None,
         area_scale_grad_shape=list(area.shape), k1_launches=launches,
         tolerance={"grad_of_max": tol})
    if not (np.all(np.isfinite(g)) and scale > 0.0 and err <= tol * scale):
        raise AssertionError(f"{name}.pbrt gradients: error {err} of the "
                             f"largest {scale}")
    if area.shape != (0,) or launches != 2 * depth + 1:
        raise AssertionError(f"{name}.pbrt: area-scale gradient "
                             f"{area.shape}, {launches} K1 launches")


def make_grad_pass(scene, camera, res: int, k: int, lanes: int,
                   depth: int = 5, target: float = 0.25, integrator=None,
                   leaves=("materials.albedo_coeffs", "lights.area_scale")):
    """bench.py's cornell_fwdbwd pass on the scene's device: k samples per
    pixel over res x res, `lanes` wavelengths, depth `depth` without
    Russian roulette (or the given integrator). Returns (grad_pass,
    forward_pass): grad_pass(pass_idx, events=None) -> (loss, grads), the
    loss's value and gradient with respect to `leaves` (albedo_coeffs and
    area_scale by default), appending CUDA events (start, forward done,
    backward done) to `events` if given and calling mark() after the
    forward and after the backward, the forward and the backward inside
    profiler ranges "forward" and "backward";
    forward_pass(pass_idx) -> (rgb, traced rays) under torch.no_grad()."""
    import torch

    from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.parallel.train import _get_path, _set_paths
    from pbrt_tpu_torch.render import camera_rays

    dev = scene.geom.tri_verts.device
    if integrator is None:
        integrator = PathIntegrator(max_depth=depth, rr_start_depth=depth)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)
    tgt = torch.full((npix * k, 3), target, device=dev)
    values = [_get_path(scene, name) for name in leaves]

    def samples(p):
        return torch.arange(p * k, (p + 1) * k,
                            device=dev).repeat_interleave(npix)

    def grad_pass(p, events=None, mark=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        params = [x.detach().requires_grad_(True) for x in values]
        s = _set_paths(scene, dict(zip(leaves, params)))
        sb = samples(p)
        o, d, wl = camera_rays(camera, pixel_b, sb, 0, n_spectrum=lanes)
        with torch.profiler.record_function("forward"):
            rgb = spectrum_to_rgb(
                integrator.trace(s, o, d, wl, pixel_b, sb, 0), wl)
            loss = torch.mean((rgb - tgt) ** 2)
        ev[1].record()
        if mark is not None:
            mark()
        with torch.profiler.record_function("backward"):
            # A leaf the loss does not read (a mix amount) gets zeros, and
            # so do leaves none of which it reads (a medium's majorants).
            grads = (torch.autograd.grad(loss, params, allow_unused=True,
                                         materialize_grads=True)
                     if loss.requires_grad
                     else [torch.zeros_like(x) for x in params])
        ev[2].record()
        if mark is not None:
            mark()
        if events is not None:
            events.append(ev)
        return loss.detach(), grads

    def forward_pass(p):
        with torch.no_grad():
            sb = samples(p)
            o, d, wl = camera_rays(camera, pixel_b, sb, 0, n_spectrum=lanes)
            radiance, stats = integrator.trace_with_stats(
                scene, o, d, wl, pixel_b, sb, 0)
            return spectrum_to_rgb(radiance, wl), stats["rays"]

    return grad_pass, forward_pass


def phase_timed_fwdbwd(dev, smi: str):
    """e_timed_fwdbwd: bench.py's cornell_fwdbwd_8lane (256x256, 16 spp,
    bench's 64 cut, in passes of 2, depth 5, no Russian roulette, 8 lanes, the loss's value
    and gradient with respect to albedo_coeffs and area_scale), timed on
    the card. Mrays/s as bench.py counts it: a forward pass's traced rays
    per pass over the forward+backward wall time; beside it the forward
    alone at the same shape, the backward's share of the wall (CUDA
    events around the backward calls), K1 launches per pass and peak
    memory."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    res, spp, k, lanes = 256, 16, 2, 8
    passes = spp // k
    scene, camera = cornell_box(resolution=(res, res))
    grad_pass, forward_pass = make_grad_pass(
        scene.with_accel().to(dev), camera.to(dev), res, k, lanes)
    rays_pass = float(forward_pass(0)[1])  # bench.py's count_pass; warm-up
    grad_pass(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    events = []
    t0 = time.perf_counter()
    acc = None
    for p in range(passes):
        loss, grads = grad_pass(p, events)
        acc = loss if acc is None else acc + loss
    acc = float(acc)  # synchronizes
    seconds = time.perf_counter() - t0
    launches = STATS.launches
    peak = torch.cuda.max_memory_allocated()
    bwd_ms = sum(b.elapsed_time(c) for _, b, c in events)
    if launches != 11 * passes:
        raise AssertionError(f"{launches} K1 launches in {passes} "
                             "forward+backward passes")
    if not all(bool(torch.isfinite(g).all()) for g in grads) or acc != acc:
        raise AssertionError("timed forward+backward: non-finite loss or "
                             "gradient")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rays = None
    for p in range(passes):
        _, r = forward_pass(p)
        rays = r if rays is None else rays + r
    fwd_rays = float(rays)  # synchronizes
    fwd_seconds = time.perf_counter() - t0
    emit("e_timed_fwdbwd", lanes=lanes, resolution=res, spp=spp,
         samples_per_pass=k, max_depth=5, passes=passes,
         rays_per_pass=rays_pass, seconds=seconds,
         mrays_per_s=rays_pass * passes / seconds / 1e6,
         forward_seconds=fwd_seconds,
         forward_mrays_per_s=fwd_rays / fwd_seconds / 1e6,
         forward_peak_bytes=torch.cuda.max_memory_allocated(),
         backward_ms=bwd_ms, backward_share=bwd_ms / (seconds * 1e3),
         k1_launches=launches, k1_launches_per_pass=launches / passes,
         peak_bytes=peak, mean_loss=acc / passes, nvidia_smi=smi)
    return launches


def phase_train(dev):
    """t_train: three training_steps (lr 1e-2) of the default trainable set
    on the Cornell box, 64x64, 2 spp, 8 lanes, against a flat 0.25 target:
    each step's loss finite, and every parameter finite and moved."""
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.parallel.train import (
        DEFAULT_TRAINABLE,
        _get_path,
        training_step,
    )
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    res, k, lanes, lr = 64, 2, 8, 1e-2
    scene, camera = cornell_box(resolution=(res, res))
    scene = scene.with_accel().to(dev)
    npix = res * res
    pixel_b = torch.arange(npix, device=dev).repeat(k)
    sample_b = torch.arange(k, device=dev).repeat_interleave(npix)
    target = torch.full((npix * k, 3), 0.25, device=dev)
    integrator = PathIntegrator(max_depth=5, rr_start_depth=5)
    start = {p: _get_path(scene, p).clone() for p in DEFAULT_TRAINABLE}
    losses = []
    for _ in range(3):
        loss, scene = training_step(scene, camera, integrator, pixel_b,
                                    target, sample_b, 0, lr=lr,
                                    n_spectrum=lanes)
        losses.append(float(loss))
    moved = {p: float(torch.max(torch.abs(_get_path(scene, p) - x)))
             for p, x in start.items()}
    finite = all(bool(torch.isfinite(_get_path(scene, p)).all())
                 for p in start) and all(x == x for x in losses)
    on_card = all(_get_path(scene, p).device.type == "cuda" for p in start)
    emit("t_train", resolution=res, spp=k, lanes=lanes, lr=lr, losses=losses,
         max_move=moved, finite=finite, on_card=on_card)
    if not finite or min(moved.values()) <= 0.0 or not on_card:
        raise AssertionError("training steps: non-finite, unmoved or moved "
                             "off the card")


GRAD_MODES_FILE = os.path.join(ROOT, "tests", "data", "torch_port",
                               "grad_modes16.npz")
FAMILIES_GRAD_FILE = os.path.join(ROOT, "tests", "data", "torch_port",
                                  "families16_grad.npz")


def _k1_split(scene, camera, integrator, leaves, res: int, k: int) -> dict:
    """K1 launches of one forward+backward pass of the bench loss, counted
    from zero before it: in the forward, in the backward, and in the
    primal (no_grad) trace of the same pass."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    camera = camera.replace(resolution=(res, res)).to(
        scene.geom.tri_verts.device)
    grad_pass, forward_pass = make_grad_pass(
        scene, camera, res, k, 8, integrator=integrator, leaves=leaves)
    marks = []
    STATS.reset()
    grad_pass(0, mark=lambda: marks.append(STATS.launches))
    torch.cuda.synchronize()
    STATS.reset()
    forward_pass(0)
    torch.cuda.synchronize()
    primal = STATS.launches
    STATS.reset()
    return {"forward": marks[0], "backward": marks[1] - marks[0],
            "primal": primal}


def _grad_vs_golden(phase, scene, camera, integrator, leaves, res, k,
                    want_loss, want, **fields):
    """The bench loss and its gradients with respect to `leaves` on the
    card (parallel.train.render_loss_and_grad, one pass), gated against
    (want_loss, want) at phase g's tolerance (tests/torch_port_grad.py);
    zero K1 launches in the backward and as many in the forward as in the
    primal. Returns (loss, grads, K1 launches of the loss and gradient
    call)."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from tests.torch_port_grad import grad_errors, pass_loss_and_grads

    STATS.reset()
    loss, grads = pass_loss_and_grads(scene, camera, integrator, leaves,
                                      res, k)
    torch.cuda.synchronize()
    launches = STATS.launches
    split = _k1_split(scene, camera, integrator, leaves, res, k)
    errs = grad_errors(loss, grads, want_loss, want)
    emit(phase, resolution=res, spp=k, lanes=8,
         max_depth=integrator.max_depth,
         estimator=integrator.estimator(scene), loss=loss,
         golden_loss=want_loss, vs_jax=errs, k1_launches=launches,
         k1_split=split, tolerance={"grad_of_max": GRAD_RTOL_OF_MAX,
                                    "loss_rel": LOSS_RTOL}, **fields)
    if not errs["ok"]:
        raise AssertionError(f"{phase}: gradients disagree with the JAX "
                             f"golden: {errs}")
    if split["backward"] != 0 or split["forward"] != split["primal"] \
            or launches != split["primal"]:
        raise AssertionError(f"{phase}: K1 launches {split}, {launches} in "
                             "the loss and gradient call")
    return loss, grads, launches


def _modes_golden(dev, name: str):
    """(scene on the card, camera, golden file) of grad_modes16.npz's
    textured ("texel") or dielectric box."""
    import numpy as np

    from tests import torch_port_grad as tg

    z = np.load(GRAD_MODES_FILE)
    res = int(z["resolution"])
    build = tg.texel_cornell if name == "texel" else tg.dielectric_cornell
    scene, camera = build(res)
    return scene.with_accel().to(dev), camera, z


def phase_grad_texel(dev) -> int:
    """g8: the textured Cornell box (a 4x4 image texture on material 0;
    16x16, 2 spp, depth 5, 8 lanes) under the default estimator: the bench
    loss's gradients with respect to albedo_coeffs, area_scale and
    textures.img_flat (the texel gathers through core/take.py) against
    the JAX golden (grad_modes16.npz, "remat"), 11 K1 launches in the
    forward, 0 in the backward."""
    from pbrt_tpu_torch.models.path import PathIntegrator
    from tests.torch_port_grad import TEXEL_LEAVES, golden

    scene, camera, z = _modes_golden(dev, "texel")
    res, k = int(z["resolution"]), int(z["spp"])
    integ = PathIntegrator(max_depth=int(z["max_depth"]),
                           rr_start_depth=int(z["rr_start_depth"]))
    return _grad_vs_golden("g8_grad_texel", scene, camera, integ,
                           TEXEL_LEAVES, res, k,
                           *golden(z, "remat", TEXEL_LEAVES))[2]


def phase_grad_attached(dev) -> int:
    """g9: the Cornell box with material 1 a rough dielectric (roughness
    0.25, eta 1.5; 16x16, 2 spp, depth 5) under the attached estimator
    (replay_grad=False): albedo_coeffs, area_scale and materials.eta
    against the JAX golden (grad_modes16.npz, "attached": forward-mode,
    the reference's reverse mode being NaN on eta), 11 K1 launches in the
    forward, 0 in the backward."""
    from pbrt_tpu_torch.models.path import PathIntegrator
    from tests.torch_port_grad import ATTACHED_LEAVES, golden

    scene, camera, z = _modes_golden(dev, "dielectric")
    res, k = int(z["resolution"]), int(z["spp"])
    integ = PathIntegrator(max_depth=int(z["max_depth"]),
                           rr_start_depth=int(z["rr_start_depth"]),
                           replay_grad=False)
    return _grad_vs_golden("g9_grad_attached", scene, camera, integ,
                           ATTACHED_LEAVES, res, k,
                           *golden(z, "attached", ATTACHED_LEAVES))[2]


def phase_grad_cvjp(dev) -> int:
    """g10: the textured box of g8 under grad_mode="cvjp" with each
    replay_remat ("full", "dots", "none"): against the JAX golden of the
    same mode, and against the remat estimator's loss (bit-equal) and
    gradients (within phase g's tolerance) on the card; 11 K1 launches in
    the forward, 0 in the backward. Returns the K1 launches of the three
    loss and gradient calls."""
    import numpy as np

    from pbrt_tpu_torch.models.path import PathIntegrator
    from tests.torch_port_grad import (
        TEXEL_LEAVES,
        TEXEL_MODES,
        golden,
        grad_errors,
        pass_loss_and_grads,
    )

    scene, camera, z = _modes_golden(dev, "texel")
    res, k = int(z["resolution"]), int(z["spp"])
    depth, rr = int(z["max_depth"]), int(z["rr_start_depth"])
    remat_loss, remat = pass_loss_and_grads(
        scene, camera, PathIntegrator(max_depth=depth, rr_start_depth=rr),
        TEXEL_LEAVES, res, k)
    total = 0
    for mode, kw in TEXEL_MODES[1:]:
        integ = PathIntegrator(max_depth=depth, rr_start_depth=rr, **kw)
        loss, grads, launches = _grad_vs_golden(
            f"g10_grad_{mode}", scene, camera, integ, TEXEL_LEAVES, res, k,
            *golden(z, mode, TEXEL_LEAVES), replay_remat=kw["replay_remat"])
        total += launches
        vs_remat = grad_errors(loss, grads, remat_loss, remat)
        emit("g10_cvjp_vs_remat", replay_remat=kw["replay_remat"],
             loss_bit_equal=loss == remat_loss, vs_remat=vs_remat)
        if loss != remat_loss or not vs_remat["ok"] or not all(
                np.all(np.isfinite(g)) for g in grads.values()):
            raise AssertionError(f"cvjp {kw['replay_remat']}: against remat "
                                 f"{vs_remat}, loss {loss} vs {remat_loss}")
    return total


def phase_grad_families(dev) -> int:
    """g11: the families box (hair, subsurface, measured, mix and
    retroreflective surfaces; 16x16, 2 spp, depth 5, the mix hash on
    coarse keys) under its estimator (the attached one: it holds a
    subsurface block): albedo_coeffs and area_scale against the JAX golden
    (families16_grad.npz), 16 K1 launches in the forward (the subsurface
    probes among them), 0 in the backward."""
    import numpy as np

    from tests.torch_port_grad import DEFAULT_LEAVES, golden

    scene, camera, integ = families_on(dev)
    z = np.load(FAMILIES_GRAD_FILE)
    res, k = int(z["resolution"]), int(z["spp"])
    with coarse_mix_keys():
        return _grad_vs_golden("g11_grad_families", scene, camera, integ,
                               DEFAULT_LEAVES, res, k,
                               *golden(z, "families", DEFAULT_LEAVES))[2]


def phase_grad_leaves(dev) -> dict:
    """g12: the scene leaves of ROADMAP item 5e.1-5e.4 on the card: each
    scene of tests/torch_port_leaves.py's groups materials, textures,
    lights and media (at its golden's settings: 16x16, or 8x8 for the
    media, 2 spp, depth 5, 8 lanes, the bench loss, the scene's hash
    keys) under one estimator of its golden, the attached one where it
    has one (every leaf of the scene trains there), else remat, the
    media's differentiable volumetric path; against the JAX goldens of
    scripts/make_torch_port_golden_leaves.py: every gradient within g's
    tolerance of its golden's largest entry (a table held along the
    golden's probe directions), the loss within 1e-4, every entry
    finite; the triangle kernel's launches of the forward+backward pass
    counted from zero: 0 in the backward, and in the forward the
    primal's (`_primal_queries`) (K1; K2 on plymesh.pbrt's 1,282
    triangles). The other estimators are held on the CPU
    (tests/test_torch_grad_leaves.py) and card against CPU
    (tests/test_torch_cuda.py). Returns each kernel's launches in the
    forward passes."""
    from tests import torch_port_leaves as TL

    cases = []
    for group, name, ests, leaves in TL.CASES:
        if group in ("materials", "textures", "lights", "media"):
            est = ("attached" if "attached" in ests
                   else "remat" if "remat" in ests else ests[0])
            cases.append((group, name, est, leaves))
    return _grad_leaf_cases(dev, "g12_grad_leaves", cases, against_cpu=False)


def phase_grad_leaves_rest(dev) -> dict:
    """g13: the rest of item 5e on the card (tests/torch_port_leaves.py's
    groups volpath and sampling, 8x8 and 16x16, 2 spp): every case with a
    golden, g12's way, and against the same pass on the CPU as well
    (within g's tolerance of the CPU's largest entry; a zero gradient
    exactly zero): the fog box's slab and the families box in its medium
    with their surface, light and medium leaves, fog.pbrt's interior
    medium and the grid's max_density through the differentiable
    volumetric path (5e.5, 5e.7, 5e.8); envmap.pbrt's importance tables
    and leaf_lights.pbrt's selection pmf and cdf under remat and cvjp
    (5e.8); the 16-light hall's BVH node table under cvjp (5e.6). K1
    launches 0 in every backward and the primal's in every forward.
    Returns each kernel's launches in the forward passes."""
    from tests import torch_port_leaves as TL

    cases = [c for c in TL.cases(("volpath", "sampling"))
             if TL.answered(TL.golden(c[0]), f"{c[1]}_{c[2]}", c[3])]
    return _grad_leaf_cases(dev, "g13_grad_leaves_rest", cases,
                            against_cpu=True)


def _primal_queries(scene, est: str, depth: int) -> int:
    """Triangle-kernel launches of one primal pass at `depth`: the path
    integrator's closest and shadow query a bounce and the terminal
    closest, with the subsurface probe a third a bounce; the volumetric
    path's closest query a bounce, a shadow ray from the medium scatter
    point (where a medium exists) and one from the surface, each one
    any-hit or, with interior media, the interface walk's four closest
    queries, and the terminal closest with its transmittance's any-hit
    where a scene-level medium exists."""
    from pbrt_tpu_torch.materials.buffers import MAT_SUBSURFACE

    if est != "volpath":
        return (3 if MAT_SUBSURFACE in scene.shaded_kinds else 2) * depth + 1
    medium = scene.medium is not None and not scene.medium.is_none
    stack = scene.media_stack is not None
    shadow = 4 if stack else 1
    return (1 + shadow * (2 if medium or stack else 1)) * depth + 1 + medium


def leaf_scene_on(name: str, dev):
    """(scene on the card, the same on the CPU, camera) of a case of
    tests/torch_port_leaves.py: the families box, in its medium for
    "volfamilies", from families_on (its measured table fitted once),
    the others from their CPU build (TL.port_scene, once a process)."""
    from tests import torch_port_leaves as TL

    if name in ("families", "volfamilies"):
        scene, camera, _ = families_on(dev)
        if name == "volfamilies":
            scene = TL.in_medium("pbrt_tpu_torch", scene)
        return scene, scene.to("cpu"), camera
    cpu_scene, camera = TL.port_scene(name)
    return cpu_scene.to(dev), cpu_scene, camera


def _grad_leaf_cases(dev, phase: str, cases, against_cpu: bool) -> dict:
    """g12's and g13's check of each (group, scene, estimator, leaves)
    case on the card; returns each kernel's launches in the forwards."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import cluster, smallscene
    from tests import torch_port_leaves as TL
    from tests.torch_port_grad import grad_errors, pass_loss_and_grads

    launches = {"smallscene": 0, "cluster": 0}
    for group, name, est, leaves in cases:
        z = TL.golden(group)
        want = TL.answered(z, f"{name}_{est}", leaves)
        g = TL.settings_of(group)
        res, k, depth = g["resolution"], g["spp"], g["max_depth"]
        scene, cpu_scene, camera = leaf_scene_on(name, dev)
        camera = camera.replace(resolution=(res, res)).to(dev)
        integ = TL.integrator("pbrt_tpu_torch", est)
        kernel = "smallscene" if scene.small is not None else "cluster"
        counter = {"smallscene": smallscene.STATS,
                   "cluster": cluster.STATS}[kernel]
        primal = _primal_queries(scene, est, depth)
        marks = []
        with TL.keys("pbrt_tpu_torch", name):
            grad_pass, _ = make_grad_pass(scene, camera, res, k, 8,
                                          integrator=integ,
                                          leaves=tuple(want))
            counter.reset()
            loss, grads = grad_pass(
                0, mark=lambda: marks.append(counter.launches))
            torch.cuda.synchronize()
            counter.reset()
            loss = float(loss)
            grads = {p: x.detach().cpu().double().numpy()
                     for p, x in zip(want, grads)}
            vs_cpu = None
            if against_cpu:
                vs_cpu = grad_errors(loss, grads, *pass_loss_and_grads(
                    cpu_scene, camera.to("cpu"), integ, tuple(want), res, k))
        errs = TL.leaf_errors(want, grads)
        want_loss = float(z[f"{name}_{est}_loss"])
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        split = {"forward": marks[0], "backward": marks[1] - marks[0],
                 "primal": primal}
        ok = (errs["finite"] and loss_rel <= LOSS_RTOL
              and all(v <= GRAD_RTOL_OF_MAX for key, v in errs.items()
                      if key != "finite")
              and (vs_cpu is None or vs_cpu["ok"]))
        # A golden that is zero (by construction) is matched exactly.
        zero = sorted(p for p, (_, w) in want.items() if not np.any(w))
        ok = ok and not any(np.any(grads[p]) for p in zero)
        emit(phase, group=group, scene=name, estimator=est,
             resolution=res, spp=k, lanes=8, leaves=list(want),
             held_along_directions=[p for p, (w, _) in want.items()
                                    if w == "jvp"],
             zero_goldens=zero,
             loss=loss, golden_loss=want_loss, loss_rel_err=loss_rel,
             vs_jax=errs, vs_cpu=vs_cpu, kernel=kernel, launches=split,
             tolerance={"grad_of_max": GRAD_RTOL_OF_MAX,
                        "loss_rel": LOSS_RTOL})
        if not ok:
            raise AssertionError(f"{phase} {name} {est}: gradients disagree "
                                 f"with the JAX golden or the CPU: {errs}, "
                                 f"{vs_cpu}, loss {loss_rel}, zero {zero}")
        if split["backward"] != 0 or split["forward"] != primal:
            raise AssertionError(f"{phase} {name} {est}: {kernel} launches "
                                 f"{split}")
        launches[kernel] += split["forward"]
    return launches


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def _profiled_launches(grad_pass) -> dict:
    """CUDA kernel launches in the forward and in the backward of one more
    pass of `grad_pass`: two CUDA-only torch.profiler sessions, switched
    at the forward's end, counting the launch calls of each ("not
    measured" where a session holds none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sessions = [profile(activities=[ProfilerActivity.CUDA])
                for _ in range(2)]
    done = []

    def switch():
        torch.cuda.synchronize()
        sessions[len(done)].stop()
        done.append(True)
        if len(done) == 1:
            sessions[1].start()

    sessions[0].start()
    grad_pass(0, mark=switch)
    counts = []
    for prof in sessions:
        try:
            events = prof.profiler.kineto_results.events()
            n = sum(1 for e in events if e.name() in _LAUNCH_CALLS)
        except AttributeError:
            n = sum(1 for e in prof.events() if e.name in _LAUNCH_CALLS)
        counts.append(n if n else "not measured")
    return {"forward": counts[0], "backward": counts[1]}


# e15's and e17's shape: bench.py's cornell_fwdbwd_8lane resolution, and
# their timed passes (each after a profiled pass that warms it up).
ESTIMATOR_RES, ESTIMATOR_PASSES = 256, 1


def _timed_fwdbwd_config(phase, scene_name, mode, scene, cam, integ, leaves,
                         passes: int, smi: str, keys=None) -> dict:
    """One configuration of e15 / e17 at ESTIMATOR_RES with passes of 2
    spp and 8 lanes: fwd+bwd Mrays/s over `passes` passes (a forward
    pass's traced rays per pass over the wall time), the backward's share
    (CUDA events), peak device memory, CUDA kernel launches in the
    forward and in the backward (torch.profiler sessions over one more
    pass, before the timed ones: it warms the backward up), and K1
    launches in each timed pass (0 in the backward, the primal's in the
    forward), inside the context `keys` if given. Emits the phase's line
    and returns it."""
    import contextlib

    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    res, k, lanes = ESTIMATOR_RES, 2, 8
    with keys if keys is not None else contextlib.nullcontext():
        grad_pass, forward_pass = make_grad_pass(
            scene, cam, res, k, lanes, integrator=integ, leaves=leaves)
        STATS.reset()
        rays_pass = float(forward_pass(0)[1])  # warm-up
        primal = STATS.launches
        # The profiled pass warms the backward up too.
        launches = _profiled_launches(grad_pass)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        STATS.reset()
        events, marks = [], []
        t0 = time.perf_counter()
        acc = None
        for p in range(passes):
            loss, grads = grad_pass(
                p, events, mark=lambda: marks.append(STATS.launches))
            acc = loss if acc is None else acc + loss
        acc = float(acc)  # synchronizes
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        bwd_ms = sum(b.elapsed_time(c) for _, b, c in events)
        # Kernel launches of each forward (mark after it) and each backward.
        fwd = {marks[2 * i] - (marks[2 * i - 1] if i else 0)
               for i in range(passes)}
        bwd = {marks[2 * i + 1] - marks[2 * i] for i in range(passes)}
    finite = acc == acc and all(bool(torch.isfinite(g).all())
                                for g in grads)
    est = (integ.estimator(scene) if hasattr(integ, "estimator")
           else "volpath")
    line = dict(scene=scene_name, estimator=est,
                mode=mode, leaves=list(leaves), resolution=res,
                samples_per_pass=k, lanes=lanes, max_depth=integ.max_depth,
                passes=passes, rays_per_pass=rays_pass, seconds=seconds,
                mrays_per_s=rays_pass * passes / seconds / 1e6,
                backward_ms=bwd_ms, backward_share=bwd_ms / (seconds * 1e3),
                peak_bytes=peak, launches_forward=launches["forward"],
                launches_backward=launches["backward"],
                k1_launches_forward=max(fwd), k1_launches_backward=max(bwd),
                k1_launches_primal=primal, mean_loss=acc / passes,
                nvidia_smi=smi)
    emit(phase, **line)
    key = f"{scene_name}_{mode}"
    if not finite:
        raise AssertionError(f"{key}: non-finite loss or gradient")
    if bwd != {0} or fwd != {primal}:
        raise AssertionError(f"{key}: K1 launches a pass: forward "
                             f"{fwd}, backward {bwd}, primal {primal}")
    return line


def phase_timed_fwdbwd_estimators(dev, smi: str):
    """e15: bench.py's cornell_fwdbwd_8lane shape (256x256, passes of 2
    spp, 131,072 camera rays, 8 lanes, depth 5, no Russian roulette) under
    every estimator: remat, attached (replay_grad=False), and cvjp with
    replay_remat "full", "dots" and "none"; then the textured Cornell box
    (g8's scene; img_flat among the leaves) and the families box under
    their default estimators, at the same shape. For each: fwd+bwd Mrays/s
    over ESTIMATOR_PASSES passes (a forward pass's traced rays per pass
    over the wall time), the backward's share (CUDA events), peak device
    memory, CUDA kernel launches in the forward and in the backward
    (torch.profiler sessions over one more pass), and K1 launches in each
    timed pass (0 in the backward, the primal's in the forward)."""
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.scenes.cornell import cornell_box
    from tests import torch_port_grad as tg

    res, passes = ESTIMATOR_RES, ESTIMATOR_PASSES
    cornell, camera = cornell_box(resolution=(res, res))
    cornell = cornell.with_accel().to(dev)
    camera = camera.to(dev)
    texel, _ = tg.texel_cornell(res)
    texel = texel.with_accel().to(dev)
    families, fam_camera, _ = families_on(dev)
    fam_camera = fam_camera.replace(resolution=(res, res)).to(dev)
    configs = [
        ("cornell", "remat", cornell, camera, {}, tg.DEFAULT_LEAVES),
        ("cornell", "attached", cornell, camera, {"replay_grad": False},
         tg.DEFAULT_LEAVES),
        *(("cornell", mode, cornell, camera, kw, tg.DEFAULT_LEAVES)
          for mode, kw in tg.TEXEL_MODES[1:]),
        ("texel", "remat", texel, camera, {}, tg.TEXEL_LEAVES),
        ("families", "attached", families, fam_camera, {},
         tg.DEFAULT_LEAVES),
    ]
    out = {}
    for scene_name, mode, scene, cam, kw, leaves in configs:
        integ = PathIntegrator(max_depth=5, rr_start_depth=5, **kw)
        out[f"{scene_name}_{mode}"] = _timed_fwdbwd_config(
            "e15_timed_fwdbwd_estimators", scene_name, mode, scene, cam,
            integ, leaves, passes, smi)["mrays_per_s"]
    return out


def phase_timed_fwdbwd_leaves(dev, smi: str) -> int:
    """e17: e15's shape (256x256, passes of 2 spp, 8 lanes, depth 5, no
    Russian roulette) with the leaves of item 5e.1-5e.3 requested: the
    families box with every material leaf of its golden (attached, the
    mix hash on coarse keys; e15's families line, in this call, has the
    same box with the default leaves); leaf_lights.pbrt with its light
    tables (remat); texture.pbrt with its texture tables and its lights'
    (remat). For each: e15's figures over one timed pass. Returns K1's
    launches in the timed passes."""
    from tests import torch_port_leaves as TL

    res, passes = ESTIMATOR_RES, ESTIMATOR_PASSES
    leaves = {s: lv for _, s, _, lv in TL.CASES}
    families, fam_camera, _ = families_on(dev)
    fam_camera = fam_camera.replace(resolution=(res, res)).to(dev)
    # (scene, which leaves, estimator, scene, camera, leaves)
    configs = [("families", "material_leaves", "attached", families,
                fam_camera, leaves["families"])]
    for name, which in (("lightkinds", "light_leaves"),
                        ("texture", "texture_leaves")):
        scene, _, camera = leaf_scene_on(name, dev)
        configs.append((name, which, "remat", scene,
                        camera.replace(resolution=(res, res)).to(dev),
                        leaves[name]))
    total = 0
    for name, which, est, scene, camera, asked in configs:
        line = _timed_fwdbwd_config(
            "e17_timed_fwdbwd_leaves", name, which, scene, camera,
            TL.integrator("pbrt_tpu_torch", est), asked, passes, smi,
            keys=TL.keys("pbrt_tpu_torch", name))
        total += line["k1_launches_forward"] * passes
    return total


def phase_timed_fwdbwd_leaves_rest(dev, smi: str) -> int:
    """e18: e15's shape (256x256, passes of 2 spp, 8 lanes, depth 5, no
    Russian roulette) with the rest of item 5e's leaves requested: the
    families box inside its homogeneous medium through the differentiable
    volumetric path (32-step walks) with every leaf of g13's golden
    (5e.5: albedo, area scale, the medium's spectra, the hair,
    subsurface, measured and mix leaves), and the hall cut to 16 lights
    with its light BVH's node table under cvjp (5e.6). For each: e15's
    figures over one timed pass. Returns K1's launches in the timed
    passes."""
    from tests import torch_port_leaves as TL

    res, passes = ESTIMATOR_RES, ESTIMATOR_PASSES
    total = 0
    for name, which, est in (("volfamilies", "volpath_leaves", "volpath"),
                             ("lightbvh", "bvh_nodes", "cvjp")):
        group = TL.group_of(name)
        leaves = dict((s, lv) for _, s, _, lv in TL.CASES)[name]
        asked = tuple(TL.answered(TL.golden(group), f"{name}_{est}", leaves))
        scene, _, camera = leaf_scene_on(name, dev)
        line = _timed_fwdbwd_config(
            "e18_timed_fwdbwd_leaves_rest", name, which, scene,
            camera.replace(resolution=(res, res)).to(dev),
            TL.integrator("pbrt_tpu_torch", est), asked, passes, smi,
            keys=TL.keys("pbrt_tpu_torch", name))
        total += line["k1_launches_forward"] * passes
    return total


# The many-light hall (bench.py manylight_fwd: scenes/manylight.py, 1,024
# panels, seed 7) and its goldens: scripts/make_torch_port_golden_manylight.py,
# rendered with the walk on coarse keys (tests/torch_port_coated.py).
HALL_SAMPLERS = ("power", "bvh")
GOLDEN_COATED_GRAD = os.path.join(ROOT, "tests", "data", "torch_port",
                                  "coated_cornell32_grad.npz")
# d18's gate on the exact-keys render: its mean within 0.3% of the
# golden's (the walk draws other numbers where the card's directions round
# otherwise; the same estimator). Set from scripts/hall_exact_keys_mean.py:
# the sound walk reads up to 1.5e-3, one whose under-coat estimate is 5%
# low reads 5.4e-3 and more (PERF.md section 6).
EXACT_KEYS_MEAN_RTOL = 3e-3


def coarse_keys():
    """The port's layered walk on coarse keys (tests/torch_port_coated.py)
    within the block, as the goldens were made."""
    from pbrt_tpu_torch.materials import layered
    from tests.torch_port_coated import coarse_walk_keys

    return coarse_walk_keys(layered)


def hall_scenes():
    """The hall with the power and with the light-BVH sampler, built on the
    host, with each build's seconds."""
    from pbrt_tpu_torch.scenes.manylight import manylight_scene

    out = {}
    for sampler in HALL_SAMPLERS:
        t0 = time.perf_counter()
        scene, camera = manylight_scene(resolution=(256, 256), sampler=sampler)
        out[sampler] = (scene, camera, time.perf_counter() - t0)
    return out


def phase_golden_hall(dev, hall):
    """d18: the hall at 32x32, 4 spp, depth 4 without Russian roulette, 8
    lanes, seed 0, on the card against the JAX goldens of both samplers
    with d's gate (walk on coarse keys, as the goldens), 2 x depth + 1 K2
    launches per pass; and the render on the exact keys, its mean within
    EXACT_KEYS_MEAN_RTOL of the golden's."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render

    res, spp, depth, lanes = 32, 4, 4, 8
    for sampler in HALL_SAMPLERS:
        scene, camera, _ = hall[sampler]
        golden = np.load(os.path.join(ROOT, "tests", "data", "torch_port",
                                      f"manylight32_{sampler}_spp4.npy"))
        camera = camera.replace(resolution=(res, res))
        integ = PathIntegrator(max_depth=depth, rr_start_depth=depth)
        kw = dict(spp=spp, samples_per_pass=spp, seed=0, n_spectrum=lanes,
                  device=dev)
        cluster.STATS.reset()
        smallscene.STATS.reset()
        with coarse_keys():
            img = render(scene, camera, integ, **kw)
        torch.cuda.synchronize()
        k1, k2 = smallscene.STATS.launches, cluster.STATS.launches
        share, fields = _golden_gate(img.cpu().numpy(), golden)
        exact = render(scene, camera, integ, **kw).cpu().numpy()
        exact_share = float(np.mean(
            np.abs(exact - golden) <= 1e-5 + 1e-3 * np.abs(golden)))
        exact_rel = abs(float(exact.mean()) / float(golden.mean()) - 1.0)
        emit("d18_golden_hall_jax", sampler=sampler, resolution=res, spp=spp,
             max_depth=depth, lanes=lanes, walk_keys="coarse", **fields,
             k2_launches=k2, k1_launches=k1, expected_k2=2 * depth + 1,
             exact_keys_share=exact_share, exact_keys_mean=float(exact.mean()),
             exact_keys_mean_rel_err=exact_rel)
        if share < 0.99:
            raise AssertionError(f"hall ({sampler}): only {share:.4f} of "
                                 "pixel values match the JAX golden")
        if k2 != 2 * depth + 1 or k1:
            raise AssertionError(f"hall ({sampler}): {k2} K2 and {k1} K1 "
                                 "launches per pass")
        if not np.all(np.isfinite(exact)) or exact_rel > EXACT_KEYS_MEAN_RTOL:
            raise AssertionError(f"hall ({sampler}) on the exact keys: mean "
                                 f"{exact.mean()} against {golden.mean()}")


def _coated_shape(z):
    """g5's (res, samples per pass, lanes, passes, depth) from its golden."""
    res, k = int(z["resolution"]), int(z["samples_per_pass"])
    return res, k, int(z["n_spectrum"]), int(z["spp"]) // k, int(z["max_depth"])


def _cpu_coated_grads(path: str) -> None:
    """g5's CPU pass, run in a background process started after e16: the loss and gradients of the coated Cornell box on the CPU,
    saved to `path`."""
    import numpy as np
    import torch

    from tests.torch_port_coated import coated_cornell

    t0 = time.perf_counter()
    torch.set_num_threads(2)
    res, k, lanes, passes, depth = _coated_shape(np.load(GOLDEN_COATED_GRAD))
    scene, camera = coated_cornell("pbrt_tpu_torch", (res, res))
    with coarse_keys():
        loss, grads = grad_passes(scene.with_accel(), camera, res, k, lanes,
                                  passes, depth)
    tmp = path + ".tmp.npz"
    np.savez(tmp, loss=loss, child_seconds=time.perf_counter() - t0, **grads)
    os.replace(tmp, path)


def phase_grad_coated(dev, cpu_coated):
    """g5: the bench's loss and gradients on the coated Cornell box
    (tests/torch_port_coated.py: coated diffuse, coated gold conductor),
    32x32, 4 spp in passes of 2, depth 5, 8 lanes, walk on coarse keys, on
    the card against the JAX golden
    (tests/data/torch_port/coated_cornell32_grad.npz) and against the
    port's CPU pass (the child process _cpu_coated_grads, started after
    e16), with phase g's tolerance; K1 launches per
    forward+backward pass equal to a forward's (2 x depth + 1)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from tests.torch_port_coated import coated_cornell

    z = np.load(GOLDEN_COATED_GRAD)
    res, k, lanes, passes, depth = _coated_shape(z)
    if int(z["rr_start_depth"]) != depth:
        raise AssertionError("the golden's Russian roulette is not off")
    want = {"materials.albedo_coeffs": z["grad_albedo_coeffs"],
            "lights.area_scale": z["grad_area_scale"]}
    scene, camera = coated_cornell("pbrt_tpu_torch", (res, res))
    scene = scene.with_accel().to(dev)
    with coarse_keys():
        STATS.reset()
        t0 = time.perf_counter()
        loss, grads = grad_passes(scene, camera, res, k, lanes,
                                  passes, depth)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = STATS.launches
    t0 = time.perf_counter()
    rc = cpu_coated.wait(timeout=900)
    wait_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"g5: the CPU pass's process exited {rc}")
    z_cpu = np.load(COATED_CPU_FILE)
    cpu_loss = float(z_cpu["loss"])
    cpu_grads = {name: z_cpu[name] for name in want}
    vs_jax = _grad_compare(loss, grads, float(z["loss"]), want)
    vs_cpu = _grad_compare(loss, grads, cpu_loss, cpu_grads)
    emit("g5_grad_coated", resolution=res, spp=int(z["spp"]),
         samples_per_pass=k, lanes=lanes, max_depth=depth, walk_keys="coarse",
         loss=loss, golden_loss=float(z["loss"]), cpu_loss=cpu_loss,
         vs_jax=vs_jax, vs_cpu=vs_cpu, k1_launches=launches, passes=passes,
         k1_launches_per_pass=launches / passes,
         expected_per_pass=2 * depth + 1, card_seconds=card_s,
         cpu_wait_seconds=wait_s,
         cpu_child_seconds=float(z_cpu["child_seconds"]),
         tolerance={"grad_of_max": GRAD_RTOL_OF_MAX, "loss_rel": LOSS_RTOL})
    if not (vs_jax["ok"] and vs_cpu["ok"]):
        raise AssertionError("coated Cornell gradients disagree with the "
                             "golden or the CPU pass")
    if launches != (2 * depth + 1) * passes:
        raise AssertionError(f"{launches} K1 launches for {passes} "
                             "forward+backward passes")


def _hall_layers(render_pass) -> dict:
    """The layers' device ms of one pass (e5's CUDA events around each
    layer's top-level calls), with two layers split from the inside by
    events of their own: the layered walk (materials/layered.py) within
    the BxDF's, light selection (LightBuffers.select and selection_pmf)
    within the lights', and the sorted dispatch's whole call
    (materials/sorted.py shade_sorted, its BxDF calls included)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials import layered
    from pbrt_tpu_torch.materials import sorted as sorted_mod

    timer = ptp.LayerTimer()
    inner = {"walk": ptp.LayerTimer(), "light_selection": ptp.LayerTimer(),
             "sorted_dispatch": ptp.LayerTimer()}
    targets = [(layered, "layered_walk", "walk"),
               (LightBuffers, "select", "light_selection"),
               (LightBuffers, "selection_pmf", "light_selection"),
               (sorted_mod, "shade_sorted", "sorted_dispatch")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    with ptp.wrapped_layers(timer):
        for (owner, attr, fn), (_, _, name) in zip(saved, targets):
            setattr(owner, attr, inner[name].wrap(name, fn))
        try:
            # The caller's timed passes have warmed render_pass.
            torch.cuda.synchronize()
            for t in (timer, *inner.values()):
                t.events.clear()
            t0 = time.perf_counter()
            render_pass()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)
    layers = timer.totals_ms()
    layers["other"] = wall_ms - sum(layers.values())
    layers = {key.replace("k1_", "queries_"): ms for key, ms in layers.items()}
    split = {name: t.totals_ms().get(name, 0.0) for name, t in inner.items()}
    return {"wall_ms": wall_ms, "layers_ms": layers,
            "bxdf_walk_ms": split["walk"],
            "bxdf_rest_ms": layers.get("bxdf", 0.0) - split["walk"],
            "lights_selection_ms": split["light_selection"],
            "lights_rest_ms": layers.get("lights", 0.0)
            - split["light_selection"],
            "sorted_dispatch_ms": split["sorted_dispatch"]}


def phase_timed_hall(dev, smi: str, hall):
    """e8: bench.py's manylight_fwd on the card: the hall at 256x256, one
    pass of 8 spp (bench's 16 cut; 524,288 camera rays), depth 4 without
    Russian roulette, 8 lanes, the cluster tier (K2), for the power and the
    light-BVH sampler: Mrays/s as bench.py counts rays, K2 launches per
    pass and K2's share of the wall, peak memory, the layers' device ms
    (_hall_layers), the kernel launches of one pass and the device's busy
    share (scripts/profile_torch_pass.py's torch.profiler view); then the
    power pass with the lockstep chain (sorted_shading=False) against the
    sorted default, one timed pass each after a warm-up, in this call
    (the card's break-even), the first pass's image of each mode
    bit-equal."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.ops import cluster, smallscene

    res, spp, k, lanes, depth = 256, 8, 8, 8, 4
    passes = spp // k
    stats = {"k1": smallscene.STATS, "k2": cluster.STATS}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    k2_launches = 0
    for sampler in HALL_SAMPLERS:
        scene, camera, build_s = hall[sampler]
        scene, camera = scene.to(dev), camera.to(dev)
        t0 = time.perf_counter()
        render_pass = make_pass(scene, camera, res, k, lanes, depth=depth)
        render_pass(0)  # warm-up
        first_s = time.perf_counter() - t0
        out = timed_forward(render_pass, passes, stats)
        if out["k2_launches"] != passes * (2 * depth + 1) or out["k1_launches"]:
            raise AssertionError(f"timed hall ({sampler}): "
                                 f"{out['k2_launches']} K2 and "
                                 f"{out['k1_launches']} K1 launches")
        layers = _hall_layers(render_pass)
        kern = ptp.kernel_view(lanes, render_pass, out_dir, warm=False)
        emit("e8_timed_hall", sampler=sampler, lanes=lanes, resolution=res,
             spp=spp, samples_per_pass=k, max_depth=depth,
             rays_per_pass_camera=res * res * k, **out,
             k2_launches_per_pass=out["k2_launches"] / passes,
             k2_ms_per_launch=out["k2_ms"] / out["k2_launches"],
             scene_build_seconds=build_s, first_pass_seconds=first_s,
             layers=layers, kernel_launches_per_pass=kern["kernel_launches"],
             device_busy_share=kern["device_busy_share"],
             device_kernel_ms=kern["device_kernel_ms"],
             profiled_pass_wall_ms=kern["wall_ms"], top_kernels=kern["top"],
             nvidia_smi=smi)
        k2_launches += out["k2_launches"]
        if sampler == "power":
            runs, first = {True: [], False: []}, {}
            for sort in ("auto", False):
                rp = make_pass(scene, camera, res, k, lanes, depth=depth,
                               sorted_shading=sort)
                # Each mode's first turn warms it up and keeps its image.
                if (sort == "auto") not in first:
                    first[sort == "auto"] = rp(0)
                runs[sort == "auto"].append(
                    timed_forward(rp, 1, stats)["mrays_per_s"])
            equal = (torch.equal(first[True][0], first[False][0])
                     and bool(first[True][1] == first[False][1]))
            emit("e8_sorted_vs_lockstep", sampler=sampler,
                 sorted_mrays_per_s=runs[True],
                 lockstep_mrays_per_s=runs[False],
                 sorted_over_lockstep=sum(runs[True]) / sum(runs[False]),
                 images_bit_equal=equal, nvidia_smi=smi)
            if not equal:
                raise AssertionError("hall: the sorted pass's image differs "
                                     "from the lockstep pass's")
    return k2_launches



# --- the volumetric path (models/volpath.py) -------------------------------

GOLDEN_DATA = os.path.join(ROOT, "tests", "data", "torch_port")
FOG_FILE = os.path.join(GOLDEN_FILES, "fog.pbrt")
# bench.py's cloud_fwd: 128x128, 16 spp in passes of 8, depth 6, the DDA
# walk, Russian roulette from depth 3 (the integrator's default), 8 lanes.
CLOUD = dict(res=128, spp=8, k=8, depth=6, lanes=8)


def inset_entry():
    """The port's medium entry inset (tests/torch_port_media.py) within
    the block, as the cloud's goldens were made."""
    from pbrt_tpu_torch.media.medium import MediumBuffers
    from tests.torch_port_media import inset_entry as inset

    return inset(MediumBuffers)


def cloud_on(dev, res: int):
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.scenes.cloud import cloud_scene

    scene, camera = cloud_scene(resolution=(res, res))
    return (scene.to(dev), camera.to(dev),
            VolPathIntegrator(max_depth=CLOUD["depth"], use_dda=True))


def fog_on(dev, res: int):
    from pbrt_tpu_torch.io.parser import load_pbrt

    scene, camera, settings = load_pbrt(FOG_FILE, device=dev)
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


def _k1_queries(render_pass):
    """Every K1 query of one render_pass() call, as the integrator sends
    it: [(o, d, tmax, any_hit)]; the queries still launch the kernel."""
    from pbrt_tpu_torch.accel import api

    queries = []
    launch = api.smallscene_intersect

    def capture(acc, o, d, tmax, any_hit=False, **kw):
        queries.append((o.clone(), d.clone(), tmax.clone(), any_hit))
        return launch(acc, o, d, tmax, any_hit=any_hit, **kw)

    api.smallscene_intersect = capture
    try:
        render_pass(0)
    finally:
        api.smallscene_intersect = launch
    return queries


def _hold_k1(acc, queries, label: str) -> dict:
    """Each captured K1 query (_k1_queries) against the twin, bit for bit
    key by key, with the kernel's and the twin's times and the bound."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import (
        smallscene_intersect, smallscene_intersect_ref)

    rows = acc.n_tris
    per_query, ms, plain_ms, bound_ms, err = [], 0.0, 0.0, 0.0, 0.0
    for i, (o, d, tmax, any_hit) in enumerate(queries):
        got = smallscene_intersect(acc, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = smallscene_intersect_ref(acc, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        q_plain = (time.perf_counter() - t0) * 1e3
        bad = [key for key in ref if not torch.equal(got[key], ref[key])]
        if set(got) != set(ref) or bad:
            raise AssertionError(f"{label} query {i}: K1 differs from its "
                                 f"twin in {bad} (any_hit {any_hit})")
        q_ms = cuda_ms(lambda: smallscene_intersect(acc, o, d, tmax,
                                                    any_hit=any_hit), reps=10)
        n = int(o.shape[0])
        bound = _bound(n * rows * MT_OPS,
                       n * (28 + (8 if any_hit else 36)) + rows * 64)
        err = max(err, max_abs_err(got, ref))
        ms += q_ms
        plain_ms += q_plain
        bound_ms += bound["bound_ms"]
        per_query.append({"mode": "any_hit" if any_hit else "closest",
                          "rays": n, "live": int((tmax > 0).sum()),
                          "finite_tmax": int(torch.isfinite(tmax).sum()),
                          "ms": q_ms, "plain_ms": q_plain,
                          "bound_ms": bound["bound_ms"]})
    return {"queries": len(queries), "triangles": rows, "ms_per_pass": ms,
            "plain_ms_per_pass": plain_ms, "bound_ms_per_pass": bound_ms,
            "max_abs_err": err, "per_query": per_query}


def phase_k1_volpath_vs_twin(dev):
    """c6: K1 against its twin on every query of one pass of the cloud
    (128x128, 8 spp, depth 6: per bounce the closest query and the
    any-hit occlusion queries of the two ratio-tracking transmittances,
    then the terminal closest and any-hit) and of fog.pbrt (64x64, 8 spp:
    per bounce the closest query and the four closest queries of each of
    the two interface-aware shadow walks, done lanes at tmax 0), launches
    counted from zero, each query bit-equal key by key, kernel and twin
    timed, with the bound of each."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    out = {}
    for name, res, (scene, camera, integ), want in (
            ("cloud", CLOUD["res"], cloud_on(dev, CLOUD["res"]),
             3 * CLOUD["depth"] + 2),
            ("fog", 64, fog_on(dev, 64), None)):
        if want is None:
            want = 9 * integ.max_depth + 1
        rp = make_pass(scene, camera, res, 8, CLOUD["lanes"],
                       integrator=integ)
        STATS.reset()
        queries = _k1_queries(rp)
        torch.cuda.synchronize()
        launches = STATS.launches
        if launches != want or len(queries) != launches:
            raise AssertionError(f"{name}: {launches} K1 launches, "
                                 f"{len(queries)} queries, {want} expected")
        out[name] = {"launches": launches,
                     **_hold_k1(scene.small, queries, name)}
        STATS.reset()
    emit("c6_k1_volpath_vs_twin", **out)
    return out


def phase_fog_box(dev):
    """d20: scenes/cloud.py's fog box on the card against its closed form
    (tests/test_media.py's gates): absorption only, L = Le exp(-sigma_t),
    the mean within 6% at 32 spp; absorption and scattering at depth 1
    between the pure attenuation and 1.5 times it, at depth 4 below the
    unattenuated source."""
    import math

    import torch

    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import camera_rays
    from pbrt_tpu_torch.scenes.cloud import fog_box_scene

    def mean(sa, ss, depth, spp=32):
        scene, camera = fog_box_scene(sigma_a=sa, sigma_s=ss, le_scale=5.0)
        scene, camera = scene.to(dev), camera.to(dev)
        pixel = torch.arange(64, device=dev).repeat(spp)
        sample = torch.arange(spp, device=dev).repeat_interleave(64)
        o, d, wl = camera_rays(camera, pixel, sample, 0, n_spectrum=8)
        integ = VolPathIntegrator(max_depth=depth, rr_start_depth=100,
                                  use_nee=False)
        return float(integ.trace(scene, o, d, wl, pixel, sample, 0).mean())

    expected = 5.0 * math.exp(-1.0)
    STATS.reset()
    got = mean(1.0, 0.0, 3)
    launches = STATS.launches
    got_t = mean(0.5, 0.5, 1)
    got_s = mean(0.5, 0.5, 4)
    rel = abs(got - expected) / expected
    emit("d20_fog_box", mean_absorbing=got, expected=expected, rel_err=rel,
         tolerance=0.06, mean_scattering_depth1=got_t,
         mean_scattering_depth4=got_s, k1_launches=launches)
    if not (rel < 0.06 and expected < got_t < min(5.0, 1.5 * expected)
            and expected < got_s < 5.0):
        raise AssertionError(f"fog box off its closed form: {got}, {got_t}, "
                             f"{got_s} against {expected}")
    if launches != 3 + 2:  # 3 bounces, the terminal closest and any-hit
        raise AssertionError(f"fog box: {launches} K1 launches")


def phase_golden_volpath_jax(dev):
    """d21: the cloud (32x32, 4 spp, depth 6, entry inset as the golden)
    and fog.pbrt (32x32, 4 spp) on the card against the JAX goldens of
    scripts/make_torch_port_golden_media.py with d's gate; the cloud also
    with the exact entry (its share and mean beside it: lanes whose entry
    rounds outside the box re-draw their walks)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render

    kw = dict(spp=4, samples_per_pass=4, seed=0, n_spectrum=8, device=dev)
    for name, (scene, camera, integ), per_pass in (
            ("cloud", cloud_on(dev, 32), 3 * CLOUD["depth"] + 2),
            ("fog", fog_on(dev, 32), None)):
        golden = np.load(os.path.join(GOLDEN_DATA, f"{name}32_spp4.npy"))
        per_pass = per_pass or 9 * integ.max_depth + 1
        STATS.reset()
        with inset_entry():
            img = render(scene, camera, integ, **kw)
        torch.cuda.synchronize()
        launches = STATS.launches
        share, fields = _golden_gate(img.cpu().numpy(), golden)
        extra = {}
        if name == "cloud":
            exact = render(scene, camera, integ, **kw).cpu().numpy()
            extra = {"exact_entry_share": float(np.mean(
                np.abs(exact - golden) <= 1e-5 + 1e-3 * np.abs(golden))),
                "exact_entry_mean": float(exact.mean()),
                "exact_entry_finite": bool(np.all(np.isfinite(exact)))}
        emit("d21_golden_volpath_jax", scene=name, resolution=32, spp=4,
             max_depth=integ.max_depth, lanes=8,
             entry="inset" if name == "cloud" else "exact", **fields,
             image_mean_diff=fields["mean"] - fields["golden_mean"],
             k1_launches=launches, expected_k1=per_pass, **extra)
        if share < 0.99:
            raise AssertionError(f"{name}: only {share:.4f} of pixel values "
                                 "match the JAX golden")
        if launches != per_pass:
            raise AssertionError(f"{name}: {launches} K1 launches, "
                                 f"{per_pass} expected")
        if extra and not extra["exact_entry_finite"]:
            raise AssertionError("cloud with the exact entry: not finite")


def _volpath_layers(render_pass) -> dict:
    """The layers' device ms of one volpath pass (CUDA events around each
    layer's outermost calls, as scripts/profile_torch_pass.py takes them):
    camera, closest queries, the delta-tracking walk, the ratio-tracking
    transmittances (their occlusion queries inside), lights, the phase
    function, the BxDF, RNG draws outside the walks, film, and the rest."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch import render as render_mod
    from pbrt_tpu_torch.accel import api as accel_api
    from pbrt_tpu_torch.films import rgb as film_mod
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.media import phase
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.samplers.samplers import Sampler

    layers = {
        "camera": [(render_mod, "camera_rays_full")],
        "closest": [(accel_api, "closest")],
        "any_hit": [(accel_api, "any_hit")],
        "delta_walk": [(VolPathIntegrator, "_walk")],
        "ratio_walks": [(VolPathIntegrator, "_transmittance")],
        "lights": [(LightBuffers, a) for a in (
            "emitted", "pdf_li_area", "sample_li", "pdf_escaped",
            "escaped_radiance")],
        "phase": [(phase, "hg_pdf"), (phase, "hg_sample")],
        "bxdf": [(bxdf, a) for a in ("surface_params", "sample", "evaluate",
                                     "pdf")],
        "rng": [(Sampler, "get_1d"), (Sampler, "get_2d")],
        "film": [(film_mod, "spectrum_to_rgb")],
    }
    timer = ptp.LayerTimer()
    saved = []
    for name, targets in layers.items():
        for owner, attr in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, timer.wrap(name, fn))
    try:
        # The caller's timed passes have warmed render_pass.
        torch.cuda.synchronize()
        timer.events.clear()
        t0 = time.perf_counter()
        render_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    out = timer.totals_ms()
    out["other"] = wall_ms - sum(out.values())
    return {"wall_ms": wall_ms, "layers_ms": dict(
        sorted(out.items(), key=lambda kv: -kv[1]))}


def _walk_decay(render_pass, n_camera: int) -> dict:
    """Live lanes of the delta-tracking walk after each step at bounce 0
    (a diagnostic pass: one device read per step), and the lanes that
    enter the medium, as shares of the pass's camera rays."""
    from pbrt_tpu_torch.ops import compact

    steps, first = [], []
    run_steps = compact._steps

    def counted(body, inputs, state, it0, m, draws):
        u = draws(inputs, it0, m) if draws is not None else None
        for j in range(m):
            state = body(inputs, it0 + j, state,
                         None if u is None else u[:, j])
            if "walking" in state and not first:
                steps.append((it0 + j, int(state["walking"].sum())))
        return state

    def staged(body, inputs, state, mask_of, max_steps, **kw):
        if "walking" in state and not first and not steps:
            steps.append((-1, int(state["walking"].sum())))
        out = staged_loop(body, inputs, state, mask_of, max_steps, **kw)
        if "walking" in state and steps:
            first.append(True)
        return out

    from pbrt_tpu_torch.models import volpath

    staged_loop = volpath.staged_masked_loop
    compact._steps = counted
    volpath.staged_masked_loop = staged
    try:
        render_pass(0)
    finally:
        compact._steps = run_steps
        volpath.staged_masked_loop = staged_loop
    # A compacted batch holds the live lanes only: the step's count is the
    # count of live lanes in the whole pass. Steps a stage skips (no live
    # lane at its boundary) read 0.
    live = {it: n for it, n in steps}
    last = max(live)
    curve = [live.get(it, 0) / n_camera for it in range(-1, last + 1)]
    return {"entering_share": curve[0], "live_share_after_step": curve[1:],
            "steps_with_live_lanes": sum(1 for c in curve[1:] if c > 0)}


def phase_timed_cloud(dev, smi: str) -> int:
    """e9: bench.py's cloud_fwd on the card: the cloud at 128x128, one
    pass of 8 spp (bench's 16 cut; 131,072 camera rays), depth 6, the DDA walk,
    Russian roulette from 3, 8 lanes: Mrays/s as bench.py counts rays, K1
    launches per pass, the walks' host reads per pass, peak memory, the
    layers' device ms, the kernel launches and the device's busy share of
    one profiled 64x64 pass (torch.profiler; the keys end in _64x64), the
    delta walk's live lanes per step at bounce 0; then the compacted walks
    against the lockstep walks (compact_walks=False), one timed pass each
    after a warm-up, the first pass's image of each bit-equal."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.ops import compact
    from pbrt_tpu_torch.ops.smallscene import STATS

    c = CLOUD
    res, k, passes = c["res"], c["k"], c["spp"] // c["k"]
    t0 = time.perf_counter()
    scene, camera, integ = cloud_on(dev, res)
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    render_pass = make_pass(scene, camera, res, k, c["lanes"],
                            integrator=integ)
    t0 = time.perf_counter()
    render_pass(0)  # warm-up
    first_s = time.perf_counter() - t0
    compact.STATS.reset()
    out = timed_forward(render_pass, passes, {"k1": STATS})
    reads = compact.STATS.reads / passes
    if out["k1_launches"] != passes * (3 * c["depth"] + 2):
        raise AssertionError(f"timed cloud: {out['k1_launches']} K1 launches")
    layers = _volpath_layers(render_pass)
    # The launches and busy share from a profiled 64x64 pass (the walks'
    # steps and launches follow the densest lanes, not the width).
    small = cloud_on(dev, 64)
    kern = ptp.kernel_view(c["lanes"], make_pass(small[0], small[1], 64, k,
                                                 c["lanes"],
                                                 integrator=small[2]),
                           out_dir)
    decay = _walk_decay(render_pass, res * res * k)
    emit("e9_timed_cloud", lanes=c["lanes"], resolution=res, spp=c["spp"],
         samples_per_pass=k, max_depth=c["depth"], use_dda=True,
         rr_start_depth=integ.rr_start_depth,
         rays_per_pass_camera=res * res * k, **out,
         k1_launches_per_pass=out["k1_launches"] / passes,
         walk_host_reads_per_pass=reads, scene_build_seconds=build_s,
         first_pass_seconds=first_s, layers=layers,
         kernel_launches_per_pass_64x64=kern["kernel_launches"],
         device_busy_share_64x64=kern["device_busy_share"],
         device_kernel_ms_64x64=kern["device_kernel_ms"],
         profiled_pass_wall_ms_64x64=kern["wall_ms"],
         top_kernels_64x64=kern["top"], walk_decay_bounce0=decay,
         nvidia_smi=smi)
    # One timed pass a turn after a warm-up pass that keeps its first image.
    runs, first = {True: [], False: []}, {}
    for compact_walks in (True, False):
        rp = make_pass(scene, camera, res, k, c["lanes"],
                       integrator=integ.replace(compact_walks=compact_walks))
        if compact_walks not in first:
            first[compact_walks] = rp(0)
        runs[compact_walks].append(
            timed_forward(rp, 1, {"k1": STATS})["mrays_per_s"])
    equal = (torch.equal(first[True][0], first[False][0])
             and bool(first[True][1] == first[False][1]))
    emit("e9_compacted_vs_lockstep", compacted_mrays_per_s=runs[True],
         lockstep_mrays_per_s=runs[False],
         compacted_over_lockstep=sum(runs[True]) / sum(runs[False]),
         images_bit_equal=equal, nvidia_smi=smi)
    if not equal:
        raise AssertionError("cloud: the compacted walks' image differs from "
                             "the lockstep walks'")
    return out["k1_launches"]


def phase_grad_fog_box(dev):
    """g6: tests/test_gradients.py's medium gradient on the card: the fog
    box (sigma_a 0.8, 8x8, 48 spp), VolPathIntegrator(max_depth=2,
    use_nee=False, 32 steps, differentiable=True), the mean radiance and
    its gradient with respect to medium.sigma_a_scale, against
    tests/data/torch_port/fogbox8_grad.npz (the JAX reference's) and the
    port's CPU pass, within 1e-3 of the golden's gradient (its largest
    entry) and the loss within 1e-4; K1 launches per forward+backward
    pass equal to a forward's (two bounces, the terminal closest and
    any-hit)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import camera_rays
    from pbrt_tpu_torch.scenes.cloud import fog_box_scene

    z = np.load(os.path.join(GOLDEN_DATA, "fogbox8_grad.npz"))
    res, spp = int(z["resolution"]), int(z["spp"])
    scene, camera = fog_box_scene(sigma_a=float(z["sigma_a"]), sigma_s=0.0,
                                  le_scale=float(z["le_scale"]),
                                  resolution=(res, res))
    steps = int(z["max_steps"])
    integ = VolPathIntegrator(
        max_depth=int(z["max_depth"]), rr_start_depth=int(z["rr_start_depth"]),
        use_nee=False, max_null_steps=steps, max_tr_steps=steps,
        differentiable=True)

    def value_and_grad(device):
        s, cam = scene.to(device), camera.to(device)
        leaf = s.medium.sigma_a_scale.clone().requires_grad_(True)
        s = s.replace(medium=s.medium.replace(sigma_a_scale=leaf))
        pixel = torch.arange(res * res, device=device).repeat(spp)
        sample = torch.arange(spp, device=device).repeat_interleave(res * res)
        o, d, wl = camera_rays(cam, pixel, sample, int(z["seed"]),
                               n_spectrum=int(z["n_spectrum"]))
        loss = integ.trace(s, o, d, wl, pixel, sample, int(z["seed"])).mean()
        (g,) = torch.autograd.grad(loss, leaf)
        return float(loss.detach()), float(g)

    STATS.reset()
    loss, grad = value_and_grad(dev)
    torch.cuda.synchronize()
    launches = STATS.launches
    cpu_loss, cpu_grad = value_and_grad("cpu")
    want = float(z["grad_sigma_a_scale"])
    err_jax = abs(grad - want) / abs(want)
    err_cpu = abs(grad - cpu_grad) / abs(want)
    loss_err = abs(loss - float(z["loss"])) / abs(float(z["loss"]))
    emit("g6_grad_fog_box", resolution=res, spp=spp, loss=loss,
         golden_loss=float(z["loss"]), cpu_loss=cpu_loss,
         grad_sigma_a_scale=grad, golden_grad=want, cpu_grad=cpu_grad,
         rel_err_vs_jax=err_jax, rel_err_vs_cpu=err_cpu,
         loss_rel_err=loss_err, k1_launches=launches,
         expected_k1=int(z["max_depth"]) + 2,
         tolerance={"grad_of_max": GRAD_RTOL_OF_MAX, "loss_rel": LOSS_RTOL})
    if not (err_jax <= GRAD_RTOL_OF_MAX and err_cpu <= GRAD_RTOL_OF_MAX
            and loss_err <= LOSS_RTOL and np.isfinite(grad)):
        raise AssertionError(f"fog box gradient {grad} against {want} "
                             f"(CPU {cpu_grad}), loss {loss}")
    if launches != int(z["max_depth"]) + 2:
        raise AssertionError(f"fog box gradient: {launches} K1 launches")


# --- the families box (hair, subsurface, measured, mix, retroreflective) ---

FAMILIES_FILE = os.path.join(GOLDEN_DATA, "families.pbrt")
# e10: 512x512, 8 spp in passes of 4, depth 5, 8 lanes (as e6 and e7).
FAMILIES = dict(res=512, spp=8, k=4, depth=5, lanes=8)
# K1 queries of a depth-5 families pass: per bounce the closest query,
# the subsurface probe and the shadow query, then the terminal closest.
FAMILIES_K1_PER_PASS = 3 * FAMILIES["depth"] + 1
_FAMILIES_SCENE = {}


def families_on(dev):
    """The families box through the port's parser on the card (built once:
    the measured table's per-cell fit takes seconds on the host)."""
    from pbrt_tpu_torch.io.parser import load_pbrt

    if "built" not in _FAMILIES_SCENE:
        t0 = time.perf_counter()
        built = load_pbrt(FAMILIES_FILE, device=dev)
        _FAMILIES_SCENE["built"] = built
        _FAMILIES_SCENE["seconds"] = time.perf_counter() - t0
    scene, camera, settings = _FAMILIES_SCENE["built"]
    return scene, camera, settings["integrator"]


def coarse_mix_keys():
    """The port's mix hash on coarse keys within the block, as the
    families goldens were made (tests/torch_port_families.py)."""
    from pbrt_tpu_torch.materials import bxdf
    from tests.torch_port_families import coarse_mix_keys as coarse

    return coarse(bxdf)


def phase_k1_families_vs_twin(dev):
    """c7: K1 against its twin on every query of one families-box pass
    (128x128, 8 spp, depth 5), the subsurface probes included (closest
    queries of a per-ray tmax), launches counted from zero, each query
    bit-equal key by key, kernel and twin timed, with the bound of each."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    scene, camera, integ = families_on(dev)
    res, k = 128, 8
    rp = make_pass(scene, camera.replace(resolution=(res, res)), res, k,
                   FAMILIES["lanes"], depth=FAMILIES["depth"])
    STATS.reset()
    queries = _k1_queries(rp)
    torch.cuda.synchronize()
    launches = STATS.launches
    if launches != FAMILIES_K1_PER_PASS or len(queries) != launches:
        raise AssertionError(f"families: {launches} K1 launches, "
                             f"{len(queries)} queries, "
                             f"{FAMILIES_K1_PER_PASS} expected")
    held = _hold_k1(scene.small, queries, "families")
    STATS.reset()
    # Within a bounce: the closest query, the probe, the shadow query.
    for i, q in enumerate(held["per_query"]):
        q["query"] = ("terminal" if i == launches - 1 else
                      ("closest", "probe", "any_hit")[i % 3])
    emit("c7_k1_families_vs_twin", resolution=res, spp=k,
         max_depth=FAMILIES["depth"], launches=launches, **held,
         probe_ms_per_pass=sum(q["ms"] for q in held["per_query"]
                               if q["query"] == "probe"),
         scene_build_seconds=_FAMILIES_SCENE["seconds"])


def phase_golden_families_jax(dev):
    """d22: the families box at 32x32, 4 spp, 8 lanes, depth 5, the mix
    hash on coarse keys, against families32_spp4.npy (the JAX reference,
    scripts/make_torch_port_golden_families.py) with d's gate; 16 K1
    launches per pass."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render

    scene, camera, integ = families_on(dev)
    golden = np.load(os.path.join(GOLDEN_DATA, "families32_spp4.npy"))
    STATS.reset()
    with coarse_mix_keys():
        img = render(scene, camera.replace(resolution=(32, 32)), integ,
                     spp=4, samples_per_pass=4, seed=0, n_spectrum=8,
                     device=dev)
    torch.cuda.synchronize()
    launches = STATS.launches
    share, fields = _golden_gate(img.cpu().numpy(), golden)
    emit("d22_golden_families_jax", resolution=32, spp=4,
         max_depth=integ.max_depth, lanes=8, **fields,
         image_mean_diff=fields["mean"] - fields["golden_mean"],
         k1_launches=launches, expected_k1=FAMILIES_K1_PER_PASS)
    if share < 0.99:
        raise AssertionError(f"families: only {share:.4f} of pixel values "
                             "match the JAX golden")
    if launches != FAMILIES_K1_PER_PASS:
        raise AssertionError(f"families: {launches} K1 launches")


def _families_layers(render_pass) -> dict:
    """e5's layers of one families pass (CUDA events around each layer's
    top-level calls), with the BxDF calls split by the family segment the
    sorted dispatch runs them on (the link flag it leaves on; "diffuse"
    with none), and the subsurface step and its probe query timed from the
    inside."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.accel import api as accel_api
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.models import path as path_mod

    timer = ptp.LayerTimer()
    families, step, probe = (ptp.LayerTimer() for _ in range(3))
    saved = [(path_mod, a, getattr(path_mod, a)) for a in
             ("_bsdf_calls", "_subsurface_step", "subsurface_exit")]
    calls, step_fn, exit_fn = (fn for _, _, fn in saved)
    in_exit = []

    def by_family(params, ops):
        on = [f for f in bxdf.FLAGS if params.get(f)]
        name = on[0] if len(on) == 1 else ("diffuse" if not on else "chain")
        return families.wrap(name.removeprefix("any_"), calls)(params, ops)

    def exit_(*args, **kw):
        in_exit.append(True)
        try:
            return exit_fn(*args, **kw)
        finally:
            in_exit.pop()

    with ptp.wrapped_layers(timer):
        closest = accel_api.closest

        def probe_or_closest(*args, **kw):
            if in_exit:
                return probe.wrap("probe", closest)(*args, **kw)
            return closest(*args, **kw)

        accel_api.closest = probe_or_closest
        path_mod._bsdf_calls = by_family
        path_mod._subsurface_step = step.wrap("subsurface_step", step_fn)
        path_mod.subsurface_exit = exit_
        try:
            # The caller's timed passes have warmed render_pass.
            torch.cuda.synchronize()
            for t in (timer, families, step, probe):
                t.events.clear()
            t0 = time.perf_counter()
            render_pass()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            accel_api.closest = closest
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)
    layers = timer.totals_ms()
    layers["other"] = wall_ms - sum(layers.values())
    layers = {key.replace("k1_", "queries_"): ms for key, ms in layers.items()}
    return {"wall_ms": wall_ms, "layers_ms": layers,
            "bxdf_by_family_ms": families.totals_ms(),
            "subsurface_step_ms": step.totals_ms().get("subsurface_step", 0.0),
            "probe_query_ms": probe.totals_ms().get("probe", 0.0)}


def phase_timed_families(dev, smi: str) -> int:
    """e10: the families box timed at 512x512, 8 spp in passes of 4
    (1,048,576 camera rays a pass), depth 5 without Russian roulette, 8
    lanes, seed 0 (the sorted dispatch on, by the reference's auto rule):
    Mrays/s, K1 launches per pass, peak memory, the first pass's seconds,
    the layers (_families_layers), kernel launches per pass and the busy
    share (torch.profiler); then sorted against lockstep shading
    (sorted_shading=False), each timed after a warm-up, the first pass's
    image of each bit-equal."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.ops.smallscene import STATS

    f = FAMILIES
    res, k, passes = f["res"], f["k"], f["spp"] // f["k"]
    scene, camera, _ = families_on(dev)
    camera = camera.replace(resolution=(res, res))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    render_pass = make_pass(scene, camera, res, k, f["lanes"],
                            depth=f["depth"])
    t0 = time.perf_counter()
    render_pass(0)  # warm-up
    first_s = time.perf_counter() - t0
    out = timed_forward(render_pass, passes, {"k1": STATS})
    if out["k1_launches"] != passes * FAMILIES_K1_PER_PASS:
        raise AssertionError(f"timed families: {out['k1_launches']} K1 "
                             "launches")
    layers = _families_layers(render_pass)
    kern = ptp.kernel_view(f["lanes"], render_pass, out_dir,
                           warm=False)
    emit("e10_timed_families", lanes=f["lanes"], resolution=res,
         spp=f["spp"], samples_per_pass=k, max_depth=f["depth"],
         rays_per_pass_camera=res * res * k, **out,
         k1_launches_per_pass=out["k1_launches"] / passes,
         scene_build_seconds=_FAMILIES_SCENE["seconds"],
         first_pass_seconds=first_s, layers=layers,
         kernel_launches_per_pass=kern["kernel_launches"],
         device_busy_share=kern["device_busy_share"],
         device_kernel_ms=kern["device_kernel_ms"],
         profiled_pass_wall_ms=kern["wall_ms"], top_kernels=kern["top"],
         nvidia_smi=smi)
    runs, first = {True: [], False: []}, {}
    for sort in ("auto", False):
        rp = make_pass(scene, camera, res, k, f["lanes"], depth=f["depth"],
                       sorted_shading=sort)
        if (sort == "auto") not in first:  # the mode's warm-up pass
            first[sort == "auto"] = rp(0)
        runs[sort == "auto"].append(
            timed_forward(rp, passes, {"k1": STATS})["mrays_per_s"])
    equal = (torch.equal(first[True][0], first[False][0])
             and bool(first[True][1] == first[False][1]))
    emit("e10_sorted_vs_lockstep", sorted_mrays_per_s=runs[True],
         lockstep_mrays_per_s=runs[False],
         sorted_over_lockstep=sum(runs[True]) / sum(runs[False]),
         images_bit_equal=equal, nvidia_smi=smi)
    if not equal:
        raise AssertionError("families: the sorted pass's image differs "
                             "from the lockstep pass's")
    return out["k1_launches"]


# ---- PR: the light-tracing and specialty integrators (c8, d23, d24, e11)

LT_ROOM = os.path.join(GOLDEN_FILES, "bdpt.pbrt")
LT_CAUSTIC = os.path.join(GOLDEN_FILES, "sppm.pbrt")
LT_MLT = os.path.join(GOLDEN_FILES, "mlt.pbrt")
# K1 queries of one pass of each (depth 5): the light path, a closest and
# a camera connection a bounce and the light point's connection; BDPT,
# the 6 camera and 5 light walk steps, 15 connections and 6 t = 1
# splats; SPPM, a closest and a shadow query a camera bounce and a
# closest a photon bounce; an MLT step, a depth-5 path trace.
LT_K1_PER_PASS = {"lightpath": 11, "bdpt": 32, "sppm": 15, "mlt": 11}
# d23: tests/test_reference_parity.py's MC_CASES rows (file, spp or
# iterations or mutations per pixel, bounds on the relative mean error and
# the MSE), copied, not imported; its seed 1. BDPT at that test's 256 spp;
# SPPM and MLT cut in depth to fit the script's time (the test's 64
# iterations and 1,024 mutations per pixel took 45 and 52 s on the
# H100), the
# bounds kept.
MC_GOLDENS = (("bdpt", 256, (0.06, 0.02)), ("sppm", 32, (0.10, 0.03)),
              ("mlt", 256, (0.10, 0.03)))
MC_SEED = 1
# d23's MLT runs the file's 256 chains unless their steps (2,304 at 256
# mutations per pixel over 48x48) would take longer than this, timed on
# the first steps; then the reference parser's default of 4,096 chains.
MLT_STEPS_BUDGET_S = 60.0
MLT_DEFAULT_CHAINS = 4096
# e11's configurations.
E11 = dict(res=256, bdpt_spp=8, bdpt_k=4, sppm_iterations=4, mlt_steps=16,
           mlt_chains=(256, 4096), lanes=8, depth=5)


def lt_scene(dev, path, res):
    """A golden scene file on `dev` at res x res: (scene, camera,
    integrator)."""
    from pbrt_tpu_torch.io.parser import load_pbrt

    scene, camera, settings = load_pbrt(path, device=dev)
    return scene, camera.replace(resolution=(res, res)), settings["integrator"]


LENS = dict(res=256, spp=64, k=16, depth=5, lanes=8)
EYE_BANDS = dict(res=256, n_bands=8, spp_per_band=8, depth=5, lanes=8)
_CORNELL = {}
_LENS_CAMERA = {}


def cornell_on(dev):
    """The Cornell box (scenes/cornell.py) with K1 attached, on dev."""
    if dev not in _CORNELL:
        from pbrt_tpu_torch.scenes.cornell import cornell_box

        scene, camera = cornell_box(resolution=(32, 32))
        _CORNELL[dev] = (scene.with_accel().to(dev), camera.to(dev))
    return _CORNELL[dev]


def lens_pass(dev, res: int, k: int, lanes: int, kind: str = "zsobol",
              perspective: bool = False, filter_kind: str = "gaussian",
              depth: int = LENS["depth"]):
    """e13's cornell_lens pass (make_pass): the Cornell box through the
    doublet (tests/torch_port_cameras.py, its exit-pupil bounds the
    port's own), the sampler `kind` over LENS["spp"] samples a pixel and
    the filter `filter_kind`; perspective=True takes the box's own camera,
    the box filter. Returns render_pass(pass_idx)."""
    from pbrt_tpu_torch.filters.filters import Filter
    from pbrt_tpu_torch.samplers.samplers import Sampler

    from tests.torch_port_cameras import lens_camera

    scene, camera = cornell_on(dev)
    filt = None
    if perspective:
        camera = camera.replace(resolution=(res, res))
    else:
        if (dev, res) not in _LENS_CAMERA:  # its pupil bounds take seconds
            _LENS_CAMERA[dev, res] = lens_camera("pbrt_tpu_torch", res).to(dev)
        camera = _LENS_CAMERA[dev, res]
        filt = Filter.create(filter_kind).to(dev)
    sampler = Sampler.create(kind, spp=LENS["spp"], seed=0, nx=res,
                             log2_res=max(1, (res - 1).bit_length()))
    return make_pass(scene, camera, res, k, lanes, depth=depth,
                     sampler=sampler, filt=filt)


def lt_pass(kind: str, dev, res: int, k: int = 1, chains: int = 256):
    """One pass of a light-tracing integrator on its golden scene, as its
    render loop runs it, 8 lanes, seed 0: render_pass(pass_idx=0) ->
    (image, work), work the pass's paths (lightpath: res^2 k light paths;
    bdpt: res^2 k bidirectional samples), photons (sppm: one iteration,
    res^2 photons and camera paths) or mutations (mlt: one step of every
    chain, after the bootstrap at build)."""
    import torch

    from pbrt_tpu_torch.core import spectrum
    from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
    from pbrt_tpu_torch.models.lightpath import LightPathIntegrator
    from pbrt_tpu_torch.samplers.samplers import Sampler

    npix = res * res
    lanes, seed = 8, 0
    if kind in ("lightpath", "bdpt"):
        scene, camera, integ = lt_scene(dev, LT_ROOM, res)
        sampler = Sampler(seed=seed, kind="independent", spp=k, nx=res)
        n = npix * k
        if kind == "lightpath":
            integ = LightPathIntegrator(max_depth=integ.max_depth)
            path_id = torch.arange(n, device=dev)

            def render_pass(p: int = 0):
                wl = spectrum.sample_visible(sampler.get_1d(path_id, p, 5),
                                             lanes)
                return integ.render_splats(scene, camera, n, wl, p,
                                           sampler), n
            return render_pass
        pixel = torch.arange(npix, device=dev).repeat(k)

        def render_pass(p: int = 0):
            sample = torch.arange(p * k, (p + 1) * k,
                                  device=dev).repeat_interleave(npix)
            wl = spectrum.sample_visible(sampler.get_1d(pixel, sample, 4),
                                         lanes)
            L, splat, _ = integ.trace(scene, camera, wl, pixel, sample,
                                      sampler)
            rgb = spectrum_to_rgb(L, wl).reshape(k, res, res, 3).mean(dim=0)
            return rgb + splat.reshape(res, res, 3), n
        return render_pass
    if kind == "sppm":
        scene, camera, integ = lt_scene(dev, LT_CAUSTIC, res)
        state = {"s": integ.start(scene, camera)}

        def render_pass(p: int = 0):
            state["s"] = integ.iterate(scene, camera, state["s"], p, seed,
                                       lanes)
            return integ.image(camera, state["s"], p + 1), npix
        return render_pass
    from pbrt_tpu_torch.models.mlt import MLTIntegrator

    scene, camera, integ = lt_scene(dev, LT_MLT, res)
    integ = MLTIntegrator(base=integ.base, n_chains=chains,
                          mutations_per_chain=1, sigma=integ.sigma,
                          p_large=integ.p_large)
    b, u0 = integ._bootstrap(scene, camera, seed, lanes)
    state = {"s": integ.start(scene, camera, u0, lanes)}

    def render_pass(p: int = 0):
        state["s"], _ = integ.step(scene, camera, state["s"], p, b, seed,
                                   lanes)
        return state["s"]["splat"][:npix].reshape(res, res, 3), chains
    return render_pass


def phase_k1_lighttransport_vs_twin(dev):
    """c8: K1 against its twin on every query of one pass of the light
    path (bdpt.pbrt's room, 128x128 paths), BDPT (the room, 128x128, 1
    spp), an SPPM iteration (sppm.pbrt, 128x128: the glass sphere answered
    by the sphere block after K1's triangles) and an MLT step (mlt.pbrt,
    256 chains), launches counted from zero, each query bit-equal key by
    key, kernel and twin timed, with the bound."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    out = {}
    for kind in ("lightpath", "bdpt", "sppm", "mlt"):
        rp = lt_pass(kind, dev, 128 if kind != "mlt" else 48)
        STATS.reset()
        queries = _k1_queries(rp)
        torch.cuda.synchronize()
        launches = STATS.launches
        want = LT_K1_PER_PASS[kind]
        if launches != want or len(queries) != launches:
            raise AssertionError(f"{kind}: {launches} K1 launches, "
                                 f"{len(queries)} queries, {want} expected")
        path = {"lightpath": LT_ROOM, "bdpt": LT_ROOM, "sppm": LT_CAUSTIC,
                "mlt": LT_MLT}[kind]
        scene = lt_scene(dev, path, 8)[0]
        out[kind] = {"launches": launches,
                     "spheres": scene.geom.num_spheres,
                     **_hold_k1(scene.small, queries, kind)}
        STATS.reset()
    emit("c8_k1_lighttransport_vs_twin", **out)
    return out


def _mlt_chains(dev, spp: int) -> dict:
    """d23's chain count: the file's 256 unless `spp` mutations per pixel
    over 48x48 (spp * 9 steps) would exceed MLT_STEPS_BUDGET_S at the
    time of the first steps (timed after a warm-up step), then the
    reference parser's default."""
    import torch

    scene, camera, integ = lt_scene(dev, LT_MLT, 8)
    nx, ny = 48, 48
    steps = spp * nx * ny // integ.n_chains
    rp = lt_pass("mlt", dev, nx, chains=integ.n_chains)
    rp(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(1, 9):
        rp(p)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 8
    fits = step_s * steps <= MLT_STEPS_BUDGET_S
    return {"file_chains": integ.n_chains, "file_steps": steps,
            "step_seconds_at_file_chains": step_s,
            "estimated_seconds_at_file_chains": step_s * steps,
            "chains": integ.n_chains if fits else MLT_DEFAULT_CHAINS}


def phase_golden_mc(dev):
    """d23: bdpt.pbrt (256 spp in passes of 16), sppm.pbrt (32
    iterations) and mlt.pbrt (256 mutations per pixel) through the
    port's parser and its file entry (render.render_file) on the card,
    seed 1, against the pbrt-v4 C++ goldens with
    tests/test_reference_parity.py's MC_CASES gate (relative mean error,
    MSE); each launches K1."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.io.image import read_pfm
    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render_file

    for name, spp, (rel_tol, mse_tol) in MC_GOLDENS:
        scene, camera, settings = load_pbrt(
            os.path.join(GOLDEN_FILES, name + ".pbrt"), device=dev)
        extra = {}
        if name == "mlt":
            extra = _mlt_chains(dev, spp)
            settings = dict(settings, integrator=settings["integrator"].replace(
                n_chains=extra["chains"]))
        STATS.reset()
        t0 = time.perf_counter()
        img = render_file(scene, camera, settings, spp=spp, seed=MC_SEED,
                          samples_per_pass=16, device=dev)
        img = img.cpu().numpy()
        seconds = time.perf_counter() - t0
        ref = read_pfm(os.path.join(GOLDEN_FILES, name + "_ref.pfm"))
        if img.shape != ref.shape or not np.isfinite(img).all():
            raise AssertionError(f"{name}: bad render, shape {img.shape}")
        rel = float(abs(img.mean() - ref.mean()) / ref.mean())
        mse = float(np.mean((img - ref) ** 2))
        emit(f"d23_golden_{name}", integrator=type(
                 settings["integrator"]).__name__, spp=spp, seed=MC_SEED,
             seconds=seconds, rel_mean_err=rel, mse=mse,
             mean=float(img.mean()), golden_mean=float(ref.mean()),
             k1_launches=STATS.launches,
             bounds={"rel_mean_err": rel_tol, "mse": mse_tol}, **extra)
        torch.cuda.synchronize()
        if not (rel < rel_tol and mse < mse_tol):
            raise AssertionError(f"{name}.pbrt off the C++ golden: rel {rel}, "
                                 f"MSE {mse}")
        if STATS.launches == 0:
            raise AssertionError(f"{name}.pbrt launched no K1")


def phase_golden_lighttransport_jax(dev):
    """d24: the light path (4 passes of 256 paths), BDPT (4 spp in passes
    of 2), AO (4 spp) and the spectral bands (4 bands, 2 spp a band,
    depth 3) on bdpt.pbrt's room at 16x16, 8 lanes, seed 0, against the
    JAX goldens of scripts/make_torch_port_golden_lighttransport.py, with
    d's gate (>= 99% of values within rtol 1e-3 / atol 1e-5)."""
    import numpy as np

    from pbrt_tpu_torch.models.ao import AOIntegrator
    from pbrt_tpu_torch.models.bdpt import render_bdpt
    from pbrt_tpu_torch.models.lightpath import render_lightpath
    from pbrt_tpu_torch.models.spectralpath import render_spectral
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render

    scene, camera, _ = lt_scene(dev, LT_ROOM, 16)
    ao = np.load(os.path.join(GOLDEN_DATA, "ao16.npz"))
    spectral = np.load(os.path.join(GOLDEN_DATA, "spectral16.npz"))
    renders = {
        "lightpath": (lambda: render_lightpath(
            scene, camera, n_paths_total=1024, paths_per_pass=256,
            n_spectrum=8, device=dev),
            np.load(os.path.join(GOLDEN_DATA, "lightpath16_spp4.npy"))),
        "bdpt": (lambda: render_bdpt(scene, camera, spp=4,
                                     samples_per_pass=2, n_spectrum=8,
                                     device=dev),
                 np.load(os.path.join(GOLDEN_DATA, "bdpt16_spp4.npy"))),
        "ao": (lambda: render(scene, camera, AOIntegrator(), spp=4,
                              samples_per_pass=4, n_spectrum=8, device=dev),
               ao["ao_image"]),
        "spectral": (lambda: render_spectral(
            scene, camera, n_bands=4, spp_per_band=2, max_depth=3,
            n_spectrum=8, device=dev), (spectral["rgb"], spectral["bands"])),
    }
    out, worst = {}, 1.0
    for name, (fn, golden) in renders.items():
        STATS.reset()
        img = fn()
        launches = STATS.launches
        if name == "spectral":
            share_rgb, fields = _golden_gate(img[0].cpu().numpy(), golden[0])
            share_bands, bands = _golden_gate(img[1].cpu().numpy(), golden[1])
            share = min(share_rgb, share_bands)
            fields = {"rgb": fields, "bands": bands}
        else:
            share, fields = _golden_gate(img.cpu().numpy(), golden)
        out[name] = {**fields, "k1_launches": launches}
        worst = min(worst, share)
        if launches == 0:
            raise AssertionError(f"{name}: no K1 launch")
    emit("d24_golden_lighttransport_jax", resolution=16, lanes=8, **out)
    if worst < 0.99:
        raise AssertionError(f"light transport: only {worst:.4f} of values "
                             "match the JAX goldens")


def _lt_layers(kind: str, render_pass) -> dict:
    """The device ms of one pass by layer (CUDA events around the
    outermost calls): BDPT's two walks, its connection queries, BxDF
    calls and splat rows; SPPM's camera pass, grid and photon pass (its
    deposits inside it); MLT's contribution (the path trace) against the
    rest of a step."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.accel import api as accel_api
    from pbrt_tpu_torch.materials import bxdf
    from pbrt_tpu_torch.models import bdpt, lightpath, mlt, sppm

    timer, inner = ptp.LayerTimer(), ptp.LayerTimer()
    spots = {
        "bdpt": [(timer, bdpt.BDPTIntegrator, "_walk", "walks"),
                 (timer, accel_api, "any_hit", "connection_queries"),
                 (timer, bxdf, "evaluate", "bxdf"),
                 (timer, bxdf, "pdf", "bxdf"),
                 (timer, lightpath, "splat_rows", "splats")],
        "sppm": [(timer, sppm.SPPMIntegrator, "_camera_pass", "camera_pass"),
                 (timer, sppm.SPPMIntegrator, "_build_grid", "grid"),
                 (timer, sppm.SPPMIntegrator, "_photon_pass", "photon_pass"),
                 (inner, sppm.SPPMIntegrator, "_deposit", "deposits")],
        "mlt": [(timer, mlt, "_contribution", "contribution")],
    }[kind]
    # The raw class or module entries (a staticmethod stays one).
    saved = [(owner, attr, vars(owner)[attr]) for _, owner, attr, _ in spots]
    for (t, owner, attr, name), (_, _, raw) in zip(spots, saved):
        wrapped = t.wrap(name, getattr(owner, attr))
        setattr(owner, attr, staticmethod(wrapped)
                if isinstance(raw, staticmethod) else wrapped)
    try:
        # The caller's timed passes have warmed render_pass.
        torch.cuda.synchronize()
        for t in (timer, inner):
            t.events.clear()
        t0 = time.perf_counter()
        render_pass(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    layers = {**timer.totals_ms(), **inner.totals_ms()}
    layers["other"] = wall_ms - sum(timer.totals_ms().values())
    return {"wall_ms": wall_ms, "layers_ms": layers}


def _lt_timed(kind: str, render_pass, passes: int, per_pass: str,
              smi: str, **fields) -> dict:
    """Time `passes` passes after a warm-up: the pass's work per second,
    K1 launches and ms per pass, peak memory, the layers of one pass,
    kernel launches per pass and the busy share (torch.profiler)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.ops.smallscene import STATS

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    render_pass(0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    STATS.reset(timed=True)
    t0 = time.perf_counter()
    work = 0
    for p in range(1, passes + 1):
        img, n = render_pass(p)
        work += n
    finite = bool(torch.isfinite(img).all())
    seconds = time.perf_counter() - t0
    k1_ms = STATS.elapsed_ms()
    launches = STATS.launches
    STATS.reset()
    peak = torch.cuda.max_memory_allocated()
    layers = _lt_layers(kind, render_pass)
    kern = ptp.kernel_view(f"{kind}_{fields.get('chains', '')}",
                           lambda: render_pass(passes + 3), out_dir,
                           warm=False)
    out = {"passes": passes, per_pass: work, "seconds": seconds,
           f"{per_pass}_per_s": work / seconds,
           "passes_per_s": passes / seconds, "first_pass_seconds": first_s,
           "k1_launches_per_pass": launches / passes,
           "k1_ms_per_pass": k1_ms / passes,
           "k1_share": k1_ms / (seconds * 1e3), "peak_bytes": peak,
           "image_mean": float(img.mean()), **layers,
           "kernel_launches_per_pass": kern["kernel_launches"],
           "device_busy_share": kern["device_busy_share"],
           "device_kernel_ms": kern["device_kernel_ms"],
           "profiled_pass_wall_ms": kern["wall_ms"], "top_kernels": kern["top"],
           "nvidia_smi": smi, **fields}
    if not finite:
        raise AssertionError(f"{kind}: non-finite image, {out}")
    return out


def phase_timed_lighttransport(dev, smi: str):
    """e11: BDPT on bdpt.pbrt's room at 256x256, 8 spp in passes of 4
    (262,144 bidirectional samples a pass), depth 5, 8 lanes: paths/s;
    SPPM on sppm.pbrt at 256x256 (65,536 camera paths and 65,536 photons
    an iteration), 4 iterations: iterations/s and photons/s; MLT on
    mlt.pbrt at 48x48 with 256 and 4,096 chains, 16 steps: mutations/s.
    Each with K1 launches per pass, peak memory, its layers, kernel
    launches per pass and the busy share."""
    e = E11
    res = e["res"]
    out = _lt_timed("bdpt", lt_pass("bdpt", dev, res, k=e["bdpt_k"]),
                    e["bdpt_spp"] // e["bdpt_k"], "paths", smi,
                    resolution=res, samples_per_pass=e["bdpt_k"],
                    spp=e["bdpt_spp"], max_depth=e["depth"], lanes=e["lanes"])
    emit("e11_timed_bdpt", **out)
    out = _lt_timed("sppm", lt_pass("sppm", dev, res), e["sppm_iterations"],
                    "photons", smi, resolution=res,
                    camera_paths_per_iteration=res * res,
                    max_depth=e["depth"], lanes=e["lanes"])
    out["iterations_per_s"] = out.pop("passes_per_s")
    emit("e11_timed_sppm", **out)
    for chains in e["mlt_chains"]:
        out = _lt_timed("mlt", lt_pass("mlt", dev, 48, chains=chains),
                        e["mlt_steps"], "mutations", smi, chains=chains,
                        resolution=48, max_depth=e["depth"], lanes=e["lanes"])
        out["steps_per_s"] = out.pop("passes_per_s")
        emit("e11_timed_mlt", **out)


# ---- PR: the rest of the geometry (c9, d25, e12, g7)

SHAPES_FILE = os.path.join(GOLDEN_DATA, "shapes.pbrt")
MOTION_FILE = os.path.join(GOLDEN_DATA, "motion.pbrt")
GOLDEN_MOTION_GRAD = os.path.join(GOLDEN_DATA, "motion32_grad.npz")
# e12's configuration (the families box's).
GEOM = dict(res=512, spp=4, k=4, depth=5, lanes=8)
# Triangle-kernel queries of one pass of either file: with alpha in the
# scene a closest query is the first query and 3 restarts
# (accel/api.py _ALPHA_ROUNDS), and a shadow query runs the same loop; a
# closest and a shadow query a bounce, then the terminal closest.
GEOM_QUERIES_PER_PASS = 2 * 4 * GEOM["depth"] + 4
_GEOM_SCENES = {}


def geom_on(dev, name: str):
    """shapes.pbrt or motion.pbrt through the port's parser on the card
    (built once): (scene, camera, integrator)."""
    from pbrt_tpu_torch.io.parser import load_pbrt

    if name not in _GEOM_SCENES:
        t0 = time.perf_counter()
        built = load_pbrt(SHAPES_FILE if name == "shapes" else MOTION_FILE,
                          device=dev)
        _GEOM_SCENES[name] = (built, time.perf_counter() - t0)
    (scene, camera, settings), _ = _GEOM_SCENES[name]
    return scene, camera, settings["integrator"]


def coarse_alpha_keys():
    """The port's stochastic alpha test on coarse keys within the block, as
    the shapes goldens were made (tests/torch_port_shapes.py)."""
    from pbrt_tpu_torch.accel import api
    from tests.torch_port_shapes import coarse_alpha_keys as coarse

    return coarse(api)


def _k3_queries(render_pass):
    """Every K3 query of one render_pass(0) call, as the path sends it
    (sorted rays): [(o, d, tmax, any_hit)]; they still launch the kernel."""
    from pbrt_tpu_torch.accel import api

    queries = []
    launch = api.sweep_intersect

    def capture(acc, o, d, tmax, any_hit=False, **kw):
        queries.append((o.clone(), d.clone(), tmax.clone(), any_hit))
        return launch(acc, o, d, tmax, any_hit=any_hit, **kw)

    api.sweep_intersect = capture
    try:
        render_pass(0)
    finally:
        api.sweep_intersect = launch
    return queries


def _hold_k3(acc, queries, label: str) -> dict:
    """Each captured K3 query against the twin, bit for bit key by key,
    with the kernel's and the twin's times and the bound of c3's cost
    model (_k3_timed) from the twin's work counts."""
    import torch

    from pbrt_tpu_torch.ops.sweep import sweep_intersect, sweep_intersect_ref

    per_query, ms, plain_ms, bound_ms, err = [], 0.0, 0.0, 0.0, 0.0
    for i, (o, d, tmax, any_hit) in enumerate(queries):
        got = sweep_intersect(acc, o, d, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        counts = {}
        t0 = time.perf_counter()
        ref = sweep_intersect_ref(acc, o, d, tmax, any_hit=any_hit,
                                  counts=counts)
        torch.cuda.synchronize()
        q_plain = (time.perf_counter() - t0) * 1e3
        bad = [key for key in ref if not torch.equal(got[key], ref[key])]
        if set(got) != set(ref) or bad:
            raise AssertionError(f"{label} query {i}: K3 differs from its "
                                 f"twin in {bad} (any_hit {any_hit})")
        q_ms = cuda_ms(lambda: sweep_intersect(acc, o, d, tmax,
                                               any_hit=any_hit), reps=10)
        n = int(o.shape[0])
        bound = _bound(
            counts["pairs"] * 128 * MT_OPS + counts["instances"] * XFORM_OPS,
            n * (28 + 12) + acc.n_clusters * (128 * 10 * 4 + 32)
            + acc.n_instances * (12 + 8 + 2) * 4)
        err = max(err, max_abs_err(got, ref))
        ms += q_ms
        plain_ms += q_plain
        bound_ms += bound["bound_ms"]
        per_query.append({"mode": "any_hit" if any_hit else "closest",
                          "rays": n, "live": int((tmax > 0).sum()),
                          "hits": int((ref["prim"] >= 0).sum()),
                          "ms": q_ms, "plain_ms": q_plain,
                          "bound_ms": bound["bound_ms"],
                          "bound_by": bound["bound_by"]})
    return {"queries": len(queries), "instances": acc.n_instances,
            "entries": acc.n_entries, "ms_per_pass": ms,
            "plain_ms_per_pass": plain_ms, "bound_ms_per_pass": bound_ms,
            "max_abs_err": err, "per_query": per_query}


def _name_alpha_queries(per_query, depth: int):
    """Label the 4 queries of each alpha loop: the first query and its
    restarts, a closest and a shadow loop a bounce, the terminal loop."""
    for i, q in enumerate(per_query):
        loop = i // 4
        kind = ("terminal" if loop == 2 * depth else
                ("closest", "shadow")[loop % 2])
        q["query"] = kind + ("" if i % 4 == 0 else f"_restart{i % 4}")


def phase_geometry_vs_twin(dev):
    """c9: K1 against its twin on every query of one shapes.pbrt pass
    (128x128, 8 spp, depth 5: the alpha restart queries included) and K3
    against its twin on every query of one motion.pbrt pass (32x32, 4
    spp), launches counted from zero, each query bit-equal key by key,
    kernel and twin timed."""
    import torch

    from pbrt_tpu_torch.ops import smallscene, sweep

    depth = GEOM["depth"]
    out = {}
    for name, res, k in (("shapes", 128, 8), ("motion", 32, 4)):
        scene, camera, _ = geom_on(dev, name)
        rp = make_pass(scene, camera.replace(resolution=(res, res)), res, k,
                       GEOM["lanes"], depth=depth)
        stats = smallscene.STATS if name == "shapes" else sweep.STATS
        smallscene.STATS.reset()
        sweep.STATS.reset()
        queries = (_k1_queries if name == "shapes" else _k3_queries)(rp)
        torch.cuda.synchronize()
        launches = stats.launches
        other = (sweep.STATS if name == "shapes" else smallscene.STATS).launches
        if (launches != GEOM_QUERIES_PER_PASS or len(queries) != launches
                or other):
            raise AssertionError(f"{name}: {launches} launches, "
                                 f"{len(queries)} queries, {other} of the "
                                 f"other kernel, {GEOM_QUERIES_PER_PASS} "
                                 "expected")
        held = (_hold_k1(scene.small, queries, name) if name == "shapes"
                else _hold_k3(scene.sweep, queries, name))
        _name_alpha_queries(held["per_query"], depth)
        out[name] = {"kernel": "k1" if name == "shapes" else "k3",
                     "resolution": res, "spp": k, "launches": launches,
                     **held}
    smallscene.STATS.reset()
    sweep.STATS.reset()
    emit("c9_geometry_vs_twin", max_depth=depth, **out)


def phase_golden_geometry_jax(dev):
    """d25: shapes.pbrt (the stochastic alpha test on coarse keys) and
    motion.pbrt at 32x32, 4 spp, 8 lanes, depth 5, against the JAX goldens
    of scripts/make_torch_port_golden_shapes.py with d's gate; 44 K1
    (shapes) or K3 (motion) launches per pass."""
    import contextlib

    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import smallscene, sweep
    from pbrt_tpu_torch.render import render

    for name in ("shapes", "motion"):
        scene, camera, integ = geom_on(dev, name)
        golden = np.load(os.path.join(GOLDEN_DATA, f"{name}32_spp4.npy"))
        smallscene.STATS.reset()
        sweep.STATS.reset()
        with (coarse_alpha_keys() if name == "shapes"
              else contextlib.nullcontext()):
            img = render(scene, camera.replace(resolution=(32, 32)), integ,
                         spp=4, samples_per_pass=4, seed=0, n_spectrum=8,
                         device=dev)
        torch.cuda.synchronize()
        k1, k3 = smallscene.STATS.launches, sweep.STATS.launches
        share, fields = _golden_gate(img.cpu().numpy(), golden)
        emit(f"d25_golden_{name}_jax", resolution=32, spp=4,
             max_depth=integ.max_depth, lanes=8, **fields,
             image_mean_diff=fields["mean"] - fields["golden_mean"],
             k1_launches=k1, k3_launches=k3,
             expected=GEOM_QUERIES_PER_PASS)
        if share < 0.99:
            raise AssertionError(f"{name}: only {share:.4f} of pixel values "
                                 "match the JAX golden")
        want = (GEOM_QUERIES_PER_PASS, 0) if name == "shapes" else (
            0, GEOM_QUERIES_PER_PASS)
        if (k1, k3) != want:
            raise AssertionError(f"{name}: {k1} K1 and {k3} K3 launches")


def _geometry_layers(render_pass) -> dict:
    """e5's layers of one pass (CUDA events around each path layer's
    top-level calls), with the queries split from the inside: the
    triangle tier with its alpha restart loop, the animated pass, the
    sphere, curve and disk / cylinder / patch merges (and the analytic
    families' occlusion of shadow rays), and within those the K1 / K3
    launches, K3's ray sorts and attribute resolution and the alpha
    evaluations (the alpha of a hit and the test's hash)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.accel import api

    outer, mid, inner = ptp.LayerTimer(), ptp.LayerTimer(), ptp.LayerTimer()
    wraps = [(mid, "triangles_with_alpha_restarts", "_tri_closest"),
             (mid, "triangles_with_alpha_restarts", "_tri_any"),
             (mid, "animated", "animated_best"),
             (mid, "animated", "animated_any"),
             (mid, "spheres", "_merge_spheres"),
             (mid, "curves", "_merge_curves"),
             (mid, "disk_cyl_blp", "_merge_disk_cyl"),
             (mid, "any_hit_analytic", "_merge_anyhit_quadrics"),
             (inner, "k1", "smallscene_intersect"),
             (inner, "k3", "sweep_intersect"),
             (inner, "k3_ray_sort", "ray_sort_perm"),
             (inner, "k3_resolve", "resolve_tri_attrs_inst"),
             (inner, "alpha_eval", "_alpha_at"),
             (inner, "alpha_eval", "_alpha_rand")]
    saved = [(attr, getattr(api, attr)) for _, _, attr in wraps]
    with ptp.wrapped_layers(outer):
        for timer, name, attr in wraps:
            setattr(api, attr, timer.wrap(name, getattr(api, attr)))
        try:
            # The caller's timed passes have warmed render_pass.
            torch.cuda.synchronize()
            for t in (outer, mid, inner):
                t.events.clear()
            t0 = time.perf_counter()
            render_pass()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for attr, fn in saved:
                setattr(api, attr, fn)
    layers = outer.totals_ms()
    layers["other"] = wall_ms - sum(layers.values())
    layers = {key.replace("k1_", "queries_"): ms for key, ms in layers.items()}
    return {"wall_ms": wall_ms, "layers_ms": layers,
            "queries_split_ms": mid.totals_ms(),
            "kernels_and_alpha_ms": inner.totals_ms()}


def phase_timed_geometry(dev, smi: str) -> dict:
    """e12: shapes.pbrt and motion.pbrt timed at 512x512, one pass of 4
    spp (1,048,576 camera rays), depth 5 without Russian roulette,
    8 lanes, seed 0, the exact alpha keys: Mrays/s, the wall a pass, K1 /
    K3 launches a pass, peak memory, the first pass's seconds, the layers
    (_geometry_layers), kernel launches a pass and the busy share
    (torch.profiler). Returns each file's K1 and K3 launches of its timed
    passes."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.ops import smallscene, sweep

    g = GEOM
    res, k, passes = g["res"], g["k"], g["spp"] // g["k"]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    launches = {}
    for name in ("shapes", "motion"):
        scene, camera, _ = geom_on(dev, name)
        camera = camera.replace(resolution=(res, res))
        render_pass = make_pass(scene, camera, res, k, g["lanes"],
                                depth=g["depth"])
        t0 = time.perf_counter()
        render_pass(0)  # warm-up
        first_s = time.perf_counter() - t0
        out = timed_forward(render_pass, passes,
                            {"k1": smallscene.STATS, "k3": sweep.STATS})
        want = GEOM_QUERIES_PER_PASS * passes
        if (out["k1_launches"], out["k3_launches"]) != (
                (want, 0) if name == "shapes" else (0, want)):
            raise AssertionError(f"timed {name}: {out['k1_launches']} K1 and "
                                 f"{out['k3_launches']} K3 launches")
        launches[name] = (out["k1_launches"], out["k3_launches"])
        layers = _geometry_layers(render_pass)
        kern = ptp.kernel_view(g["lanes"], render_pass, out_dir,
                               warm=False)
        emit(f"e12_timed_{name}", lanes=g["lanes"], resolution=res,
             spp=g["spp"], samples_per_pass=k, max_depth=g["depth"],
             rays_per_pass_camera=res * res * k, **out,
             wall_ms_per_pass=out["seconds"] * 1e3 / passes,
             k1_launches_per_pass=out["k1_launches"] / passes,
             k3_launches_per_pass=out["k3_launches"] / passes,
             scene_build_seconds=_GEOM_SCENES[name][1],
             first_pass_seconds=first_s, layers=layers,
             kernel_launches_per_pass=kern["kernel_launches"],
             device_busy_share=kern["device_busy_share"],
             device_kernel_ms=kern["device_kernel_ms"],
             profiled_pass_wall_ms=kern["wall_ms"], top_kernels=kern["top"],
             nvidia_smi=smi)
    return launches


def phase_grad_motion(dev):
    """g7: the bench's loss and gradients (materials.albedo_coeffs,
    lights.area_scale, the remat path) on motion.pbrt at 32x32, 4 spp in
    passes of 2, depth 5 without Russian roulette, 8 lanes, on the card
    against the JAX golden (tests/data/torch_port/motion32_grad.npz) with
    phase g's tolerance; 44 K3 launches per forward+backward pass, a
    forward's (geometry is detached: the moving instances change only
    which surface a ray hits)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops import sweep

    z = np.load(GOLDEN_MOTION_GRAD)
    res, k, lanes = int(z["resolution"]), int(z["samples_per_pass"]), \
        int(z["n_spectrum"])
    passes, depth = int(z["spp"]) // k, int(z["max_depth"])
    if int(z["rr_start_depth"]) != depth:
        raise AssertionError("the golden's Russian roulette is not off")
    want = {"materials.albedo_coeffs": z["grad_albedo_coeffs"],
            "lights.area_scale": z["grad_area_scale"]}
    scene, camera, _ = geom_on(dev, "motion")
    sweep.STATS.reset()
    t0 = time.perf_counter()
    loss, grads = grad_passes(scene, camera, res, k, lanes, passes, depth)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = sweep.STATS.launches
    vs_jax = _grad_compare(loss, grads, float(z["loss"]), want)
    emit("g7_grad_motion", resolution=res, spp=int(z["spp"]),
         samples_per_pass=k, lanes=lanes, max_depth=depth, loss=loss,
         golden_loss=float(z["loss"]), vs_jax=vs_jax, k3_launches=launches,
         passes=passes, k3_launches_per_pass=launches / passes,
         expected_per_pass=GEOM_QUERIES_PER_PASS, card_seconds=card_s,
         tolerance={"grad_of_max": GRAD_RTOL_OF_MAX, "loss_rel": LOSS_RTOL})
    if not vs_jax["ok"]:
        raise AssertionError("motion.pbrt gradients disagree with the golden")
    if launches != GEOM_QUERIES_PER_PASS * passes:
        raise AssertionError(f"{launches} K3 launches for {passes} "
                             "forward+backward passes")


CAMERA_RENDER_QUERIES = 2 * LENS["depth"] + 1  # a depth-5 pass's K1 queries


def _cameras():
    from tests import torch_port_cameras as cams

    return cams


def phase_k1_cameras_vs_twin(dev):
    """c10: K1 against its twin on every query of one cornell_lens pass
    (64x64, 4 spp: the doublet with its exit pupil, zsobol, a gaussian
    filter; the vignetted lanes traced as the path sends them) and of the
    GBuffer pass (render_aovs at 32x32, 2 spp: the path's queries and
    the first-hit closest query), launches counted from zero, each query
    bit-equal key by key, kernel and twin timed, with the bound."""
    import torch

    from pbrt_tpu_torch.films.gbuffer import render_aovs
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS

    scene, camera = cornell_on(dev)
    out = {}
    passes = {
        "cornell_lens": (lens_pass(dev, 64, 4, LENS["lanes"]),
                         CAMERA_RENDER_QUERIES),
        "gbuffer": (lambda _p: render_aovs(
            scene, camera, PathIntegrator(max_depth=LENS["depth"]), spp=2,
            spectral_buckets=8, n_spectrum=LENS["lanes"], device=dev),
                    CAMERA_RENDER_QUERIES + 1),
    }
    for name, (rp, want) in passes.items():
        STATS.reset()
        queries = _k1_queries(rp)
        torch.cuda.synchronize()
        launches = STATS.launches
        if launches != want or len(queries) != launches:
            raise AssertionError(f"{name}: {launches} K1 launches, "
                                 f"{len(queries)} queries, {want} expected")
        out[name] = {"launches": launches,
                     "camera_query_live_lanes": int((queries[0][2] > 0).sum()),
                     **_hold_k1(scene.small, queries, name)}
    STATS.reset()
    emit("c10_k1_cameras_vs_twin", **out)
    return out


def phase_golden_cameras_jax(dev):
    """d26: the Cornell box through each camera family
    (tests/torch_port_cameras.py) at 32x32 against the JAX goldens of
    scripts/make_torch_port_golden_cameras.py, with d's gate: the doublet
    with its exit pupil (zsobol, gaussian filter), the omni .json lens
    with its microlens array (sobol, triangle), the orthographic (halton,
    mitchell), spherical (pmj02bn) and RTF (fitted to the doublet, its
    coefficients carried across; stratified, lanczos) cameras at 4 spp in
    one pass, the Navarro eye with HURB diffraction through
    render_spectral's 4 bands of 2 spp, and every channel of render_aovs
    (4 spp, 8 spectral buckets). Each prints its share of camera rays with
    weight > 0 and its mean; an unlit image fails; 11 K1 launches a
    pass."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.films.gbuffer import render_aovs
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.models.spectralpath import render_spectral
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import camera_rays_full, render
    from pbrt_tpu_torch.samplers.samplers import Sampler

    cams = _cameras()
    cfg = cams.CFG
    golden = np.load(cams.GOLDEN)
    scene, persp = cornell_on(dev)
    res, spp = cfg["res"], cfg["spp"]
    integ = PathIntegrator(max_depth=cfg["max_depth"])
    results = {}

    def gate(name, img, want, launches, expected, lit=True, **extra):
        share, fields = _golden_gate(img, want)
        results[name] = {**fields, "k1_launches": launches, **extra}
        if share < 0.99 or (lit and not fields["mean"] > 0.0):
            raise AssertionError(f"d26 {name}: {share:.4f} of the values match "
                                 f"the golden, mean {fields['mean']}")
        if launches != expected:
            raise AssertionError(f"d26 {name}: {launches} K1 launches, "
                                 f"{expected} expected")

    for name, (kind, filt) in cams.RENDERS.items():
        cam = cams.port_camera(name, golden, res).to(dev)
        STATS.reset()
        img = render(scene, cam, integ, spp=spp, seed=cfg["seed"],
                     samples_per_pass=spp, sampler_kind=kind,
                     filter_kind=filt, n_spectrum=cfg["n_spectrum"],
                     device=dev)
        torch.cuda.synchronize()
        launches = STATS.launches
        sampler = Sampler.create(kind, spp=spp, nx=res,
                                 log2_res=max(1, (res - 1).bit_length()))
        pixel = torch.arange(res * res, device=dev).repeat(spp)
        sample = torch.arange(spp, device=dev).repeat_interleave(res * res)
        w = camera_rays_full(cam, pixel, sample, sampler)[3]
        share_w = float((w > 0).float().mean())
        gate(name, img.cpu().numpy(), golden[name], launches,
             CAMERA_RENDER_QUERIES, sampler=kind, filter=filt,
             weight_positive_share=share_w,
             golden_weight_positive_share=float(golden[name + "_share"]))
        if abs(share_w - float(golden[name + "_share"])) > 1e-3:
            raise AssertionError(f"d26 {name}: weight > 0 on {share_w} of the "
                                 "camera rays against the reference's "
                                 f"{float(golden[name + '_share'])}")
    STATS.reset()
    rgb, bands = render_spectral(scene, cams.eye_factory("pbrt_tpu_torch", res),
                                 seed=cfg["seed"], n_spectrum=cfg["n_spectrum"],
                                 device=dev, **cams.EYE_CFG)
    torch.cuda.synchronize()
    launches = STATS.launches
    eye = cams.eye_factory("pbrt_tpu_torch", res)(560.0).to(dev)
    pixel = torch.arange(res * res, device=dev).repeat(2)
    sample = torch.arange(2, device=dev).repeat_interleave(res * res)
    w = camera_rays_full(eye, pixel, sample, 0, n_spectrum=cfg["n_spectrum"])[3]
    expected = CAMERA_RENDER_QUERIES * cams.EYE_CFG["n_bands"]
    gate("eye_rgb", rgb.cpu().numpy(), golden["eye_rgb"], launches, expected,
         weight_positive_share=float((w > 0).float().mean()))
    gate("eye_bands", bands.cpu().numpy(), golden["eye_bands"], launches,
         expected)
    STATS.reset()
    aovs = render_aovs(scene, persp, integ, seed=cfg["seed"],
                       n_spectrum=cfg["n_spectrum"], device=dev,
                       **cams.AOV_CFG)
    torch.cuda.synchronize()
    launches = STATS.launches
    for channel, img in aovs.items():
        gate("aov_" + channel, img.cpu().numpy(), golden["aov_" + channel],
             launches, CAMERA_RENDER_QUERIES + 1, lit=channel == "rgb")
    emit("d26_golden_cameras_jax", resolution=res, spp=spp,
         lanes=cfg["n_spectrum"], renders=results)


SAMPLER_DIMS_FILE = os.path.join(ROOT, "chiprun_out", "sampler_cpu_digests.npz")
COATED_CPU_FILE = os.path.join(ROOT, "chiprun_out", "coated_cpu_grads.npz")


def _cpu_sampler_digests(path: str) -> None:
    """d27's CPU side, run in a background process from the start of the
    script: the sha256 digests of every sampler kind's draws (get_1d and
    get_2d of dimensions 0-40, get_1d_run of dimensions 3-8) at
    1,048,576 lanes of the settings "c" of tests/torch_port_cameras.py,
    on the CPU, saved to `path`."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.samplers.samplers import Sampler

    t0 = time.perf_counter()
    cams = _cameras()
    torch.set_num_threads(4)
    cfg = cams.SAMPLER_CFGS["c"]
    pixel, sample = (torch.from_numpy(a.astype(np.int64))
                     for a in cams.draw_lanes(1 << 20, cfg))
    out = {}
    for kind in cams.SAMPLER_KINDS:
        s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"],
                           nx=cfg["nx"], log2_res=cfg["log2_res"])
        out[kind] = cams.digests(v.numpy() for v in
                                 cams.draws(s, pixel, sample))
        run = s.get_1d_run(pixel, sample, 3, 6)
        out[kind + "_run"] = cams.digests(run[:, j].numpy() for j in range(6))
    tmp = path + ".tmp.npz"
    np.savez(tmp, child_seconds=time.perf_counter() - t0, **out)
    os.replace(tmp, path)


def start_cpu_child(flag: str, path: str):
    """Start this script with `flag path` (--cpu-sampler-digests or
    --cpu-coated-grads) in a child process at the lowest priority; returns
    it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             flag, path], cwd=ROOT)


def phase_samplers_and_resume(dev, cpu_digests):
    """d27: every sampler kind's get_1d and get_2d of dimensions 0-40 and
    get_1d_run of dimensions 3-8 at 1,048,576 lanes on the card, bit for
    bit the port's CPU draws of the same lanes (sha256 digests of each
    draw, the CPU's from the background process started with the script);
    at 4,096 lanes under settings a and b, bit for bit the committed JAX
    draws of scripts/make_torch_port_golden_cameras.py; then
    render_resumable, stopped after its first chunk and resumed, equal to
    the one-shot render_resumable on the card, bit for bit."""
    import tempfile

    import numpy as np
    import torch

    from pbrt_tpu_torch.films.checkpoint import render_resumable, save_checkpoint
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.samplers.samplers import Sampler

    cams = _cameras()
    jax_draws = np.load(cams.SAMPLER_GOLDEN)
    t0 = time.perf_counter()
    gpu = {}
    for kind in cams.SAMPLER_KINDS:
        cfg = cams.SAMPLER_CFGS["c"]
        s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"],
                           nx=cfg["nx"], log2_res=cfg["log2_res"])
        pixel, sample = (torch.from_numpy(a.astype(np.int64)).to(dev)
                         for a in cams.draw_lanes(1 << 20, cfg))
        gpu[kind] = cams.digests(v.cpu().numpy() for v in
                                 cams.draws(s, pixel, sample))
        run = s.get_1d_run(pixel, sample, 3, 6).cpu()
        gpu[kind + "_run"] = cams.digests(run[:, j].numpy() for j in range(6))
        for cfg_name in ("a", "b"):
            cfg = cams.SAMPLER_CFGS[cfg_name]
            s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"],
                               nx=cfg["nx"], log2_res=cfg["log2_res"])
            pixel, sample = (torch.from_numpy(a.astype(np.int64)).to(dev)
                             for a in cams.draw_lanes(cams.DRAW_LANES, cfg))
            vals = [v.cpu().numpy() for v in cams.draws(s, pixel, sample)]
            bad = np.nonzero(cams.digests(vals)
                             != jax_draws[f"{kind}_{cfg_name}_digest"])[0]
            if bad.size:
                raise AssertionError(f"d27 {kind} {cfg_name}: draws (dim, "
                                     "component) "
                                     f"{[divmod(int(b), 3) for b in bad]} "
                                     "differ from the JAX golden")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = cpu_digests.wait(timeout=900)
    wait_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"d27: the CPU draws' process exited {rc}")
    cpu = np.load(SAMPLER_DIMS_FILE)
    for key, digests in gpu.items():
        bad = np.nonzero(digests != cpu[key])[0]
        if bad.size:
            raise AssertionError(f"d27 {key}: card draws {bad.tolist()} differ "
                                 "from the CPU's")
    scene, _ = cornell_on(dev)
    cam = cams.lens_camera("pbrt_tpu_torch", 32).to(dev)
    integ = PathIntegrator(max_depth=LENS["depth"])
    kw = dict(seed=3, samples_per_pass=4, chunk_spp=8, sampler_kind="zsobol",
              filter_kind="gaussian", n_spectrum=LENS["lanes"], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        whole = render_resumable(scene, cam, integ, 24,
                                 os.path.join(tmp, "whole.npz"), **kw)
        first = render(scene, cam, integ, spp=8, seed=3, samples_per_pass=4,
                       sample_offset=0, total_spp=24, sampler_kind="zsobol",
                       filter_kind="gaussian", n_spectrum=LENS["lanes"],
                       device=dev)
        path = os.path.join(tmp, "stopped.npz")
        save_checkpoint(path, first * 8, 8, 24, 3)
        resumed = render_resumable(scene, cam, integ, 24, path, **kw)
    equal = bool(torch.equal(whole, resumed))
    emit("d27_samplers_and_resume", lanes=1 << 20, dims=cams.DRAW_DIMS,
         kinds=list(cams.SAMPLER_KINDS), card_seconds=card_s,
         cpu_wait_seconds=wait_s,
         cpu_child_seconds=float(cpu["child_seconds"]),
         draws_bit_equal_to_cpu=True,
         jax_draws_bit_equal=True, resume_bit_equal=equal,
         resume_image_mean=float(whole.mean()))
    if not equal:
        raise AssertionError("d27: the resumed render differs from the "
                             "one-shot render")


def _lens_layers(render_pass) -> dict:
    """e13's layers of one pass (CUDA events): the camera (camera_rays_full)
    with, inside it, the lens trace and the exit-pupil sampling, and the
    sampler's draws (every get_1d / get_2d, the camera's included)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.cameras import humaneye, realistic
    from pbrt_tpu_torch.samplers.samplers import Sampler

    outer, lens_t, samp_t = ptp.LayerTimer(), ptp.LayerTimer(), ptp.LayerTimer()
    wraps = [(lens_t, "lens_trace", realistic, "trace_through_stack"),
             (lens_t, "lens_trace", humaneye, "trace_through_stack"),
             (samp_t, "sampler", Sampler, "get_1d"),
             (samp_t, "sampler", Sampler, "get_2d")]
    saved = [(owner, attr, getattr(owner, attr)) for _, _, owner, attr in wraps]
    with ptp.wrapped_layers(outer):
        for timer, name, owner, attr in wraps:
            setattr(owner, attr, timer.wrap(name, getattr(owner, attr)))
        try:
            # The caller's timed passes have warmed render_pass.
            torch.cuda.synchronize()
            for t in (outer, lens_t, samp_t):
                t.events.clear()
            t0 = time.perf_counter()
            render_pass()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)
    layers = outer.totals_ms()
    layers["other"] = wall_ms - sum(layers.values())
    return {"wall_ms": wall_ms, "layers_ms": layers,
            "lens_trace_ms": lens_t.totals_ms().get("lens_trace", 0.0),
            "sampler_ms_all_draws": samp_t.totals_ms().get("sampler", 0.0)}


class _CountedTrace:
    """An integrator whose trace counts its rays (render_spectral calls
    trace; e13's eye_bands reads the rays as bench.py counts them)."""

    def __init__(self, integ):
        self.integ = integ
        self.rays = []

    def trace(self, *args):
        radiance, stats = self.integ.trace_with_stats(*args)
        self.rays.append(stats["rays"])
        return radiance


def phase_timed_cameras(dev, smi: str) -> int:
    """e13, timed at full width. cornell_lens: the Cornell box through the
    doublet with its exit pupil (the port's own bounds), zsobol and a
    gaussian filter, 256x256, 64 spp in passes of 16 (1,048,576 camera
    rays a pass), depth 5 without Russian roulette, 8 lanes: Mrays/s, K1
    launches, peak memory, the layers (the camera with its lens trace,
    the sampler's draws), kernel launches and busy share a pass
    (torch.profiler); then one timed pass with each sampler kind, and the
    perspective camera with the independent sampler (e's pass at this
    shape), each with its sampler ms and its kernel launches from a
    profiled pass of the same shape (zsobol's digits, and so its
    launches, grow with the resolution).
    eye_bands: the Navarro eye with diffraction through render_spectral,
    8 bands x 8 spp a band at 256x256: Mrays/s, the eye trace's ms, K1
    launches, peak memory. Returns cornell_lens's K1 launches."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.cameras import humaneye
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.models.spectralpath import render_spectral
    from pbrt_tpu_torch.ops.smallscene import STATS

    c = LENS
    res, k, passes = c["res"], c["k"], c["spp"] // c["k"]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    render_pass = lens_pass(dev, res, k, c["lanes"])
    t0 = time.perf_counter()
    render_pass(0)  # warm-up
    first_s = time.perf_counter() - t0
    out = timed_forward(render_pass, passes, {"k1": STATS})
    if out["k1_launches"] != passes * CAMERA_RENDER_QUERIES:
        raise AssertionError(f"timed cornell_lens: {out['k1_launches']} K1 "
                             "launches")
    layers = _lens_layers(render_pass)
    kern = ptp.kernel_view(c["lanes"], render_pass, out_dir,
                           warm=False)
    emit("e13_timed_cornell_lens", lanes=c["lanes"], resolution=res,
         spp=c["spp"], samples_per_pass=k, max_depth=c["depth"],
         sampler="zsobol", filter="gaussian",
         rays_per_pass_camera=res * res * k, **out,
         wall_ms_per_pass=out["seconds"] * 1e3 / passes,
         k1_launches_per_pass=out["k1_launches"] / passes,
         first_pass_seconds=first_s, layers=layers,
         kernel_launches_per_pass=kern["kernel_launches"],
         device_busy_share=kern["device_busy_share"],
         device_kernel_ms=kern["device_kernel_ms"],
         profiled_pass_wall_ms=kern["wall_ms"], top_kernels=kern["top"],
         nvidia_smi=smi)
    k1_launches = out["k1_launches"]
    kinds = {}
    runs = [(kind, False) for kind in _cameras().SAMPLER_KINDS]
    runs.append(("independent", True))
    for kind, persp in runs:
        label = "perspective_independent" if persp else kind
        rp = lens_pass(dev, res, k, c["lanes"], kind, perspective=persp)
        rp(0)  # warm-up
        one = timed_forward(rp, 1, {"k1": STATS})
        lay = _lens_layers(rp)
        kv = ptp.kernel_view(c["lanes"], rp, out_dir, warm=False)
        kinds[label] = {"pass_ms": one["seconds"] * 1e3,
                        "mrays_per_s": one["mrays_per_s"],
                        "sampler_ms": lay["sampler_ms_all_draws"],
                        "camera_ms": lay["layers_ms"].get("camera", 0.0),
                        "kernel_launches_per_pass": kv["kernel_launches"],
                        "image_mean": one["image_mean"]}
    emit("e13_sampler_kinds", resolution=res, samples_per_pass=k,
         lanes=c["lanes"], passes=kinds, nvidia_smi=smi)
    e = EYE_BANDS
    scene, _ = cornell_on(dev)
    counted = _CountedTrace(PathIntegrator(max_depth=e["depth"],
                                           rr_start_depth=e["depth"]))
    factory = _cameras().eye_factory("pbrt_tpu_torch", e["res"])
    render_spectral(scene, factory, n_bands=1, spp_per_band=1,
                    n_spectrum=e["lanes"], integrator=counted,
                    device=dev)  # warm-up
    counted.rays.clear()
    lens_t = ptp.LayerTimer()
    trace = humaneye.trace_through_stack
    humaneye.trace_through_stack = lens_t.wrap("eye_trace", trace)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        STATS.reset(timed=True)
        t0 = time.perf_counter()
        rgb, bands = render_spectral(scene, factory, n_bands=e["n_bands"],
                                     spp_per_band=e["spp_per_band"],
                                     n_spectrum=e["lanes"],
                                     integrator=counted, device=dev)
        rays = float(sum(counted.rays))  # synchronizes
        seconds = time.perf_counter() - t0
    finally:
        humaneye.trace_through_stack = trace
    eye = {"seconds": seconds, "rays": rays, "mrays_per_s": rays / seconds / 1e6,
           "camera_rays": e["res"] ** 2 * e["n_bands"] * e["spp_per_band"],
           "eye_trace_ms": lens_t.totals_ms().get("eye_trace", 0.0),
           "k1_launches": STATS.launches, "k1_ms": STATS.elapsed_ms(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "image_mean": float(rgb.mean()), "bands_mean": float(bands.mean())}
    STATS.reset()
    if not bool(torch.isfinite(rgb).all()) or not eye["image_mean"] > 0.0:
        raise AssertionError(f"eye_bands: a non-finite or unlit image, {eye}")
    if eye["k1_launches"] != e["n_bands"] * CAMERA_RENDER_QUERIES:
        raise AssertionError(f"eye_bands: {eye['k1_launches']} K1 launches")
    emit("e13_timed_eye_bands", resolution=e["res"], n_bands=e["n_bands"],
         spp_per_band=e["spp_per_band"], lanes=e["lanes"],
         max_depth=e["depth"], diffraction=True, **eye, nvidia_smi=smi)
    return k1_launches


IO = dict(res=256, k=4, depth=5, lanes=8,
          spp={"io_surfaces": 8, "io_smoke": 4})
# K1 queries a pass at depth 5: the path's closest and shadow query a
# bounce and the terminal closest; the volumetric path's closest and two
# ratio-tracking transmittance queries a bounce and the terminal pair.
IO_QUERIES = {"io_surfaces": 2 * IO["depth"] + 1,
              "io_smoke": 3 * IO["depth"] + 2}
IO_SEED = 0


def _io():
    from tests import torch_port_io

    return torch_port_io


def io_scene(dev, name: str, in_dir=None):
    """(scene, camera, settings) of an io scene file on the card."""
    from pbrt_tpu_torch.io.parser import load_pbrt

    return load_pbrt(os.path.join(in_dir or _io().IO_DIR, name + ".pbrt"),
                     device=dev)


def _io_inset(name: str):
    import contextlib

    return inset_entry() if _io().INSET[name] else contextlib.nullcontext()


def phase_k1_io_vs_twin(dev):
    """c11: K1 against its twin on every query of one pass of each io
    scene (32x32, 4 spp, the file's integrator), launches counted from
    zero, each query bit-equal key by key, kernel and twin timed, with
    the bound."""
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS

    out = {}
    for name in _io().SCENES:
        scene, camera, settings = io_scene(dev, name)
        rp = make_pass(scene, camera.replace(resolution=(32, 32)), 32, 4,
                       IO["lanes"], integrator=settings["integrator"])
        STATS.reset()
        queries = _k1_queries(rp)
        torch.cuda.synchronize()
        launches = STATS.launches
        want = IO_QUERIES[name]
        if launches != want or len(queries) != launches:
            raise AssertionError(f"{name}: {launches} K1 launches, "
                                 f"{len(queries)} queries, {want} expected")
        out[name] = {"launches": launches,
                     **_hold_k1(scene.small, queries, name)}
        STATS.reset()
    emit("c11_k1_io_vs_twin", **out)
    return out


def phase_golden_io_jax(dev):
    """d28: io_surfaces.pbrt and io_smoke.pbrt (entry inset) at 32x32, 4
    spp, 8 lanes, the file's integrator, against the JAX goldens of
    scripts/make_torch_port_golden_io.py with d's gate; a lit image and
    11 / 17 K1 launches per pass."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.render import render

    g = _io().IMAGE
    for name in _io().SCENES:
        golden = np.load(os.path.join(GOLDEN_DATA, f"{name}32_spp4.npy"))
        scene, camera, settings = io_scene(dev, name)
        STATS.reset()
        with _io_inset(name):
            img = render(scene, camera.replace(resolution=(g["resolution"],) * 2),
                         settings["integrator"], spp=g["spp"],
                         samples_per_pass=g["spp"], seed=g["seed"],
                         n_spectrum=g["n_spectrum"], device=dev)
        torch.cuda.synchronize()
        launches = STATS.launches
        share, fields = _golden_gate(img.cpu().numpy(), golden)
        emit("d28_golden_io_jax", scene=name, resolution=g["resolution"],
             spp=g["spp"], lanes=g["n_spectrum"],
             max_depth=settings["integrator"].max_depth, **fields,
             k1_launches=launches, expected_k1=IO_QUERIES[name])
        if share < 0.99 or not fields["mean"] > 0.0:
            raise AssertionError(f"{name}: {share:.4f} of pixel values match "
                                 f"the JAX golden, mean {fields['mean']}")
        if launches != IO_QUERIES[name]:
            raise AssertionError(f"{name}: {launches} K1 launches, "
                                 f"{IO_QUERIES[name]} expected")


def phase_timed_io(dev, smi: str, seed: int) -> dict:
    """e14: the io slice at full width. Writes tests/torch_port_io.py's
    FULL inputs with the port's writers from `seed` into a temporary
    directory beside the two scene files, and a 2048^2 half ZIP EXR map
    whose read is timed (the scene's sky is FULL's); reads each input back
    (host seconds), loads each scene onto the card (load-to-Scene
    seconds: the parse, the reads and the tables' builds and upload),
    then times io_surfaces (256x256, 8 spp in passes of 4) and io_smoke
    (one pass of 4 spp) at depth 5 without Russian roulette, 8 lanes,
    the exact medium entry: Mrays/s, K1 launches a pass, peak memory,
    kernel launches a pass and the busy share (torch.profiler). Returns
    each scene's K1 launches of its timed passes."""
    import shutil
    import tempfile

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import profile_torch_pass as ptp

    from pbrt_tpu_torch.io import image
    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.ops import smallscene

    io = _io()
    full = io.FULL
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="io_full_")
    launches = {}
    try:
        for name in io.SCENES:
            shutil.copy(os.path.join(io.IO_DIR, name + ".pbrt"), tmp)
        write_s = io.write_inputs("pbrt_tpu_torch", tmp, full, seed)
        n = full["env_read"]
        env = np.random.default_rng(seed).uniform(
            0.0, 4.0, (n, n, 3)).astype(np.float32)
        env_path = os.path.join(tmp, "env_read.exr")
        t0 = time.perf_counter()
        image.write_exr(env_path, env, compression="zip", half=True)
        write_s["env_read.exr"] = time.perf_counter() - t0
        reads = io.read_inputs("pbrt_tpu_torch", tmp)
        read_s = {k: v[1] for k, v in reads.items()}
        if not np.array_equal(reads["env_read.exr"][0],
                              env.astype(np.float16).astype(np.float32)):
            raise AssertionError("e14: the 2048^2 half EXR did not read back")
        del reads, env
        sizes = {k: os.path.getsize(os.path.join(tmp, k))
                 for k in sorted(os.listdir(tmp))}
        emit("e14_io_inputs", seed=seed, size=full, writer_seconds=write_s,
             reader_seconds=read_s, file_bytes=sizes)
        res, k = IO["res"], IO["k"]
        for name in io.SCENES:
            t0 = time.perf_counter()
            scene, camera, _ = io_scene(dev, name, tmp)
            load_s = time.perf_counter() - t0
            cls = PathIntegrator if name == "io_surfaces" else VolPathIntegrator
            integ = cls(max_depth=IO["depth"], rr_start_depth=IO["depth"])
            render_pass = make_pass(scene, camera.replace(resolution=(res, res)),
                                    res, k, IO["lanes"], integrator=integ)
            t0 = time.perf_counter()
            render_pass(0)  # warm-up
            first_s = time.perf_counter() - t0
            passes = IO["spp"][name] // k
            out = timed_forward(render_pass, passes, {"k1": smallscene.STATS})
            if out["k1_launches"] != IO_QUERIES[name] * passes:
                raise AssertionError(f"timed {name}: {out['k1_launches']} K1 "
                                     f"launches over {passes} passes")
            if not out["image_mean"] > 0.0:
                raise AssertionError(f"timed {name}: an unlit image, {out}")
            launches[name] = out["k1_launches"]
            kern = ptp.kernel_view(IO["lanes"], render_pass, out_dir,
                                   warm=False)
            emit(f"e14_timed_{name}", lanes=IO["lanes"], resolution=res,
                 spp=IO["spp"][name], samples_per_pass=k,
                 max_depth=IO["depth"], rays_per_pass_camera=res * res * k,
                 load_to_scene_seconds=load_s, first_pass_seconds=first_s,
                 **out, wall_ms_per_pass=out["seconds"] * 1e3 / passes,
                 k1_launches_per_pass=out["k1_launches"] / passes,
                 kernel_launches_per_pass=kern["kernel_launches"],
                 device_busy_share=kern["device_busy_share"],
                 device_kernel_ms=kern["device_kernel_ms"],
                 profiled_pass_wall_ms=kern["wall_ms"], top_kernels=kern["top"],
                 nvidia_smi=smi)
            del scene, render_pass
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---- PR: the command line (d29, e16) ------------------------------------
# d29: the render CLI on the C++-golden files with d10's and d7's rows of
# CXX_GOLDENS (spp, samples per pass, bounds, kernel); the GBuffer run's
# spp and the --debugstart sample.
CLI_GOLDENS = ("box", "plymesh")
CLI_GBUFFER_SPP = 8
CLI_DEBUGSTART = "3,5,1"
# e16: the CLI's time to first image from a shell, and the profiled run.
CLI_FIRST_SPP = 64
CLI_PROFILED_SPP = 8


def _cli_main(argv):
    """pbrt_render.main(argv) with its stdout captured: (rc, stdout)."""
    import contextlib
    import io

    from pbrt_tpu_torch.tools import pbrt_render

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pbrt_render.main([str(a) for a in argv])
    return rc, buf.getvalue()


def _exr_rgb(path):
    import numpy as np

    from pbrt_tpu_torch.io.image import read_exr

    img, chans, meta = read_exr(path)
    return np.stack([img[..., chans.index(c)] for c in "RGB"], -1), meta


def phase_cli_golden(dev) -> dict:
    """d29: `pbrt_tpu_torch.tools.pbrt_render.main` on the card. box.pbrt
    (K1) and plymesh.pbrt (K2) at their own 64x64 with d10's and d7's spp
    and passes of 32: each EXR read back against the C++ golden with those
    phases' bounds, and bit-equal to render_file's image of the same file
    and arguments on the card; the triangle kernel launched by the CLI's
    render, counted from zero. Then `--gbuffer --spectral-buckets 6` on
    box.pbrt: every GBuffer channel equal to render_aovs' of the same
    arguments, the spectral buckets within rtol 1e-5 (their sums are
    atomics); and `--debugstart 3,5,1`, its record within rtol 1e-4 (atol
    1e-6 for exact zeros) of the same record on the CPU. Returns each
    file's CLI launches."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pbrt_tpu_torch.films.gbuffer import render_aovs
    from pbrt_tpu_torch.io.image import read_exr
    from pbrt_tpu_torch.io.parser import load_pbrt
    from pbrt_tpu_torch.ops import cluster, smallscene
    from pbrt_tpu_torch.render import render_file
    from pbrt_tpu_torch.tools.pbrt_render import AOV_CHANNELS

    rows = {row[1]: row for row in CXX_GOLDENS}
    counters = {"k1": smallscene.STATS, "k2": cluster.STATS}
    tmp = tempfile.mkdtemp(prefix="cli_")
    launches = {}
    try:
        for name in CLI_GOLDENS:
            _, _, spp, per_pass, bounds, kernel = rows[name]
            path = os.path.join(GOLDEN_FILES, name + ".pbrt")
            out = os.path.join(tmp, name + ".exr")
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            rc, _ = _cli_main([path, "--outfile", out, "--spp", spp,
                               "--samples-per-pass", per_pass, "--quiet",
                               "--device", str(dev)])
            seconds = time.perf_counter() - t0
            cli_launches = {k: c.launches for k, c in counters.items()}
            img, meta = _exr_rgb(out)
            rel, mse, q95, ref = _cxx_errors(img, name)
            scene, camera, settings = load_pbrt(path, device=dev)
            want = render_file(scene, camera, settings, spp=spp, seed=0,
                               samples_per_pass=per_pass,
                               device=dev).cpu().numpy()
            n_diff = int(np.sum(img != want))
            emit(f"d29_cli_golden_{name}", rc=rc, spp=spp,
                 samples_per_pass=per_pass, cli_seconds=seconds,
                 exr_metadata=meta, rel_mean_err=rel, mse=mse,
                 q95_cell_rel_err=q95, mean=float(img.mean()),
                 golden_mean=float(ref.mean()),
                 bounds=dict(zip(("rel_mean_err", "mse", "q95_cell_rel_err"),
                                 bounds)),
                 values_unequal_to_render_file=n_diff,
                 **{f"{k}_launches": v for k, v in cli_launches.items()})
            if rc != 0 or meta.get("samplesPerPixel") != str(spp):
                raise AssertionError(f"d29 {name}: rc {rc}, metadata {meta}")
            if not (rel < bounds[0] and mse < bounds[1] and q95 < bounds[2]):
                raise AssertionError(f"d29 {name}.pbrt off the C++ golden: "
                                     f"rel {rel}, MSE {mse}, q95 {q95}")
            if n_diff:
                raise AssertionError(f"d29 {name}: {n_diff} values differ "
                                     "from render_file's image")
            if cli_launches[kernel] == 0:
                raise AssertionError(f"d29 {name}: the CLI launched no "
                                     f"{kernel.upper()}")
            launches[name] = cli_launches[kernel]
            del scene, want

        path = os.path.join(GOLDEN_FILES, "box.pbrt")
        out = os.path.join(tmp, "aov.exr")
        rc, _ = _cli_main([path, "--outfile", out, "--spp", CLI_GBUFFER_SPP,
                           "--samples-per-pass", CLI_GBUFFER_SPP, "--quiet",
                           "--gbuffer", "--spectral-buckets", 6,
                           "--device", str(dev)])
        aov, chans, _ = read_exr(os.path.join(tmp, "aov_aov.exr"))
        spectral, _, _ = read_exr(os.path.join(tmp, "aov_spectral.exr"))
        scene, camera, settings = load_pbrt(path, device=dev)
        want = render_aovs(scene, camera, settings["integrator"],
                           spp=CLI_GBUFFER_SPP, seed=0, spectral_buckets=6,
                           device=dev)
        want = {k: v.cpu().numpy() for k, v in want.items()}
        want_chans = np.concatenate(
            [want["p"], want["n"], want["albedo_rgb"],
             want["depth"][..., None], want["material_id"][..., None],
             want["prim_id"][..., None], want["variance"][..., None]], -1)
        unequal = {c: int(np.sum(aov[..., chans.index(c)]
                                 != want_chans[..., i]))
                   for i, c in enumerate(AOV_CHANNELS)}
        spec_err = float(np.max(np.abs(spectral - want["spectral"])
                                / (np.abs(want["spectral"]) + 1e-6)))
        emit("d29_cli_gbuffer", rc=rc, spp=CLI_GBUFFER_SPP,
             channels_unequal=unequal, spectral_max_rel_err=spec_err)
        if rc != 0 or any(unequal.values()) or not spec_err <= 1e-5:
            raise AssertionError(f"d29 gbuffer: rc {rc}, unequal {unequal}, "
                                 f"spectral {spec_err}")

        recs = {}
        for key, device in (("card", str(dev)), ("cpu", "cpu")):
            rc, stdout = _cli_main([path, "--debugstart", CLI_DEBUGSTART,
                                    "--quiet", "--device", device])
            if rc != 0:
                raise AssertionError(f"d29 debugstart on {device}: rc {rc}")
            recs[key] = _json.loads(stdout.strip().splitlines()[-1])
        card, cpu = recs["card"], recs["cpu"]
        errs = {k: float(np.max(np.abs(np.asarray(card[k], float)
                                       - np.asarray(cpu[k], float))))
                for k in cpu}
        ok = set(card) == set(cpu) and all(
            np.allclose(np.asarray(card[k], float), np.asarray(cpu[k], float),
                        rtol=1e-4, atol=1e-6) for k in cpu)
        emit("d29_cli_debugstart", sample=CLI_DEBUGSTART, keys=list(cpu),
             max_abs_diff=errs, card_L_sum=float(np.sum(card["L"])),
             rays=card["rays"])
        if not ok:
            raise AssertionError(f"d29 debugstart: card {card} against CPU "
                                 f"{cpu}")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_cli_first_image(smi: str) -> None:
    """e16: `python -m pbrt_tpu_torch.tools.pbrt_render
    tests/goldens/box.pbrt --spp 64 --device cuda` in a child process (the
    kernels already built by phase b, read from pbrt_tpu_torch/_build/),
    run with -X importtime: its wall from launch to exit and to the
    EXR's write, the parse and render seconds it prints to stderr, the
    import seconds of torch and of the port, and whether jax was
    imported. Then one in-process CLI render (CLI_PROFILED_SPP) inside
    utils/profile.capture with profile.scope("cli/render") around it: the
    exported Chrome trace must hold the scope's name and K1's kernel."""
    import re
    import shutil
    import tempfile

    from pbrt_tpu_torch.utils import profile

    tmp = tempfile.mkdtemp(prefix="cli_first_")
    try:
        out = os.path.join(tmp, "first.exr")
        cmd = [sys.executable, "-X", "importtime", "-m",
               "pbrt_tpu_torch.tools.pbrt_render",
               os.path.join("tests", "goldens", "box.pbrt"), "--spp",
               str(CLI_FIRST_SPP), "--device", "cuda", "--outfile", out]
        env = dict(os.environ, PYTHONPATH=ROOT)
        launch = time.time()
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(out):
            raise AssertionError(f"e16: rc {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        to_file = os.path.getmtime(out) - launch
        # -X importtime: "import time: self [us] | cumulative | name",
        # the name indented two spaces more per level of nesting (one
        # space at the top level).
        imports, top = {}, 0.0
        for line in proc.stderr.splitlines():
            m = re.match(r"import time:\s+\d+ \|\s+(\d+) \|( +)(\S+)$",
                         line)
            if m:
                imports[m.group(3)] = int(m.group(1)) / 1e6
                if len(m.group(2)) == 1:
                    top += int(m.group(1)) / 1e6
        loaded_jax = any(k == "jax" or k.startswith(("jax.", "pbrt_tpu."))
                         or k == "pbrt_tpu" for k in imports)
        said = [ln for ln in proc.stderr.splitlines()
                if not ln.startswith("import time:")]
        parse = re.search(r"^parsed .*\(([\d.]+)s\)$", "\n".join(said), re.M)
        rendered = re.search(r"^rendered \d+ spp in ([\d.]+)s", "\n".join(said),
                             re.M)
        emit("e16_cli_first_image", command=" ".join(cmd[3:]),
             wall_seconds_to_exit=wall, wall_seconds_to_written_file=to_file,
             parse_seconds=float(parse.group(1)) if parse else None,
             render_seconds=float(rendered.group(1)) if rendered else None,
             import_torch_seconds=imports.get("torch"),
             import_seconds_total=top,
             child_imported_jax=loaded_jax, stderr=said[-4:],
             nvidia_smi=smi)
        if loaded_jax or parse is None or rendered is None:
            raise AssertionError(f"e16: jax {loaded_jax}, stderr {said}")

        logdir = os.path.join(tmp, "trace")
        with profile.capture(logdir):
            with profile.scope("cli/render"):
                rc, _ = _cli_main([
                    os.path.join(GOLDEN_FILES, "box.pbrt"), "--outfile",
                    os.path.join(tmp, "profiled.exr"), "--spp",
                    CLI_PROFILED_SPP, "--samples-per-pass", CLI_PROFILED_SPP,
                    "--quiet", "--device", "cuda"])
        with open(os.path.join(logdir, profile.TRACE_FILE)) as f:
            trace = json.load(f)
        names = [e.get("name", "") for e in trace.get("traceEvents", [])]
        k1 = sorted({n for n in names if "smallscene_kernel" in n})
        emit("e16_cli_profiled", rc=rc, spp=CLI_PROFILED_SPP,
             trace_events=len(names), scope_events=names.count("cli/render"),
             k1_kernel_events=sum(n in k1 for n in names), k1_names=k1)
        if rc != 0 or "cli/render" not in names or not k1:
            raise AssertionError("e16: the trace lacks the scope or K1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# p1 and p2: the Cornell box under the sharded paths (parallel/).
MESH_RES, MESH_SPP, MESH_LANES, MESH_DEPTH = 64, 8, 8, 5
MP_RES, MP_SPP, MP_TIMEOUT_S = 64, 4, 300


def _grad_delta(scene, new_scene):
    """start - step of a training step at lr 1: the gradient it applied."""
    return {name: (getattr(getattr(scene, part), name)
                   - getattr(getattr(new_scene, part), name)).cpu()
            for part, name in (("materials", "albedo_coeffs"),
                               ("lights", "area_scale"))}


def phase_mesh(dev) -> dict:
    """p1: the single-process mesh of two shards on the one card,
    [cuda:0, cuda:0]. The Cornell box at MESH_RES^2, depth MESH_DEPTH, 8
    lanes, MESH_SPP spp: render_tile_sharded bit-equal to the one-device
    image (the same function on the mesh [cuda:0]); render_spp_sharded
    within rtol 2e-5 / atol 2e-6 of it and bit-equal over two calls;
    training_step(mesh=...) (pixels twice, samples 0 and 1, target 0.25,
    lr 1) against the one-device step: the gradients within rtol 2e-4 /
    atol 1e-7, the loss within rtol 1e-5. K1's launches of each call are
    counted from zero, and per shard and wave."""
    import torch

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops import smallscene
    from pbrt_tpu_torch.parallel.mesh import make_mesh
    from pbrt_tpu_torch.parallel.render import (
        render_spp_sharded,
        render_tile_sharded,
    )
    from pbrt_tpu_torch.parallel.train import training_step
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    scene, camera = cornell_box(resolution=(MESH_RES, MESH_RES))
    scene = scene.with_accel().to(dev)
    integ = PathIntegrator(max_depth=MESH_DEPTH)
    mesh2 = make_mesh(devices=[dev, dev])
    mesh1 = make_mesh(devices=[dev])
    launches, seconds = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        smallscene.STATS.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = smallscene.STATS.launches
        return out

    kw = dict(n_spectrum=MESH_LANES, samples_per_pass=MESH_SPP)
    one = run("one_device", lambda: render_tile_sharded(
        scene, camera, integ, mesh1, spp=MESH_SPP, **kw))
    tile = run("tile", lambda: render_tile_sharded(
        scene, camera, integ, mesh2, spp=MESH_SPP, **kw))
    kw_spp = dict(n_spectrum=MESH_LANES, samples_per_pass=MESH_SPP // 2)
    spp_a = run("spp", lambda: render_spp_sharded(
        scene, camera, integ, mesh2, spp=MESH_SPP, **kw_spp))
    spp_b = run("spp_again", lambda: render_spp_sharded(
        scene, camera, integ, mesh2, spp=MESH_SPP, **kw_spp))
    npix, k = MESH_RES * MESH_RES, 2
    args = (scene, camera, integ, torch.arange(npix).repeat(k),
            torch.full((npix * k, 3), 0.25),
            torch.arange(k).repeat_interleave(npix), 0)
    loss_m, new_m = run("train_mesh", lambda: training_step(
        *args, lr=1.0, mesh=mesh2, n_spectrum=MESH_LANES))
    loss_1, new_1 = run("train_one_device", lambda: training_step(
        *args, lr=1.0, n_spectrum=MESH_LANES))
    g_m, g_1 = _grad_delta(scene, new_m), _grad_delta(scene, new_1)
    grad_rel = {n: float(torch.max(torch.abs(g_m[n] - g_1[n]))
                         / torch.max(torch.abs(g_1[n]))) for n in g_m}
    spp_err = float(torch.max(torch.abs(spp_a - tile)))
    checks = {
        "tile_bit_equal_one_device": bool(torch.equal(tile, one)),
        "spp_close_to_tile": bool(torch.allclose(spp_a, tile, rtol=2e-5,
                                                 atol=2e-6)),
        "spp_bit_equal_repeat": bool(torch.equal(spp_a, spp_b)),
        "train_loss_close": abs(float(loss_m) - float(loss_1))
        <= 1e-5 * abs(float(loss_1)),
        "train_grads_close": all(bool(torch.allclose(
            g_m[n], g_1[n], rtol=2e-4, atol=1e-7)) for n in g_m),
        "finite_lit": bool(torch.isfinite(tile).all()) and float(
            tile.mean()) > 0.0,
        "new_scene_on_card": new_m.materials.albedo_coeffs.device.type
        == "cuda",
        # 2 x depth + 1 K1 queries a wave; the backward launches none.
        "k1_per_shard_wave": launches["tile"] == 2 * (2 * MESH_DEPTH + 1)
        and launches["train_mesh"] == launches["tile"],
    }
    waves = {"one_device": 1, "tile": 2, "spp": 2 * 2, "spp_again": 2 * 2,
             "train_mesh": 2, "train_one_device": 1}
    emit("p1_mesh", mesh=[str(d) for d in mesh2.devices],
         resolution=MESH_RES, spp=MESH_SPP, lanes=MESH_LANES,
         max_depth=MESH_DEPTH, image_mean=float(tile.mean()),
         spp_vs_tile_max_abs=spp_err, loss_mesh=float(loss_m),
         loss_one_device=float(loss_1), grad_max_rel_of_max=grad_rel,
         k1_launches=launches,
         k1_launches_per_shard_wave={n: launches[n] / waves[n]
                                     for n in launches},
         seconds=seconds, **checks)
    if not all(checks.values()):
        raise AssertionError(f"p1: {checks}")
    return {"mesh_tile": launches["tile"], "mesh_spp": launches["spp"]
            + launches["spp_again"], "mesh_train": launches["train_mesh"]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multiprocess(smi: str) -> dict:
    """p2: the process groups on the one card. Two mp_worker processes
    over gloo (NCCL refuses two ranks on one GPU), each with the mesh
    entries [cuda:0, cuda:0], and one world of size 1 over NCCL with the
    same entries, started together: each renders the Cornell box (MP_RES^2,
    MP_SPP spp in one wave, depth 3, 8 lanes) pixel-sharded and takes
    train_step_multiprocess against a flat 0.25 target. Gloo's collectives
    (all_gather_object of the mesh sizes, all_gather of the film shards
    and of the per-shard loss and gradients, barrier) take CPU tensors,
    staged from the card; NCCL's take the card's. Both gloo images
    bit-equal to the NCCL process's; the gradients and loss identical on
    both gloo ranks and within rtol 2e-4 / atol 1e-7 (loss 1e-5) of one
    process's; K1 launched in every process. Each child has
    MP_TIMEOUT_S; a failed or late one fails the phase."""
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="mp_worker_")
    env = dict(os.environ, PYTHONPATH=ROOT)
    layouts = {"gloo": (2, "gloo"), "nccl": (1, None)}
    procs = []
    t0 = time.perf_counter()
    try:
        for name, (nprocs, backend) in layouts.items():
            port = _free_port()
            for pid in range(nprocs):
                cmd = [sys.executable, "-m",
                       "pbrt_tpu_torch.parallel.mp_worker",
                       "--coordinator", f"127.0.0.1:{port}",
                       "--nprocs", str(nprocs), "--pid", str(pid),
                       "--local-devices", "2", "--mode", "both",
                       "--res", str(MP_RES), "--spp", str(MP_SPP),
                       "--n-spectrum", "8", "--device", "cuda:0",
                       "--timeout", str(MP_TIMEOUT_S),
                       "--out", os.path.join(tmp, name)]
                if backend:
                    cmd += ["--backend", backend]
                procs.append((name, pid, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
        deadline = time.monotonic() + MP_TIMEOUT_S
        errors = []
        for name, pid, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                errors.append(f"{name}.{pid} timed out: {err[-1500:]}")
                continue
            if p.returncode != 0:
                errors.append(f"{name}.{pid} rc {p.returncode}: {err[-1500:]}")
        wall = time.perf_counter() - t0
        if errors:
            raise AssertionError("p2: " + " | ".join(errors))
        res = {name: [dict(np.load(os.path.join(tmp, f"{name}.{pid}.npz")))
                      for pid in range(n)]
               for name, (n, _) in layouts.items()}
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    one, gloo = res["nccl"][0], res["gloo"]
    leaves = ("albedo_coeffs", "area_scale")
    checks = {
        "images_bit_equal_one_process": all(
            np.array_equal(r["img"], one["img"]) for r in gloo),
        "grads_identical_across_ranks": all(
            np.array_equal(gloo[1][n], gloo[0][n]) for n in leaves + ("loss",)),
        "grads_close_to_one_process": all(np.allclose(
            gloo[0][n], one[n], rtol=2e-4, atol=1e-7) for n in leaves),
        "loss_close_to_one_process": bool(np.isclose(
            gloo[0]["loss"], one["loss"], rtol=1e-5, atol=0.0)),
        "backends": [str(gloo[0]["backend"]), str(one["backend"])]
        == ["gloo", "nccl"],
        "k1_launched_everywhere": all(int(r["k1_launches"]) > 0
                                      for r in gloo + [one]),
        "finite_lit": bool(np.isfinite(one["img"]).all()
                           and one["img"].mean() > 0),
    }
    emit("p2_multiprocess", resolution=MP_RES, spp=MP_SPP, lanes=8,
         max_depth=3, layouts={n: {"processes": v[0], "backend": v[1] or
                                   "nccl", "mesh_entries": int(
                                       res[n][0]["ndev"])}
                               for n, v in layouts.items()},
         collectives={"gloo": "all_gather_object, all_gather, barrier on "
                              "CPU tensors (the card's shards staged "
                              "through the host)",
                      "nccl": "all_gather_object, all_gather, barrier on "
                              "cuda:0 tensors"},
         wall_seconds=wall,
         render_seconds={n: [float(r["seconds"]) for r in res[n]]
                         for n in res},
         train_seconds={n: [float(r["train_seconds"]) for r in res[n]]
                        for n in res},
         k1_launches={n: [int(r["k1_launches"]) for r in res[n]]
                      for n in res},
         loss={n: float(res[n][0]["loss"]) for n in res},
         grad_max_rel_of_max={n: float(np.abs(gloo[0][n] - one[n]).max()
                                       / np.abs(one[n]).max())
                              for n in leaves},
         nvidia_smi=smi, **checks)
    if not all(checks.values()):
        raise AssertionError(f"p2: {checks}")
    return {"mp_workers": sum(int(r["k1_launches"]) for r in gloo + [one])}


def _best_seconds(fn, reps: int = 3):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def phase_native(dev) -> None:
    """n1: the native host code (pbrt_tpu_torch/native/, built by g++ at
    first use) on the card's host. The tokenizer against its Python twin
    (io/parser.tokenize_py) on the 13 scene files with C++ goldens, the
    port's committed scenes, the CLI tests' scenes and the instanced
    field: equal token for token, with each side's best-of-3 host
    seconds. The Morton order against its numpy twin
    (accel/bvh.morton_order_np) on every centroid set the builds sort:
    the killeroo-class scene's 122,244 triangles (K2's cluster build) and
    the instanced field's prototypes (K3's sweep build), captured as the
    builds run: equal index for index, with best-of-3 seconds. Then the
    builds themselves, twice each in turns, with the twins in the callers'
    place (the code before native/) and with the native code: the
    killeroo-class scene's build and the instanced field's parse to a
    scene on the card, host seconds."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from pbrt_tpu_torch import native
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.io import parser
    from pbrt_tpu_torch.ops import nvcc_build
    from pbrt_tpu_torch.scenes.meshes import killeroo_class_scene
    from tests import torch_port_cli
    from tests.torch_port_instanced import field_text, write_field_meshes

    t0 = time.perf_counter()
    native.get_lib()
    load_s = time.perf_counter() - t0
    build = nvcc_build.BUILD_LOG.get("native")
    paths = sorted(glob.glob(os.path.join(GOLDEN_FILES, "*.pbrt")))
    if len(paths) != 13:
        raise AssertionError(f"n1: {len(paths)} golden scene files")
    paths += sorted(glob.glob(os.path.join(ROOT, "tests", "data",
                                           "torch_port", "**", "*.pbrt"),
                              recursive=True))
    texts = {os.path.relpath(p, ROOT): open(p).read() for p in paths}
    for name in ("IMAGE_SCENE", "GBUFFER_SCENE", "DEBUG_SCENE"):
        texts[f"cli:{name}"] = getattr(torch_port_cli, name)
    texts["instanced_field"] = field_text()
    tok = {"native_s": 0.0, "python_s": 0.0, "tokens": 0, "bytes": 0}
    mismatched = []
    for name, text in texts.items():
        s_n, got = _best_seconds(lambda: native.tokenize_native(text))
        s_p, want = _best_seconds(lambda: parser.tokenize_py(text))
        tok["native_s"] += s_n
        tok["python_s"] += s_p
        tok["tokens"] += len(want)
        tok["bytes"] += len(text.encode())
        if got != want:
            mismatched.append(name)

    captured = []
    native_order = bvh.morton_order

    def recording(cent):
        captured.append(np.array(cent, np.float32))
        return native_order(cent)

    def killeroo_build():
        scene, _ = killeroo_class_scene(resolution=(64, 64))
        return scene

    with tempfile.TemporaryDirectory(prefix="n1_field_") as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp)

        def field_load():
            scene, _, _ = parser.load_pbrt_string(field_text(), tmp,
                                                  device=dev)
            torch.cuda.synchronize()
            return scene

        bvh.morton_order = recording
        try:
            killeroo_build()
            n_killeroo = len(captured)
            field_load()
        finally:
            bvh.morton_order = native_order
        sets = {"killeroo": captured[:n_killeroo],
                "field": captured[n_killeroo:]}
        morton = {}
        for key, cents in sets.items():
            row = {"sets": len(cents), "centroids": [len(c) for c in cents],
                   "native_s": 0.0, "numpy_s": 0.0, "equal": True}
            for cent in cents:
                s_n, got = _best_seconds(lambda: native.morton_order_native(
                    cent))
                s_p, want = _best_seconds(lambda: bvh.morton_order_np(cent))
                row["native_s"] += s_n
                row["numpy_s"] += s_p
                row["equal"] &= bool(np.array_equal(got, want))
            row["speedup"] = row["numpy_s"] / max(row["native_s"], 1e-9)
            morton[key] = row

        builds = {"killeroo_build_s": {"twins": [], "native": []},
                  "field_parse_s": {"twins": [], "native": []}}
        tokenize_native = parser.tokenize
        for _ in range(2):
            for mode in ("twins", "native"):
                if mode == "twins":
                    bvh.morton_order = bvh.morton_order_np
                    parser.tokenize = parser.tokenize_py
                try:
                    for key, fn in (("killeroo_build_s", killeroo_build),
                                    ("field_parse_s", field_load)):
                        t0 = time.perf_counter()
                        fn()
                        builds[key][mode].append(time.perf_counter() - t0)
                finally:
                    bvh.morton_order = native_order
                    parser.tokenize = tokenize_native
    killeroo_n = sum(len(c) for c in sets["killeroo"])
    checks = {
        "tokens_equal": not mismatched,
        "morton_equal": all(r["equal"] for r in morton.values()),
        "killeroo_centroids": killeroo_n == 122244,
        "field_sets": len(sets["field"]) >= 2,
    }
    emit("n1_native", build_seconds=build[0] if build else None,
         load_seconds=load_s, scene_texts=len(texts),
         mismatched=mismatched,
         tokenizer={**tok, "speedup": tok["python_s"] / max(tok["native_s"],
                                                           1e-9)},
         morton=morton, builds=builds, **checks)
    if not all(checks.values()):
        raise AssertionError(f"n1: {checks}")


def _timed_once(fn):
    """(fn(), its device milliseconds), one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _micro_compare(label, got, want) -> tuple[float, bool]:
    """Raise unless got and want (tensors or tuples of them) are bit-equal
    with NaN equal. Return the largest absolute difference of their finite
    entries (0.0), and whether every output has a finite entry."""
    import torch

    from pbrt_tpu_torch.micro import bits_equal

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, finite = 0.0, True
    for g, w in zip(got, want, strict=True):
        if not bits_equal(g, w):
            raise AssertionError(f"m1: {label} differs from its plain version")
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g[fin] - w[fin]).abs().max()))
        else:
            finite = False
    return err, finite


def _sass_stores(lib_path: str) -> dict:
    """STG and STS counts of each micro_dyn instance in the built library
    (cuobjdump -sass), by mode index."""
    import re

    from pbrt_tpu_torch.ops.nvcc_build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, mode = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*dyn_kernelILi(\d+)ELi\d+E", line)
        if m:
            mode = int(m.group(1))
            counts[mode] = {"STG": 0, "STS": 0}
        elif "Function :" in line:
            mode = None
        elif mode is not None:
            for op in ("STG", "STS"):
                if re.search(rf"\b{op}\b", line):
                    counts[mode][op] += 1
    return counts


def phase_micro(dev) -> dict:
    """m1: the micro-benchmarks at the probes' full constants. The main
    path is each module's run() (what `python -m
    pbrt_tpu_torch.micro.<probe>` times), with every launch counter set to
    0 before and read after. Then each kernel in each mode against its
    plain version on the card (those launches are not counted), the
    bound of each call from its work (FP32 operations and bytes, the
    modules' `work`) and the SASS check of micro_dyn's stores."""
    import torch

    from pbrt_tpu_torch.micro import (micro_dyn, micro_entry, micro_mosaic,
                                      micro_mosaic2, micro_pairs)

    t_phase = time.perf_counter()
    stats = {"micro_pairs": micro_pairs.STATS,
             "micro_mosaic_loop": micro_mosaic.LOOP_STATS,
             "micro_mosaic_dense": micro_mosaic.DENSE_STATS,
             "micro_mosaic2": micro_mosaic2.STATS,
             "micro_dyn": micro_dyn.STATS, "micro_entry": micro_entry.STATS}
    for st in stats.values():
        st.reset()
    runs = {m.__name__.rsplit(".", 1)[1]: m.run(dev)
            for m in (micro_pairs, micro_mosaic, micro_mosaic2, micro_dyn,
                      micro_entry)}
    torch.cuda.synchronize()
    launches = {name: st.launches for name, st in stats.items()}
    main_seconds = time.perf_counter() - t_phase
    if not all(launches.values()):
        raise AssertionError(f"m1: a kernel was never launched: {launches}")

    def t(a):
        return torch.from_numpy(a).to(dev)

    modes = {name: [] for name in stats}
    checks = []  # the comparisons on inputs whose answers stay finite
    counted = set()  # (kernel, mode) with a comparison that counts

    def add(name, mode, ms, units, got, want, plain_ms, work):
        bound = _bound(*work)
        err, finite = _micro_compare(f"{name} {mode}", got, want)
        if finite:
            counted.add((name, mode))
        modes[name].append({
            "mode": mode, "ms": ms, "ns_per_iter": ms * 1e6 / units,
            "plain_ms": plain_ms, "max_abs_err": err, "finite": finite,
            **bound, "share_of_bound": bound["bound_ms"] / ms})

    def check(name, mode, case, got, want):
        err, finite = _micro_compare(f"{name} {mode} {case}", got, want)
        if not finite:
            raise AssertionError(f"m1: {name} {mode} {case}: an output is "
                                 "entirely non-finite")
        counted.add((name, mode))
        checks.append({"kernel": name, "mode": mode, "case": case,
                       "max_abs_err": err})

    live, rays = (t(a) for a in micro_pairs.inputs())
    got = micro_pairs.micro_pairs(live, rays)
    want, plain_ms = _timed_once(lambda: micro_pairs.micro_pairs_ref(live,
                                                                      rays))
    count = int(want[2][0, 0])
    add("micro_pairs", "pairs", runs["micro_pairs"][0]["ms"], max(count, 1),
        got, want, plain_ms, micro_pairs.work(count))

    x, y = (t(a) for a in micro_mosaic.inputs())
    by_mode = {r["mode"]: r for r in runs["micro_mosaic"]}
    g, n = micro_mosaic.GRID, micro_mosaic.N_IT
    for mode in micro_mosaic.LOOP_MODES:
        got = micro_mosaic.loop(x, mode=mode)
        (want, taken), plain_ms = _timed_once(lambda: micro_mosaic.loop_ref(
            x, mode=mode, return_taken=True))
        add("micro_mosaic_loop", mode, by_mode[mode]["ms"], g * n, got, want,
            plain_ms, micro_mosaic.loop_work(mode, taken=taken))
    # Under the probe's ones the block max never reaches 1e30: reduce's
    # answer is 0.5 n_it and cond's 0 whatever the max.
    x_cross = t(micro_mosaic.crossing_inputs())
    for mode in ("reduce", "cond"):
        check("micro_mosaic_loop", mode, "crossing_inputs",
              micro_mosaic.loop(x_cross, mode=mode),
              micro_mosaic.loop_ref(x_cross, mode=mode))
    got = micro_mosaic.dense(x, y)
    want, plain_ms = _timed_once(lambda: micro_mosaic.dense_ref(x, y))
    add("micro_mosaic_dense", "dense", by_mode["dense"]["ms"],
        g * micro_mosaic.DENSE_N_IT, got, want, plain_ms,
        micro_mosaic.dense_work())

    x, tab = (t(a) for a in micro_mosaic2.inputs())
    by_run = {(r["mode"], r["n_it"], r["body_reps"]): r
              for r in runs["micro_mosaic2"]}
    for mode, reps in (("nocond", 12), ("cond", 12), ("cond", 1), ("cond", 4),
                       ("cond", 36)):
        got = micro_mosaic2.micro_mosaic2(x, tab, mode=mode, n_it=1024,
                                          body_reps=reps)
        (want, taken), plain_ms = _timed_once(
            lambda: micro_mosaic2.micro_mosaic2_ref(
                x, tab, mode=mode, n_it=1024, body_reps=reps,
                return_taken=True))
        add("micro_mosaic2", f"{mode}_r{reps}",
            by_run[(mode, 1024, reps)]["ms"], micro_mosaic2.GRID * 1024, got,
            want, plain_ms, micro_mosaic2.work(mode, 1024, reps, taken=taken))

    tab = t(micro_dyn.inputs())
    by_mode = {r["mode"]: r for r in runs["micro_dyn"]}
    for mode in micro_dyn.MODES:
        got = micro_dyn.micro_dyn(tab, mode=mode)
        want, plain_ms = _timed_once(lambda: micro_dyn.micro_dyn_ref(
            tab, mode=mode))
        add("micro_dyn", mode, by_mode[mode]["ms"],
            micro_dyn.GRID * micro_dyn.N_IT, got, want, plain_ms,
            micro_dyn.work(mode))
    # matmul_small's acc grows about 11-fold an iteration and is NaN at
    # 2048: over 24 iterations it is about 1e29.
    check("micro_dyn", "matmul_small", "n_it 24",
          micro_dyn.micro_dyn(tab, mode="matmul_small", n_it=24),
          micro_dyn.micro_dyn_ref(tab, mode="matmul_small", n_it=24))
    smemread = float(micro_dyn.micro_dyn(tab, mode="smemread"))
    if smemread != 128.0 * (micro_dyn.GRID - 1):
        raise AssertionError(f"m1: smemread {smemread}")

    # The plain version runs while as full (a loop's bound is no
    # operation of its own): one plain run serves both.
    def entry_plain(tri, mode):
        return micro_entry.micro_entry_ref(
            tri, mode="full" if mode == "while" else mode, with_scratch=True)

    tri = t(micro_entry.inputs())
    by_mode = {r["mode"]: r for r in runs["micro_entry"]}
    plain = {}
    for mode in micro_entry.MODES:
        got = micro_entry.micro_entry(tri, mode=mode, with_scratch=True)
        if mode != "while":
            plain[mode] = _timed_once(lambda: entry_plain(tri, mode))
        want, plain_ms = plain["full" if mode == "while" else mode]
        add("micro_entry", mode, by_mode[mode]["ms"],
            micro_entry.GRID * micro_entry.N_ENT, got, want, plain_ms,
            micro_entry.work(mode))
    # The probe's table gives the rays no hit: mt_only's and no_write's
    # acc are inf, and full's accumulator keeps its initial values.
    tri = t(micro_entry.hits_inputs())
    for mode in ("mt_only", "no_write", "full", "while"):
        if mode != "while":
            want = entry_plain(tri, mode)
        check("micro_entry", mode, "hits_inputs",
              micro_entry.micro_entry(tri, mode=mode, with_scratch=True),
              want)
    uncounted = [f"{name} {r['mode']}" for name, rows in modes.items()
                 for r in rows if (name, r["mode"]) not in counted]
    if uncounted:
        raise AssertionError(f"m1: no comparison with finite outputs for "
                             f"{uncounted}")

    stores = _sass_stores(micro_dyn._library()._name)
    dyn_mode = {m: k for k, m in enumerate(
        ("staticload", "dynload", "dynload8", "dynstore", "smemread",
         "smemwrite"))}
    sass = {"dynstore_stg": stores[dyn_mode["dynstore"]]["STG"],
            "dynload_stg": stores[dyn_mode["dynload"]]["STG"],
            "smemwrite_sts": stores[dyn_mode["smemwrite"]]["STS"],
            "smemread_sts": stores[dyn_mode["smemread"]]["STS"]}
    sass_ok = (sass["dynstore_stg"] > sass["dynload_stg"]
               and sass["smemwrite_sts"] > sass["smemread_sts"])
    emit("m1_micro", launches=launches, main_path_seconds=main_seconds,
         runs=runs, modes=modes, checks=checks, sass=sass,
         phase_seconds=time.perf_counter() - t_phase)
    if not sass_ok:
        raise AssertionError(f"m1: a store nothing reads was dropped: {sass}")
    result = {}
    for name, rows in modes.items():
        ops_binds = sum(r["bound_ms"] for r in rows
                        if r["bound_by"] == "operations")
        result[name] = {
            "launches": launches[name],
            "max_abs_err": max([r["max_abs_err"] for r in rows]
                               + [c["max_abs_err"] for c in checks
                                  if c["kernel"] == name]),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("operations" if 2 * ops_binds
                         >= sum(r["bound_ms"] for r in rows) else "bytes"),
            "modes": {r["mode"]: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                for r in rows},
        }
    return result


def _kernel_entry(name, source, replaces, launches, k):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{key: k[key] for key in keys}, "library_ms": None}


def main(seed: int = IO_SEED) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pbrt_tpu_torch  # noqa: F401  (fails outside a checkout)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dev = torch.device("cuda", 0)
    smi = phase_device()
    children = {"digests": start_cpu_child("--cpu-sampler-digests",
                                           SAMPLER_DIMS_FILE)}
    try:
        return _run(dev, smi, children, seed)
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()


def _run(dev, smi, children, seed: int) -> int:
    import torch

    builds = phase_build()
    micro = phase_micro(dev)
    cli_launches = phase_cli_golden(dev)
    phase_cli_first_image(smi)
    mesh_launches = phase_mesh(dev)
    mesh_launches.update(phase_multiprocess(smi))
    phase_native(dev)
    # After e16, whose child process times a cold start.
    children["coated"] = start_cpu_child("--cpu-coated-grads", COATED_CPU_FILE)
    k1 = phase_kernel_vs_twin(dev)
    killeroo = killeroo_on(dev)
    k2 = phase_k2_vs_twin(dev, killeroo)
    field = field_on(dev)
    k3 = phase_k3_vs_twin(dev, field, killeroo)
    k4 = phase_k4_vs_twin(dev, killeroo)
    phase_golden(dev)
    phase_golden_killeroo(dev, killeroo)
    phase_golden_instanced(dev, field)
    phase_golden_bvh(dev, killeroo)
    for phase, name, spp, per_pass, bounds, kernel in CXX_GOLDENS[:1]:
        phase_golden_cxx(dev, phase, name, spp, per_pass, bounds, kernel)
    phase_golden_kdtree(dev)
    for phase, name, spp, per_pass, bounds, kernel in CXX_GOLDENS[1:]:
        phase_golden_cxx(dev, phase, name, spp, per_pass, bounds, kernel)
    phase_furnace(dev)
    phase_golden_files_jax(dev, "d12_golden_lights_jax", JAX_LIGHT_GOLDENS)
    phase_golden_files_jax(dev, "d17_golden_materials_jax",
                           JAX_MATERIAL_GOLDENS)
    hall = hall_scenes()
    phase_k2_hall_vs_twin(dev, hall)
    phase_golden_hall(dev, hall)
    phase_grad_golden(dev)
    phase_grad_killeroo(dev, killeroo)
    phase_grad_file(dev, "g3_grad_spot", "spot", SPOT_GRAD_RTOL_OF_MAX)
    phase_grad_file(dev, "g4_grad_spheres", "spheres",
                    SPHERES_GRAD_RTOL_OF_MAX)
    phase_grad_coated(dev, children["coated"])
    grad_launches = {"grad_texel": phase_grad_texel(dev),
                     "grad_attached": phase_grad_attached(dev),
                     "grad_cvjp": phase_grad_cvjp(dev)}
    phase_k1_volpath_vs_twin(dev)
    phase_fog_box(dev)
    phase_golden_volpath_jax(dev)
    phase_grad_fog_box(dev)
    phase_k1_families_vs_twin(dev)
    phase_golden_families_jax(dev)
    grad_launches["grad_families"] = phase_grad_families(dev)
    leaf_launches = phase_grad_leaves(dev)
    grad_launches["grad_leaves"] = leaf_launches["smallscene"]
    grad_launches["grad_leaves_rest"] = phase_grad_leaves_rest(
        dev)["smallscene"]
    phase_k1_lighttransport_vs_twin(dev)
    phase_golden_mc(dev)
    phase_golden_lighttransport_jax(dev)
    phase_geometry_vs_twin(dev)
    phase_golden_geometry_jax(dev)
    phase_grad_motion(dev)
    phase_k1_cameras_vs_twin(dev)
    phase_golden_cameras_jax(dev)
    phase_samplers_and_resume(dev, children["digests"])
    phase_k1_io_vs_twin(dev)
    phase_golden_io_jax(dev)
    k1_launches = phase_timed(dev, 8)
    phase_timed(dev, 32)
    phase_timed_fwdbwd(dev, smi)
    phase_timed_fwdbwd_estimators(dev, smi)
    grad_launches["fwdbwd_leaves"] = phase_timed_fwdbwd_leaves(dev, smi)
    grad_launches["fwdbwd_leaves_rest"] = phase_timed_fwdbwd_leaves_rest(
        dev, smi)
    phase_train(dev)
    k2_launches = phase_timed_killeroo(dev, builds["cluster"]["seconds"])
    k3_launches = phase_timed_instanced(dev, field[3])
    k4_launches = phase_timed_bvh(dev)
    phase_timed_plymesh(dev, smi)
    phase_timed_gallery(dev, smi)
    phase_timed_texture(dev, smi)
    phase_timed_hall(dev, smi, hall)
    phase_timed_cloud(dev, smi)
    phase_timed_families(dev, smi)
    phase_timed_lighttransport(dev, smi)
    geom_launches = phase_timed_geometry(dev, smi)
    lens_launches = phase_timed_cameras(dev, smi)
    io_launches = phase_timed_io(dev, smi, seed)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    # No single PyTorch call computes a ray/triangle intersection, so no
    # kernel has a library yardstick. K2's, K3's and K4's errors are those
    # of the 1,048,576-ray comparisons, both modes. K1's launches are those
    # of the Cornell (e), shapes (e12), cornell_lens (e13) and io (e14)
    # main paths, of the gradient estimators' loss and gradient calls
    # (g8-g13), of e17's and e18's timed leaf passes, of the render CLI on
    # box.pbrt (d29), of p1's sharded renders and mesh step and of p2's
    # workers;
    # K2's of killeroo (e2), of the CLI on plymesh.pbrt (d29) and of
    # g12's plymesh.pbrt cases; K3's of the instanced
    # field (e3) and motion.pbrt (e12), each counted from zero around its
    # timed passes or its CLI call.
    lines = {}
    for name, res in (("cluster", k2), ("sweep", k3), ("traverse", k4)):
        lines[name] = {**res["closest"], "max_abs_err": max(
            res["closest"]["max_abs_err"], res["any_hit"]["max_abs_err"])}
    by_path = {"smallscene": {"cornell": k1_launches,
                              "shapes": geom_launches["shapes"][0],
                              "cornell_lens": lens_launches, **io_launches,
                              **grad_launches,
                              "cli_box": cli_launches["box"],
                              **mesh_launches},
               "cluster": {"killeroo": k2_launches,
                           "cli_plymesh": cli_launches["plymesh"],
                           "grad_leaves": leaf_launches["cluster"]},
               "sweep": {"instanced_field": k3_launches,
                         "motion": geom_launches["motion"][1]}}
    entries = [
        _kernel_entry("smallscene", K1_SOURCE, K1_REPLACES,
                      sum(by_path["smallscene"].values()), k1),
        _kernel_entry("cluster", K2_SOURCE, K2_REPLACES,
                      sum(by_path["cluster"].values()), lines["cluster"]),
        _kernel_entry("sweep", K3_SOURCE, K3_REPLACES,
                      sum(by_path["sweep"].values()), lines["sweep"]),
        _kernel_entry("traverse", K4_SOURCE, K4_REPLACES, k4_launches,
                      lines["traverse"]),
    ]
    for entry in entries:
        if entry["name"] in by_path:
            entry["launches_by_path"] = by_path[entry["name"]]
    # The micro kernels' times, plain times and bounds are sums over their
    # modes (one call of each, micro_mosaic2 at n_it 1024), each mode's
    # beside them; no single PyTorch call computes one of their loops.
    for name, (_, source, replaces) in MICRO_KERNELS.items():
        m = micro[name]
        entries.append({**_kernel_entry(name, source, replaces,
                                        m["launches"], m),
                        "modes": m["modes"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    children = {"--cpu-sampler-digests": _cpu_sampler_digests,
                "--cpu-coated-grads": _cpu_coated_grads}
    if sys.argv[1:2] and sys.argv[1] in children:
        # The card's process has the host first: its phases are host-bound.
        os.nice(19)
        sys.path.insert(0, ROOT)
        children[sys.argv[1]](sys.argv[2])
        sys.exit(0)
    # --seed N: the seed of e14's generated inputs (default 0).
    sys.exit(main(int(sys.argv[sys.argv.index("--seed") + 1])
                  if "--seed" in sys.argv else IO_SEED))
