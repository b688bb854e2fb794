"""Path integrator: NEE + MIS + Russian roulette over a fixed bounce loop.

Port of pbrt_tpu/models/path.py: the primal transport, the subsurface
step, every gradient estimator of the reference, and tag-sorted shading
(materials/sorted.py, on by the reference's `sorted_shading="auto"`
rule). A scene with moving instances gives each ray a shutter time from
its dim-5 draw, the draw that moves a moving camera (render.py), and
every query of the path takes it.
The reference's lax.scan over bounces is a Python loop here; all rays
advance in lockstep and terminated rays are masked, not compacted, so
every bounce issues the same queries as the reference: one closest-hit
and one any-hit per bounce, plus the terminal closest-hit, and, when the
geometry references a subsurface material, the subsurface probe's
closest-hit on every lane of every bounce (materials/bssrdf.py).

Gradients. The queries carry none (ops/detach.py): hit points move as
p = o + t d with t fixed. The estimator follows the reference's
switches (`estimator`):
- "remat" (the default: replay_grad with grad_mode "remat"): the
  detached-sampling estimator. Gradients flow only through BSDF values,
  emission and light radiance; frames, sampled directions and pdfs are
  detached where the reference stops them. The reference's
  `save_only_these_names("trav")` remat becomes `torch.utils.checkpoint`
  around the shading between the queries, two segments per bounce split
  at the shadow query: the backward pass recomputes shading only.
- "cvjp" (grad_mode "cvjp"): the same estimator as a record and replay
  custom VJP (_TraceCVJP). The forward records each bounce's query
  results; the backward replays the shading from the records with no
  query, each replayed bounce checkpointed as `replay_remat` says
  ("full", "dots": the matrix products saved, "none": plain autograd).
- "attached" (replay_grad=False, or any subsurface material): plain
  autograd with nothing of the shading detached, as the reference's
  plain `_run`; the gradient also flows through the sampled directions
  into the next hit point. Russian roulette's decision stays detached.
A backward pass never runs a query. Which scene leaves may require grad
depends on the estimator (TRAINABLE), each held against the reference's
gradient under that estimator: every estimator differentiates the
albedo, the image texels, the conductors' spectra, the coat's thickness,
the diffuse transmission and the area, sphere, projection, goniometric
and distant lights' tables; remat and cvjp also the other texture tables,
the point, spot, uniform infinite, image and portal lights' tables and
the sampling tables (the image light's importance tables, the selection
pmf and cdf), which reach the loss only through the MIS pdfs: under
remat they carry a gradient, under cvjp, whose replay reads the recorded
pdfs as the reference's does, it is zero, and so is the light BVH's node
table's, which trains under cvjp only; remat and attached the roughness
and the coat's roughness; the attached estimator eta and the hair,
subsurface, measured and mix leaves. A request for any other leaf, or
for o, d or the wavelengths, raises NotImplementedError with its reason
(_REFUSED, NO_GOLDEN): roughness under cvjp and the node table under
remat, whose reference gradients are NaN, and any leaf under an
estimator without its golden.

RNG dimension layout (per ray; stateless pcg4d streams, core/rng.py):
  dims 0-7            camera: pixel jitter (0,1), lens (2,3), wavelength (4),
                      shutter time (5)
  dims 8 + 8*depth +  0      light selection
                      1      light point (2D)
                      2      bsdf lobe selection
                      3      bsdf direction (2D)
                      4      russian roulette
                      5, 6   subsurface probe radius and angle
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint

from ..accel import api as accel_api
from ..accel.dense import offset_ray_origin, shadow_segment
from ..core import rgb2spec
from ..core.sampling import power_heuristic
from ..core.tensorclass import static_field, tensorclass
from ..core.vecmath import dot, from_local, shading_frame, to_local
from ..materials import bxdf
from ..materials import scattering as sc
from ..materials.bssrdf import subsurface_exit
from ..materials.buffers import MAT_NORMFRESNEL, MAT_SUBSURFACE
from ..shapes.geometry import Interaction

_CAM_DIMS = 8
_BOUNCE_DIMS = 8

# The reference's default trainable set (pbrt_tpu/parallel/train.py).
DEFAULT_TRAINABLE = ("materials.albedo_coeffs", "lights.area_scale")
_ITEM5 = "ROADMAP Queue 1 item 5"


def _p(part, *names):
    return tuple(f"{part}.{n}" for n in names)


_COND = _p("materials", "cond_eta_coeffs", "cond_eta_scale", "cond_k_coeffs",
           "cond_k_scale")
_LIGHT_TABLES = _p("lights", "area_coeffs", "sphl_coeffs", "sphl_scale",
                   "proj_coeffs", "proj_scale_tx", "gonio_coeffs",
                   "gonio_scale_tx", "distant_coeffs", "distant_scale")
# Scene leaves each estimator differentiates, each held against the
# reference's gradient under that estimator (tests/test_torch_grad*.py;
# the goldens of scripts/make_torch_port_golden_grad.py and
# make_torch_port_golden_leaves.py). The leaves that move the sampled
# directions (eta, roughness, coat_roughness, hair_alpha) train under the
# detached estimators only where such a golden was made.
_DETACHED_TRAINABLE = (
    *DEFAULT_TRAINABLE, "textures.img_flat", *_COND,
    *_p("materials", "thickness", "trans_coeffs"),
    *_p("textures", "rgb0", "rgb1", "rgb2", "rgb3", "f0", "ptex_flat"),
    *_LIGHT_TABLES,
    *_p("lights", "point_coeffs", "point_scale", "spot_coeffs", "spot_scale",
        "infinite_coeffs", "infinite_scale", "env.coeffs", "env.scale",
        "env.scale_tx", "env.strength"),
    # The sampling tables, read through the MIS pdfs only: the image
    # light's importance tables and the light selection's pmf and cdf.
    *(f"lights.env.dist.{t}.{f}" for t in ("conditional", "marginal")
      for f in ("func", "cdf", "integral")),
    *_p("lights", "env.luminance", "select_pmf", "select_cdf"),
)
TRAINABLE = {
    "remat": (*_DETACHED_TRAINABLE,
              *_p("materials", "roughness", "coat_roughness")),
    # cvjp's replay reads the recorded MIS pdfs, so the light BVH's node
    # table gets its zero gradient there.
    "cvjp": (*_DETACHED_TRAINABLE, "lights.bvh.nodes"),
    "attached": (
        *DEFAULT_TRAINABLE, "textures.img_flat", "materials.eta", *_COND,
        *_p("materials", "roughness", "coat_roughness", "thickness",
            "trans_coeffs", "hair_sigma_coeffs", "hair_sigma_scale",
            "hair_alpha", "ss_mfp_coeffs", "ss_mfp_scale", "measured_coeffs",
            "measured_scale", "mix_amount"),
        *_LIGHT_TABLES),
}
# Why a leaf outside TRAINABLE[estimator] is refused, by dotted path or
# by a prefix ending in "."; any other has no golden under that
# estimator (NO_GOLDEN).
_REFUSED = {
    **{f"materials.{r}": "the reference's reverse-mode gradient of a "
                         "microfacet roughness is NaN, and cvjp, a custom "
                         "VJP, has no forward mode to hold it against "
                         "(ROADMAP Queue 3)"
       for r in ("roughness", "coat_roughness")},
    "materials.eta": "eta moves the sampled directions, which only the "
                     "attached estimator (replay_grad=False) differentiates",
    "lights.bvh.": "the reference's gradient through the light BVH's pmf "
                   "(the MIS weight's) is NaN in both modes; only cvjp, "
                   "whose replay reads the recorded pmf, answers it "
                   "(ROADMAP Queue 3)",
}
NO_GOLDEN = ("it has no golden under this estimator (ROADMAP Queue 3, item "
             "5e's departures)")


def refusal_reason(refused: dict, name: str, default: str) -> str:
    """The stated reason of `refused` for a dotted leaf path: its own
    entry, or that of the longest prefix ending in "." it starts with."""
    if name in refused:
        return refused[name]
    hits = [k for k in refused if k.endswith(".") and name.startswith(k)]
    return refused[max(hits, key=len)] if hits else default


def refuse_gradient(scene, integrator: str) -> None:
    """Raise when autograd is on and a floating tensor of the scene
    requires grad: the light-tracing and specialty integrators (light
    path, BDPT, SPPM, MLT, AO, random walk, spectral bands) are forward
    only."""
    if not torch.is_grad_enabled():
        return
    for name, x in _tensors(scene, "scene"):
        if x.is_floating_point() and x.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: gradients through {integrator} are "
                f"not ported ({_ITEM5}); render under torch.no_grad()")


def _tensors(value, name: str):
    """(path, tensor) of every tensor in a nest of tensorclasses."""
    if isinstance(value, torch.Tensor):
        yield name, value
    elif dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name), f"{name}.{f.name}")


def _requested_leaves(scene, o, d, wl, estimator: str) -> list:
    """Dotted paths of the scene leaves that require grad, when autograd
    is on. Raises for a request on o, d or the wavelengths, and on any
    leaf outside TRAINABLE[estimator]: the port has no answer for them
    that is held against the reference."""
    if not torch.is_grad_enabled():
        return []
    for name, x in [("o", o), ("d", d), *_tensors(wl, "wl")]:
        if x.is_floating_point() and x.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: gradients with respect to rays and "
                f"wavelengths are not ported ({_ITEM5}); trace under "
                "torch.no_grad() or without a grad request"
            )
    asked = []
    for name, x in _tensors(scene, "scene"):
        if not (x.is_floating_point() and x.requires_grad):
            continue
        name = name.removeprefix("scene.")
        if name not in TRAINABLE[estimator]:
            why = refusal_reason(_REFUSED, name, NO_GOLDEN)
            raise NotImplementedError(
                f"scene.{name} requires grad under the {estimator} "
                f"estimator: {why}; it differentiates "
                f"{TRAINABLE[estimator]} ({_ITEM5})")
        asked.append(name)
    return asked


def get_leaf(scene, path: str):
    """The scene tensor at a dotted path."""
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def with_leaves(scene, updates: dict):
    """The scene with the tensors at dotted paths replaced (any depth)."""
    by_child = {}
    for path, value in updates.items():
        child, _, rest = path.partition(".")
        by_child.setdefault(child, {})[rest] = value
    reps = {}
    for child, leaves in by_child.items():
        part = getattr(scene, child)
        if "" in leaves:
            reps[child] = leaves[""]
        else:
            reps[child] = with_leaves(part, leaves)
    return scene.replace(**reps)


def _frame(isect):
    """The shading frame (t1, t2, ns, wo_l): the geometric normal flipped
    toward wo (no shading normals), its tangents and wo in it."""
    cos_o = dot(isect.n, isect.wo, keepdims=True)
    ns = isect.n * torch.sign(torch.where(cos_o == 0.0, 1.0, cos_o))
    t1, t2 = shading_frame(ns, isect.dpdu)
    return t1, t2, ns, to_local(isect.wo, t1, t2, ns)


def _subsurface_step(scene, isect, frame, params, hit, beta, lam, u_r, u_phi):
    """SeparableBSSRDF::Sample_S (bssrdf.h, wavefront/subsurface.cpp) at
    the hit lanes of a subsurface material: the Fresnel transmission at
    the entry, the Burley diffusion to a probed exit vertex, and the
    vertex, its frame and its wo (the exit normal) moved there; the
    lane's kind becomes MAT_NORMFRESNEL, the exit lobe that NEE and BSDF
    sampling then shade. Every lane issues the probe. Returns (beta,
    isect, frame, params, subsurface lane count)."""
    t1, t2, ns, wo_l = frame
    is_ss = hit & (params["kind"] == MAT_SUBSURFACE)
    albedo = rgb2spec.eval_sigmoid(params["albedo_coeffs"], lam)
    mfp = rgb2spec.eval_unbounded(params["ss_mfp_coeffs"],
                                  params["ss_mfp_scale"], lam)
    p_exit, n_exit, w_ss, _ = subsurface_exit(
        scene, isect, ns, t1, t2, albedo, mfp[..., 0], u_r, u_phi)
    fr_in = sc.fr_dielectric(torch.abs(wo_l[..., 2]), params["eta"])
    beta = torch.where(is_ss[..., None],
                       beta * w_ss * (1.0 - fr_in)[..., None], beta)
    m = is_ss[:, None]
    new_n = torch.where(m, n_exit, isect.n)
    isect = isect.replace(
        p=torch.where(m, p_exit, isect.p),
        n=new_n,
        wo=torch.where(m, new_n, isect.wo),
        dpdu=torch.where(m, torch.zeros_like(isect.dpdu), isect.dpdu),
    )
    params = dict(params, kind=torch.where(is_ss, MAT_NORMFRESNEL,
                                           params["kind"]))
    return (beta, isect, _frame(isect), params,
            torch.sum(is_ss.to(torch.float32)))


def _remat(fn, *args, context_fn=None):
    """Run a function so that its backward recomputes it instead of
    keeping its activations (the reference's remat); `context_fn` picks
    what is kept after all (selective checkpointing). The function draws
    no random numbers of torch's (its draws are hashed from their
    inputs), so no RNG state is kept and the recompute is bit-equal to
    the forward."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw
    )


def _direct(fn, *args):
    return fn(*args)


def _keep_products():
    """replay_remat="dots": the checkpoint keeps the outputs of matrix
    products and recomputes the rest (jax.checkpoint_policies.
    dots_saveable)."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.addmm.default])


_REPLAY_REMAT = {
    "full": _remat,
    "dots": functools.partial(_remat, context_fn=_keep_products),
    "none": _direct,
}


def _bsdf_calls(params, ops):
    """The BxDF calls of one shading point: the BSDF sample and, with a
    light sample's direction ops["wi"], NEE's f and pdf."""
    out = {"bs": bxdf.sample(params, ops["wo"], params["lam"], ops["u2"],
                             ops["uc"])}
    if "wi" in ops:
        out["f_nee"] = bxdf.evaluate(params, ops["wo"], ops["wi"],
                                     params["lam"])
        out["pdf_b"] = bxdf.pdf(params, ops["wo"], ops["wi"])
    return out


# The fields of a closest-hit record (the Interaction but p and wo, which
# the replay derives from the ray).
_HIT_FIELDS = ("valid", "t", "n", "uv", "mat", "light", "prim", "dpdu")


class _Queries:
    """The queries of one trace. Live, each query runs on the scene's
    tier and, when `records` is a list, appends its result to it; in a
    replay (`replay` the records of a recording trace) each returns the
    recorded result and no query runs."""

    def __init__(self, scene, ray_time, records=None, replay=None):
        self.scene, self.time = scene, ray_time
        self.records, self.replay = records, replay

    def closest(self, key, o, d, active):
        if self.replay is not None:
            rec = self.replay[key]
            return Interaction(
                p=accel_api.hit_point(rec["valid"], o, d, rec["t"]), wo=-d,
                **rec)
        isect = accel_api.closest(
            self.scene, o, d, tmax=torch.where(active, float("inf"), 0.0),
            time=self.time)
        if self.records is not None:
            self.records[key] = {f: getattr(isect, f) for f in _HIT_FIELDS}
        return isect

    def recorded(self, key, compute):
        """compute()'s tensors, which a replay reads from the records: the
        MIS pdfs, pure geometry that the reference's replay reads back
        too, so no sampling table gets a gradient through them under
        cvjp."""
        if self.replay is not None:
            return self.replay[key]
        out = compute()
        if self.records is not None:
            self.records[key] = tuple(x.detach() for x in out)
        return out

    def occluded(self, key, so, wi, smax):
        if self.replay is not None:
            return self.replay[key]
        occ = accel_api.any_hit(self.scene, so, wi, smax, time=self.time)
        if self.records is not None:
            self.records[key] = occ
        return occ


class _TraceCVJP(torch.autograd.Function):
    """grad_mode="cvjp" (the reference's _trace_cvjp): the forward traces
    with the queries and records their results; the backward replays the
    shading from the records, with no query, and returns the cotangents
    of the scene leaves passed in `leaves` (dotted paths `names`)."""

    @staticmethod
    def forward(ctx, integ, scene, names, args, *leaves):
        records = {}
        L, stats = integ._run(scene, *args, records=records)
        ctx.replay = (integ, scene, names, args, records)
        ctx.mark_non_differentiable(stats["rays"])
        return L, stats["rays"]

    @staticmethod
    def backward(ctx, g_L, _g_rays):
        integ, scene, names, args, records = ctx.replay
        ctx.replay = None
        with torch.enable_grad():
            leaves = [get_leaf(scene, n).detach().requires_grad_(True)
                      for n in names]
            replayed = with_leaves(scene, dict(zip(names, leaves)))
            L, _ = integ._run(replayed, *args, estimator="replay",
                              replay=records)
            if not L.requires_grad:
                # No leaf reaches the replay (a sampling table, read only
                # through the recorded pdfs).
                return (None, None, None, None,
                        *(torch.zeros_like(x) for x in leaves))
            grads = torch.autograd.grad(L, leaves, g_L, allow_unused=True)
        return (None, None, None, None, *grads)


@tensorclass
class PathIntegrator:
    max_depth: int = static_field(default=5)
    rr_start_depth: int = static_field(default=2)
    use_nee: bool = static_field(default=True)
    use_mis: bool = static_field(default=True)
    # The reference's gradient switches (the module docstring): the
    # detached estimator by path replay (replay_grad) through remat or the
    # record and replay VJP (grad_mode), the replayed bounce's checkpoint
    # policy (replay_remat), or the attached estimator (replay_grad=False).
    replay_grad: bool = static_field(default=True)
    replay_remat: str = static_field(default="full")
    grad_mode: str = static_field(default="remat")
    # Tag-sorted shading dispatch (materials/sorted.py): True, False or
    # "auto", which sorts when the scene's material list holds a costly
    # family (coated, hair, measured, subsurface), as the reference's rule
    # does; batches of at most sort_tile lanes are never sorted.
    sorted_shading: object = static_field(default="auto")
    sort_tile: int = static_field(default=8192)

    def __post_init__(self):
        if self.grad_mode not in ("remat", "cvjp"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}")
        if self.replay_remat not in _REPLAY_REMAT:
            raise ValueError(f"unknown replay_remat {self.replay_remat!r}")
        if self.sorted_shading not in (True, False, "auto"):
            raise ValueError(
                f"unknown sorted_shading {self.sorted_shading!r}")

    def estimator(self, scene) -> str:
        """The gradient estimator this integrator runs on `scene`: the
        reference's plain AD ("attached") without replay_grad or with any
        subsurface material, else its grad_mode ("remat" or "cvjp")."""
        if (not self.replay_grad or scene.materials.any_subsurface
                or MAT_SUBSURFACE in scene.shaded_kinds):
            return "attached"
        return self.grad_mode

    def sorts_shading(self, scene) -> bool:
        """Whether the BxDF calls go through the tag-sorted dispatch."""
        if self.sorted_shading != "auto":
            return bool(self.sorted_shading)
        m = scene.materials
        return bool(m.any_coated or m.any_hair or m.any_measured
                    or m.any_subsurface)

    def trace(self, scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays. Returns (N, S)."""
        return self.trace_with_stats(
            scene, o, d, wl, pixel, sample_idx, sampler
        )[0]

    def trace_with_stats(self, scene, o, d, wl, pixel, sample_idx, sampler):
        """Estimate radiance along N camera rays.

        o, d: (N, 3); wl: SampledWavelengths (N, S); pixel: (N,) ids;
        sample_idx: (N,) or scalar; sampler: a Sampler or an int seed.
        Returns ((N, S) radiance, stats) where stats["rays"] is the number
        of closest-hit + shadow queries actually alive (a 0-d float32
        tensor, counted as the reference counts it, once per pass also
        when a backward pass follows).
        """
        from ..samplers.samplers import as_sampler

        sampler = as_sampler(sampler)
        est = self.estimator(scene)
        names = _requested_leaves(scene, o, d, wl, est)
        if not names:
            return self._run(scene, o, d, wl, pixel, sample_idx, sampler)
        if est == "cvjp":
            L, rays = _TraceCVJP.apply(
                self, scene, names, (o, d, wl, pixel, sample_idx, sampler),
                *(get_leaf(scene, n) for n in names))
            return L, {"rays": rays}
        return self._run(scene, o, d, wl, pixel, sample_idx, sampler,
                         estimator=est)

    def _run(self, scene, o, d, wl, pixel, sample_idx, sampler,
             estimator=None, records=None, replay=None):
        """The transport. estimator: None (no gradient asked), "remat",
        "attached" or "replay" (the cvjp backward's detached replay);
        records: a dict that receives every query's result, keyed by
        bounce; replay: such a dict, read instead of querying."""
        medium = getattr(scene, "medium", None)
        if ((medium is not None and not medium.is_none)
                or getattr(scene, "media_stack", None) is not None):
            # The reference's path integrator ignores the media silently.
            raise ValueError("the scene has participating media; render it "
                             "with models/volpath.py's VolPathIntegrator")
        segment = _remat if estimator == "remat" else _direct
        # The detached-sampling stance of the remat and replay estimators:
        # the light sample's and the BSDF sample's direction and pdf carry
        # no gradient. (Without a gradient request detaching changes no
        # value.)
        detach = estimator != "attached"
        n = o.shape[0]
        s = wl.lam.shape[-1]
        lam = wl.lam
        dev, f32 = o.device, o.dtype
        lights = scene.lights
        have_lights = lights.n_lights > 0
        do_nee = self.use_nee and have_lights
        subsurface = MAT_SUBSURFACE in scene.shaded_kinds
        if self.sorts_shading(scene):
            from ..materials.sorted import shade_sorted

            def dispatch(params, ops):
                return shade_sorted(params, ops, _bsdf_calls,
                                    tile=self.sort_tile)
        else:
            dispatch = _bsdf_calls

        # The rays' shutter times for the moving instances.
        ray_time = None
        if scene.anim is not None:
            u_t = sampler.get_1d(pixel, sample_idx, 5)
            ray_time = scene.anim.time0 + u_t * (scene.anim.time1
                                                 - scene.anim.time0)
        queries = _Queries(scene, ray_time, records, replay)

        def kept(x, keep):
            """x, and under the attached estimator 1 where not `keep`: the
            lanes that a where then drops pass a gradient of 0 through a
            division, not 0 * inf (the reference's is NaN there, ROADMAP
            Queue 3). The detached estimators stop these gradients."""
            return x if detach else torch.where(keep, x, 1.0)

        def mis_pdfs(isect, d_cur, o_cur, prev_p, prev_ns):
            # A lane that hits no light takes no weight w_l (its t is inf
            # on a miss).
            dist = isect.t if detach else kept(isect.t, isect.light >= 0)
            return (lights.pdf_li_area(isect.light, dist,
                                       dot(isect.n, isect.wo),
                                       p_ref=prev_p, n_ref=prev_ns),
                    lights.pdf_escaped(d_cur, o_cur))

        def mis_weights(key, isect, active, d_cur, o_cur, prev):
            """Where emission and escaped radiance count, and their MIS
            weights against NEE from the previous vertex."""
            prev_pdf, specular, prev_p, prev_ns = prev
            if self.use_mis and self.use_nee:
                light_pdf, esc_pdf = queries.recorded(
                    ("mis", key), lambda: mis_pdfs(isect, d_cur, o_cur,
                                                   prev_p, prev_ns))
                w_l = torch.where(
                    specular, 1.0, power_heuristic(1, prev_pdf, 1, light_pdf)
                )
                w_esc = torch.where(
                    specular, 1.0, power_heuristic(1, prev_pdf, 1, esc_pdf)
                )
            elif self.use_nee:
                w_l = w_esc = torch.where(specular, 1.0, 0.0)
            else:
                w_l = w_esc = torch.ones_like(isect.t)
            emit_mask = active & isect.valid & (isect.light >= 0)
            return emit_mask, w_l, active & ~isect.valid, w_esc

        def add_emission(L, beta, isect, d_cur, o_cur, weights):
            """Emitted radiance at area-light hits and escaped radiance."""
            emit_mask, w_l, escaped, w_esc = weights
            le = lights.emitted(isect.light, isect.n, isect.wo, lam)
            L = L + torch.where(emit_mask[..., None], beta * w_l[..., None] * le, 0.0)
            return L + torch.where(
                escaped[..., None],
                beta * w_esc[..., None] * lights.escaped_radiance(d_cur, lam, o_cur),
                0.0,
            )

        def shade(L, beta, isect, d, o, weights, frame, u, params=None):
            """First segment of a bounce, between the closest-hit (or the
            subsurface step, which adds the emission and gathers params
            itself) and the shadow query: emission, the light sample, the
            BSDF sample and the NEE contribution. Under the detached
            estimators the live outputs are L, contrib and bs["f"]; the
            light sample's direction, pdf and distance and the sampled
            direction and pdf are detached, as the reference stops them."""
            if weights is not None:
                L = add_emission(L, beta, isect, d, o, weights)
            t1, t2, ns, wo_l = frame
            if params is None:
                params = bxdf.surface_params(scene, isect, lam)
            ops = {"wo": wo_l, "u2": u["bsdf"], "uc": u["lobe"]}
            if do_nee:
                ls = lights.sample_li(isect.p, lam, u["sel"], u["pos"], n_ref=ns)
                if detach:
                    ls = ls.replace(wi=ls.wi.detach(), pdf=ls.pdf.detach(),
                                    dist=ls.dist.detach())
                wi_l = to_local(ls.wi, t1, t2, ns)
                ops["wi"] = wi_l
            # One shading dispatch for the BSDF sample and NEE's f and pdf.
            sh = dispatch(params, ops)
            bs = sh["bs"]
            if detach:
                bs = dict(bs, wi=bs["wi"].detach(), pdf=bs["pdf"].detach())
            out = {"L": L, "bs": bs}

            # Next-event estimation (integrators.cpp SampleLd).
            if do_nee:
                f_nee = sh["f_nee"] * torch.abs(wi_l[..., 2:3])
                pdf_b = sh["pdf_b"]
                if self.use_mis:
                    w_nee = torch.where(
                        ls.is_delta, 1.0, power_heuristic(1, ls.pdf, 1, pdf_b)
                    )
                else:
                    w_nee = torch.ones_like(ls.pdf)
                live = ls.pdf > 0.0
                out["contrib"] = torch.where(
                    live[..., None],
                    beta * f_nee * ls.L
                    * (w_nee / torch.clamp(kept(ls.pdf, live),
                                           min=1e-20))[..., None],
                    0.0,
                )
                out["ls"] = ls
            return out

        def scatter(L, beta, contrib, f, unoccluded, ok, cos_wi, pdf, rr):
            """Second segment of a bounce, after the shadow query: the NEE
            contribution of unoccluded lanes, the throughput update and
            Russian roulette (its decision on detached throughput)."""
            if contrib is not None:
                L = L + torch.where(unoccluded[..., None], contrib, 0.0)
            beta = torch.where(
                ok[..., None],
                beta * f * (cos_wi / torch.clamp(kept(pdf, ok),
                                                 min=1e-20))[..., None],
                beta,
            )
            # Russian roulette on spectral max throughput
            # (integrators.cpp:750-758). Below rr_start_depth it is the
            # identity (kill never, scale 1), so it is skipped.
            kill = None
            if rr is not None:
                q = torch.clamp(1.0 - torch.amax(beta.detach(), dim=-1), 0.0, 0.95)
                kill = (rr < q) & ok
                scale = torch.where(ok, 1.0 / torch.clamp(1.0 - q, min=0.05), 1.0)
                beta = torch.where(kill[..., None], 0.0, beta * scale[..., None])
            return L, beta, kill

        def bounce(depth, st):
            """One bounce: the closest hit, the subsurface step, shading,
            the shadow query and the next ray. st: the path state (o, d,
            L, beta, active, prev, rays), where prev is the previous
            vertex's BSDF pdf, specular flag, point and shading normal
            (the MIS context)."""
            o, d, L, beta, active, prev = (
                st[k] for k in ("o", "d", "L", "beta", "active", "prev"))
            n_rays = st["rays"] + torch.sum(active.to(torch.float32))
            # Dead lanes get tmax = 0 and fail every hit gate.
            isect = queries.closest(depth, o, d, active)
            weights = (mis_weights(depth, isect, active, d, o, prev)
                       if have_lights else None)
            hit = active & isect.valid

            frame = _frame(isect)
            dim0 = _CAM_DIMS + depth * _BOUNCE_DIMS
            params = None
            if subsurface:
                # The emission at the entry, then the move to the exit;
                # the material row is the entry's. Only the attached
                # estimator runs it under a gradient request, so it runs
                # outside the checkpointed segments.
                params = bxdf.surface_params(scene, isect, lam)
                if weights is not None:
                    L = add_emission(L, beta, isect, d, o, weights)
                    weights = None
                beta, isect, frame, params, n_ss = _subsurface_step(
                    scene, isect, frame, params, hit, beta, lam,
                    sampler.get_1d(pixel, sample_idx, dim0 + 5),
                    sampler.get_1d(pixel, sample_idx, dim0 + 6))
                n_rays = n_rays + n_ss
            t1, t2, ns, _ = frame
            u = {}
            if do_nee:
                u["sel"] = sampler.get_1d(pixel, sample_idx, dim0 + 0)
                up0, up1 = sampler.get_2d(pixel, sample_idx, dim0 + 1)
                u["pos"] = torch.stack([up0, up1], dim=-1)
            u["lobe"] = sampler.get_1d(pixel, sample_idx, dim0 + 2)
            ub0, ub1 = sampler.get_2d(pixel, sample_idx, dim0 + 3)
            u["bsdf"] = torch.stack([ub0, ub1], dim=-1)

            sh = segment(shade, L, beta, isect, d, o, weights, frame, u,
                         params)
            bs = sh["bs"]
            unoccluded = contrib = None
            if do_nee:
                ls, contrib = sh["ls"], sh["contrib"]
                need_shadow = hit & (ls.pdf > 0.0) & torch.any(contrib != 0.0, dim=-1)
                so, wi_sh, smax = shadow_segment(isect.p, isect.n, ls.wi, ls.dist)
                occluded = queries.occluded(
                    ("shadow", depth),
                    torch.where(need_shadow[..., None], so, torch.zeros_like(so) + 1e8),
                    wi_sh,
                    torch.where(need_shadow, smax, 0.0),
                )
                unoccluded = need_shadow & ~occluded
                n_rays = n_rays + torch.sum(need_shadow.to(torch.float32))

            # BSDF sampling -> next ray (integrators.cpp:736-758).
            wi_w = from_local(bs["wi"], t1, t2, ns)
            cos_wi = torch.abs(bs["wi"][..., 2])
            ok = hit & (bs["pdf"] > 0.0)
            rr = None
            if depth >= self.rr_start_depth:
                rr = sampler.get_1d(pixel, sample_idx, dim0 + 4)
            L, beta, kill = segment(scatter, sh["L"], beta, contrib, bs["f"],
                                    unoccluded, ok, cos_wi, bs["pdf"], rr)
            o_new = offset_ray_origin(isect.p, isect.n, wi_w)
            prev_pdf, specular, prev_p, prev_ns = prev
            return {
                "o": torch.where(ok[..., None], o_new, o),
                "d": torch.where(ok[..., None], wi_w, d),
                "L": L,
                "beta": beta,
                "active": ok if kill is None else ok & ~kill,
                "prev": (
                    torch.where(ok, bs["pdf"], prev_pdf),
                    torch.where(ok, bs["specular"], specular),
                    torch.where(ok[..., None], isect.p, prev_p),
                    torch.where(ok[..., None], ns, prev_ns),
                ),
                "rays": n_rays,
            }

        st = {
            "o": o,
            "d": d,
            "L": torch.zeros((n, s), dtype=f32, device=dev),
            "beta": torch.ones((n, s), dtype=f32, device=dev),
            "active": torch.ones((n,), dtype=torch.bool, device=dev),
            "prev": (
                torch.ones((n,), dtype=f32, device=dev),
                torch.ones((n,), dtype=torch.bool, device=dev),
                o,
                torch.zeros((n, 3), dtype=f32, device=dev),
            ),
            "rays": torch.zeros((), dtype=torch.float32, device=dev),
        }
        # The replay checkpoints each whole bounce (it holds no query);
        # the remat estimator checkpoints the segments between the
        # queries inside it.
        step = (_REPLAY_REMAT[self.replay_remat] if estimator == "replay"
                else _direct)
        for depth in range(self.max_depth):
            st = step(bounce, depth, st)

        # Terminal emission tier: the reference's depth loop adds Le at the
        # (max_depth+1)-th vertex before breaking, so BSDF-sampled light
        # hits one segment past the last NEE still contribute their MIS
        # complement (integrators.cpp "if (depth++ == maxDepth) break;").
        # Plain autograd, as in the reference.
        L, rays = st["L"], st["rays"]
        if have_lights:
            o, d, active = st["o"], st["d"], st["active"]
            isect = queries.closest("terminal", o, d, active)
            L = add_emission(L, st["beta"], isect, d, o,
                             mis_weights("terminal", isect, active, d, o,
                                         st["prev"]))
            rays = rays + torch.sum(active.to(torch.float32))
        return L, {"rays": rays}
