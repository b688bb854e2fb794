"""Scene reformatter / upgrader: the FormattingParserTarget equivalent.

Port of pbrt_tpu/tools/format_scene.py on the port's tokenizer
(io/parser.py) and PLY writer (io/ply.py); text processing on the host.
Reference: pbrt-v4 src/pbrt/parser.h:202-272 and the
FormattingParserTarget implementations in parser.cpp:1100-1870 —
`pbrt --format` (canonical reprint), `--toply` (big trianglemeshes out to
binary PLY), `--upgrade` (pbrt-v3 -> v4 directive/parameter migration).

Host-side text processing only: a directive walker over the
shared tokenizer that re-emits a canonically indented scene, applying the
reference's upgrade table:
  Sampler  lowdiscrepancy/02sequence -> paddedsobol, maxmindist -> pmj02bn,
           random -> independent
  Film     image -> rgb, scale -> iso*100, maxsampleluminance ->
           maxcomponentvalue
  Filter   xwidth/ywidth -> xradius/yradius, gaussian alpha ->
           sigma = 1/sqrt(2 alpha)
  Integrator directlighting -> path + maxdepth 1, drop rrthreshold,
           lightsamplestrategy spatial -> bvh
  Camera   environment -> spherical equirectangular
  Material uber/plastic/substrate -> coateddiffuse (or diffuse when Ks=0),
           matte -> diffuse, metal -> conductor, glass -> dielectric,
           mirror -> conductor(roughness 0, Ag), translucent ->
           diffusetransmission, kdsubsurface -> subsurface, disney ->
           diffuse, none/"" -> interface; Kd -> reflectance, index -> eta,
           bumpmap -> displacement; mix: RGB amount -> scalar,
           namedmaterial1/2 -> "string materials" (swapped order)
  MakeNamedMedium heterogeneous -> uniformgrid
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from ..io.parser import _TokenStream, _parse_params, tokenize

_BARE = {
    "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "ObjectEnd", "TransformBegin", "TransformEnd", "Identity",
    "ReverseOrientation",
}
_FIXED = {
    "Translate": 3, "Rotate": 4, "Scale": 3, "LookAt": 9,
    "TransformTimes": 2,
}
_MATRIX = {"Transform", "ConcatTransform"}
_NAME_ONLY = {
    "ObjectBegin", "ObjectInstance", "NamedMaterial", "Include", "Import",
    "CoordinateSystem", "CoordSysTransform", "ColorSpace", "NamedMedium",
}
_NAME_PARAMS = {
    "Shape", "Material", "MakeNamedMaterial", "LightSource",
    "AreaLightSource", "Film", "Sampler", "Integrator", "Camera",
    "PixelFilter", "Accelerator", "MakeNamedMedium",
}

_SAMPLER_UPGRADE = {
    "lowdiscrepancy": "paddedsobol", "02sequence": "paddedsobol",
    "maxmindist": "pmj02bn", "random": "independent",
}


def _fmt_num(x: float) -> str:
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.8g}"


class SceneFormatter:
    def __init__(self, out=None, to_ply=False, upgrade=False,
                 ply_prefix="mesh", base_dir="."):
        self.out = out if out is not None else sys.stdout
        self.to_ply = to_ply
        self.upgrade = upgrade
        self.ply_prefix = ply_prefix
        self.base_dir = base_dir
        self.depth = 0
        self.ply_count = 1
        self.warnings = []

    # -- emission helpers ---------------------------------------------------

    def _ind(self, extra=0):
        return "    " * (self.depth + extra)

    def _emit(self, s):
        self.out.write(s + "\n")

    def _emit_params(self, params, renames=(), removes=(), extra_lines=()):
        """params: dict name -> (type, values) from _parse_params."""
        for line in extra_lines:
            self._emit(self._ind(1) + line)
        for name, (ptype, vals) in params.items():
            if name in removes:
                continue
            out_name = dict(renames).get(name, name)
            if ptype in ("string", "texture", "bool"):
                body = " ".join(
                    f'"{v}"' if not isinstance(v, bool)
                    else ("\"true\"" if v else "\"false\"")
                    for v in vals
                )
                self._emit(
                    self._ind(1) + f'"{ptype} {out_name}" [ {body} ]'
                )
            else:
                flat = np.asarray(vals, np.float64).reshape(-1)
                if ptype == "integer":
                    body = " ".join(str(int(v)) for v in flat)
                else:
                    body = " ".join(_fmt_num(float(v)) for v in flat)
                self._emit(
                    self._ind(1) + f'"{ptype} {out_name}" [ {body} ]'
                )

    # -- upgrades -----------------------------------------------------------

    def _upgrade_material(self, name, params):
        """Returns (new_name, renames, removes, extra_lines)."""
        renames = [("bumpmap", "displacement")]
        removes = []
        extra = []

        def const_rgb(pname):
            if pname not in params:
                return None
            t, vals = params[pname]
            v = np.asarray(vals, np.float64).reshape(-1)
            if v.size in (1, 3):
                v3 = np.broadcast_to(v, (3,)) if v.size == 1 else v
                if v3[0] == v3[1] == v3[2]:
                    return float(v3[0])
            return None

        def drop_if_const(pname, value):
            c = const_rgb(pname)
            matches = c is not None and c == value
            if pname in params and not matches:
                self.warnings.append(
                    f"parameter removed converting material: {pname}"
                )
            removes.append(pname)
            return matches

        if "index" in params and name in ("glass", "uber"):
            t, vals = params["index"]
            if t == "texture":
                renames.append(("index", "eta"))
            else:
                removes.append("index")
                extra.append(
                    f'"float eta" [ {_fmt_num(float(vals[0]))} ]'
                )
        if name == "uber" or name == "plastic":
            new = "coateddiffuse"
            if drop_if_const("Ks", 0.0):
                new = "diffuse"
                removes += ["eta", "roughness"]
            drop_if_const("Kr", 0.0)
            drop_if_const("Kt", 0.0)
            removes.append("opacity")
            renames.append(("Kd", "reflectance"))
            return new, renames, removes, extra
        if name == "substrate":
            drop_if_const("Ks", 1.0)
            renames.append(("Kd", "reflectance"))
            return "coateddiffuse", renames, removes, extra
        if name == "matte":
            renames.append(("Kd", "reflectance"))
            removes.append("sigma")
            return "diffuse", renames, removes, extra
        if name == "metal":
            drop_if_const("Kr", 1.0)
            return "conductor", renames, removes, extra
        if name == "glass":
            drop_if_const("Kr", 1.0)
            drop_if_const("Kt", 1.0)
            return "dielectric", renames, removes, extra
        if name == "mirror":
            drop_if_const("Kr", 0.0)
            extra += [
                '"float roughness" [ 0 ]',
                '"spectrum eta" [ "metal-Ag-eta" ]',
                '"spectrum k" [ "metal-Ag-k" ]',
            ]
            return "conductor", renames, removes, extra
        if name == "translucent":
            renames.append(("Kd", "transmittance"))
            for p_, v_ in (("reflect", 0.0), ("transmit", 1.0),
                           ("Ks", 0.0)):
                drop_if_const(p_, v_)
            removes.append("roughness")
            return "diffusetransmission", renames, removes, extra
        if name == "kdsubsurface":
            renames.append(("Kd", "reflectance"))
            return "subsurface", renames, removes, extra
        if name == "disney":
            renames.append(("color", "reflectance"))
            return "diffuse", renames, removes, extra
        if name == "hair":
            renames.append(("color", "reflectance"))
            return "hair", renames, removes, extra
        if name == "mix":
            c = const_rgb("amount")
            if c is None and "amount" in params \
                    and params["amount"][0] not in ("float", "texture"):
                v = np.asarray(
                    params["amount"][1], np.float64).reshape(-1)
                c = float(v.mean())
                self.warnings.append(
                    f"RGB mix amount averaged to {c}")
            if c is not None:
                removes.append("amount")
                extra.append(f'"float amount" [ {_fmt_num(c)} ]')
            m1 = params.get("namedmaterial1", (None, [""]))[1][0]
            m2 = params.get("namedmaterial2", (None, [""]))[1][0]
            removes += ["namedmaterial1", "namedmaterial2"]
            # Note: swapped order vs pbrt-v3 (parser.cpp:1544).
            extra.append(f'"string materials" [ "{m2}" "{m1}" ]')
            return "mix", renames, removes, extra
        if name in ("", "none"):
            return "interface", renames, removes, extra
        if name == "fourier":
            self.warnings.append(
                '"fourier" material is no longer supported '
                '(see "measured")')
        return name, renames, removes, extra

    # -- directive handlers -------------------------------------------------

    def _shape(self, name, params):
        if self.to_ply and name == "trianglemesh":
            idx = params.get("indices", (None, []))[1]
            if len(np.asarray(idx).reshape(-1)) >= 500:
                from ..io.ply import write_ply

                fn = f"{self.ply_prefix}_{self.ply_count:05d}.ply"
                self.ply_count += 1
                pts = np.asarray(
                    params["P"][1], np.float32).reshape(-1, 3)
                faces = np.asarray(idx, np.int64).reshape(-1, 3)
                write_ply(os.path.join(self.base_dir, fn), pts, faces)
                keep = {
                    k: v for k, v in params.items()
                    if k not in ("indices", "P", "uv", "N", "S",
                                 "faceIndices")
                }
                self._emit(
                    self._ind()
                    + f'Shape "plymesh" "string filename" "{fn}"'
                )
                self._emit_params(keep)
                return
        renames, removes, extra = (), (), ()
        if self.upgrade and name == "loopsubdiv":
            renames = (("nlevels", "levels"),)
        self._emit(self._ind() + f'Shape "{name}"')
        self._emit_params(params, renames, removes, extra)

    def _directive(self, d, ts):
        if d in _BARE:
            if d in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
                self.depth = max(0, self.depth - 1)
            self._emit(self._ind() + d)
            if d in ("AttributeBegin", "TransformBegin"):
                self.depth += 1
            return
        if d in _FIXED:
            vals = [float(ts.next()) for _ in range(_FIXED[d])]
            self._emit(
                self._ind() + d + " "
                + " ".join(_fmt_num(v) for v in vals)
            )
            return
        if d in _MATRIX:
            assert ts.next() == "["
            vals = [float(ts.next()) for _ in range(16)]
            assert ts.next() == "]"
            self._emit(
                self._ind() + d + " [ "
                + " ".join(_fmt_num(v) for v in vals) + " ]"
            )
            return
        if d == "ActiveTransform":
            self._emit(self._ind() + f"ActiveTransform {ts.next()}")
            return
        if d == "MediumInterface":
            a = ts.next()[1:-1]
            b = ts.next()[1:-1] if ts.peek() and ts.peek().startswith('"') \
                else ""
            self._emit(self._ind() + f'MediumInterface "{a}" "{b}"')
            return
        if d == "Option":
            name = ts.next()[1:-1]
            val = ts.next()
            self._emit(self._ind() + f'Option "{name}" {val}')
            return
        if d == "Texture":
            name = ts.next()[1:-1]
            dtype = ts.next()[1:-1]
            tclass = ts.next()[1:-1]
            params = _parse_params(ts)
            renames, removes, extra = [], [], []
            if self.upgrade:
                if tclass == "imagemap" and "filename" not in params \
                        and "mapname" in params:
                    renames.append(("mapname", "filename"))
                if tclass == "scale" and "tex2" in params:
                    renames.append(("tex2", "scale"))
                    renames.append(("tex1", "tex"))
            self._emit(
                self._ind() + f'Texture "{name}" "{dtype}" "{tclass}"'
            )
            self._emit_params(params, renames, removes, extra)
            return
        if d in _NAME_ONLY:
            name = ts.next()[1:-1]
            self._emit(self._ind() + f'{d} "{name}"')
            if d == "ObjectBegin":
                self.depth += 1
            return
        if d in _NAME_PARAMS:
            name = ts.next()[1:-1]
            params = _parse_params(ts)
            renames, removes, extra = (), [], []
            if self.upgrade:
                if d == "Sampler":
                    name = _SAMPLER_UPGRADE.get(name, name)
                elif d == "Film":
                    if name == "image":
                        name = "rgb"
                    if "maxsampleluminance" in params:
                        v = float(np.asarray(
                            params["maxsampleluminance"][1]).reshape(-1)[0])
                        removes.append("maxsampleluminance")
                        extra.append(
                            f'"float maxcomponentvalue" [ {_fmt_num(v)} ]')
                    if "scale" in params:
                        v = float(np.asarray(
                            params["scale"][1]).reshape(-1)[0])
                        removes.append("scale")
                        extra.append(
                            f'"float iso" [ {_fmt_num(100 * v)} ]')
                elif d == "PixelFilter":
                    for old, new in (("xwidth", "xradius"),
                                     ("ywidth", "yradius")):
                        if old in params:
                            renames = tuple(renames) + ((old, new),)
                    if name == "gaussian" and "alpha" in params:
                        a = float(np.asarray(
                            params["alpha"][1]).reshape(-1)[0])
                        removes.append("alpha")
                        extra.append(
                            '"float sigma" [ '
                            f'{_fmt_num(1.0 / math.sqrt(2 * a))} ]')
                elif d == "Integrator":
                    removes.append("rrthreshold")
                    if name == "sppm":
                        removes += ["imagewritefrequency", "numiterations"]
                    lss = params.get("lightsamplestrategy")
                    if lss and lss[1][0] == "spatial":
                        removes.append("lightsamplestrategy")
                        extra.append(
                            '"string lightsamplestrategy" [ "bvh" ]')
                    if name == "directlighting":
                        name = "path"
                        extra.append('"integer maxdepth" [ 1 ]')
                elif d == "Camera":
                    if name == "environment":
                        name = "spherical"
                        extra.append(
                            '"string mapping" [ "equirectangular" ]')
                    if name in ("realistic", "omni"):
                        removes.append("simpleweighting")
                elif d == "MakeNamedMedium":
                    t = params.get("type")
                    if t and t[1][0] == "heterogeneous":
                        params["type"] = (t[0], ["uniformgrid"])
                elif d == "Material":
                    name, rn, rm, ex = self._upgrade_material(name, params)
                    renames, removes, extra = rn, removes + rm, extra + ex
                elif d == "MakeNamedMaterial":
                    t = params.get("type")
                    if t:
                        mname, rn, rm, ex = self._upgrade_material(
                            t[1][0], params)
                        params["type"] = (t[0], [mname])
                        renames, removes, extra = (
                            rn, removes + rm, extra + ex)
            if d == "Shape":
                self._shape(name, params)
                return
            self._emit(self._ind() + f'{d} "{name}"')
            self._emit_params(params, renames, removes, extra)
            return
        self.warnings.append(f"unknown directive {d}; dropped")

    def format_string(self, text):
        ts = _TokenStream(tokenize(text))
        while True:
            tok = ts.next()
            if tok is None:
                break
            self._directive(tok, ts)
        return self.warnings


def format_file(path, out=None, to_ply=False, upgrade=False):
    with open(path) as f:
        text = f.read()
    fmt = SceneFormatter(
        out=out, to_ply=to_ply, upgrade=upgrade,
        base_dir=os.path.dirname(os.path.abspath(path)),
    )
    warnings = fmt.format_string(text)
    for w in warnings:
        print(f"# warning: {w}", file=sys.stderr)
    return warnings


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Reformat / upgrade pbrt scene files "
        "(pbrt --format/--toply/--upgrade)"
    )
    ap.add_argument("files", nargs="+")
    ap.add_argument("--toply", action="store_true")
    ap.add_argument("--upgrade", action="store_true")
    args = ap.parse_args(argv)
    for fn in args.files:
        format_file(fn, to_ply=args.toply, upgrade=args.upgrade)


if __name__ == "__main__":
    main()
