"""Generate docs/api-reference.md by introspecting the public surface.

Run:  python docs/gen_api.py          (rewrites docs/api-reference.md)

The reference ships a sphinx-autodoc API tree (reference ``docs/api.rst``);
this generator produces the equivalent flat markdown page: every public
class, accessor method and module-level function with its signature, the
first line of its docstring, and — for methods reachable from a YAML recipe —
the recipe section and key that dispatch to it (the recipe engine validates
keys against these very signatures, see ``cli/cli_utils.py::validate_recipe``).
``tests/test_docs.py`` regenerates this page and fails if the committed copy
is stale, so the listing stays current by construction.
"""

import importlib
import inspect
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api-reference.md")

# (title, module, class or None, recipe section or None, intro)
# recipe column: how a YAML recipe reaches the method — a format string with
# {name}, or None when the section maps to something else (e.g. `video:` keys
# are Video CONSTRUCTOR arguments, not method calls)
CLASS_SECTIONS = [
    ("Video", "pyorc_tpu.api.video", "Video", None,
     "Opens a video file with a camera configuration; frames come out as a lazy labeled "
     "array. The recipe `video:` section supplies the CONSTRUCTOR arguments "
     "(start_frame, end_frame, h_a, ...), not method calls."),
    ("CameraConfig", "pyorc_tpu.api.cameraconfig", "CameraConfig", None,
     "The geometric core: intrinsics, pose, GCPs, CRS, water levels, AOI and the ortho grid."),
    ("CrossSection", "pyorc_tpu.api.cross_section", "CrossSection", None,
     "3-D cross-section geometry, wetted surfaces and optical water-level detection "
     "(driven by the recipe `water_level:` section via the service layer)."),
    ("Frames accessor (`da.frames`)", "pyorc_tpu.api.frames", "Frames",
     "frames: {{{name}: ...}}",
     "Preprocessing filters, orthorectification, PIV and STIV on a frames DataArray."),
    ("Velocimetry accessor (`ds.velocimetry`)", "pyorc_tpu.api.velocimetry", "Velocimetry",
     "velocimetry: {{{name}: ...}}",
     "Validity checks, transect sampling, masking entry point and writers on a PIV Dataset."),
    ("Mask methods (`ds.velocimetry.mask.*`)", "pyorc_tpu.api.mask", "_Velocimetry_MaskMethods",
     "mask: {{<group>: {{{name}: ...}}}}",
     "Eleven composable vector-field filters; recipe `mask:` groups list them by name."),
    ("Transect accessor (`ds.transect`)", "pyorc_tpu.api.transect", "Transect",
     "transect: {{<name>: {{{name}: ...}}}}",
     "Effective velocities, depth-integrated q, river discharge on sampled cross-sections."),
    ("Plot accessors (`.velocimetry.plot` / `.transect.plot` / `.frames.plot`)",
     "pyorc_tpu.api.plot", None, None,
     "Quiver/scatter/pcolormesh/streamplot in local, geographical or camera perspective "
     "(recipe `plot:` sections compose these per figure)."),
]

MODULE_SECTIONS = [
    ("Top-level package", "pyorc_tpu",
     "`Video`, `CameraConfig`, `CrossSection`, `load_camera_config`, `open_dataset`, labeled arrays."),
    ("Service layer", "pyorc_tpu.service.velocimetry",
     "Recipe-driven end-to-end pipeline (`velocity_flow`), stage cache, subprocess embedding."),
    ("Camera-config service", "pyorc_tpu.service.camera_config",
     "Builds a CameraConfig from a video + GCPs and writes overview figures."),
    ("IO writers", "pyorc_tpu.io",
     "GeoTIFF, UGRID (QGIS mesh), netCDF with CF int16/scale encoding, native H.264 decode/encode."),
    ("Geometry helpers", "pyorc_tpu.helpers",
     "Affine/CRS transforms, equidistant resampling, log-profile fits, discharge integration."),
    ("PIV ops", "pyorc_tpu.ops.piv",
     "XLA PIV pipeline: windowed cross-correlation, subpixel peaks, streaming ensemble."),
    ("PIV reference", "pyorc_tpu.ops.piv_reference",
     "Plain float64 NumPy PIV that the tests and chip_smoke.py check the XLA path against."),
    ("STIV ops", "pyorc_tpu.ops.stiv",
     "Space-time image velocimetry: batched line sampling + structure-tensor streak angles."),
    ("Multi-device parallel", "pyorc_tpu.parallel.piv",
     "shard_map PIV over device meshes: pair-axis DP, 2-D (pairs, rows) sharding, psum ensemble."),
    ("Multi-host", "pyorc_tpu.parallel.distributed",
     "jax.distributed segment coordination for one video split across hosts over DCN."),
    ("Sample data", "pyorc_tpu.sample_data",
     "Zenodo dataset fetchers for the Hommerich example."),
]


def _sig(obj):
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    return s if len(s) <= 100 else s[:97] + "...)"


def _doc1(obj):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    line = d.strip().splitlines()[0].rstrip()
    return line


def _public_methods(cls):
    for name, fn in sorted(vars(cls).items()):
        if name.startswith("_"):
            continue
        if isinstance(fn, property):
            yield name, fn.fget, True
        elif callable(fn):
            yield name, fn, False


def _class_block(lines, mod, clsname, recipe):
    cls = getattr(importlib.import_module(mod), clsname)
    for name, fn, is_prop in _public_methods(cls):
        kind = "property" if is_prop else "method"
        sig = "" if is_prop else f"`{_sig(fn)}`"
        rec = ""
        if recipe and not is_prop:
            rec = f" — recipe: `{recipe.format(name=name)}`"
        lines.append(f"- **`{name}`** ({kind}) {sig}{rec}")
        doc = _doc1(fn)
        if doc:
            lines.append(f"  {doc}")


def _module_block(lines, mod):
    m = importlib.import_module(mod)
    names = getattr(m, "__all__", None) or [
        n for n, o in sorted(vars(m).items())
        if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
        and getattr(o, "__module__", None) == mod
    ]
    for n in sorted(names):
        o = getattr(m, n, None)
        if o is None:
            continue
        if inspect.isclass(o):
            lines.append(f"- **`{n}`** (class) `{_sig(o)}`")
        elif callable(o):
            lines.append(f"- **`{n}`** `{_sig(o)}`")
        else:
            lines.append(f"- **`{n}`**")
        doc = _doc1(o)
        if doc:
            lines.append(f"  {doc}")


def generate() -> str:
    lines = [
        "# pyorc_tpu API reference",
        "",
        "Generated by `docs/gen_api.py` — do not edit by hand "
        "(`python docs/gen_api.py` refreshes it; `tests/test_docs.py` enforces freshness).",
        "",
        "Recipe annotations show how a method is reached from a YAML recipe: the",
        "section name maps to a pipeline stage and the key inside it to the method",
        "(validated against these signatures by `validate_recipe`).",
        "",
    ]
    for title, mod, clsname, recipe, intro in CLASS_SECTIONS:
        lines += [f"## {title}", "", intro, ""]
        if clsname is not None:
            _class_block(lines, mod, clsname, recipe)
        else:
            m = importlib.import_module(mod)
            for plot_cls in ["_Velocimetry_PlotMethods", "_Transect_PlotMethods", "_Frames_PlotMethods"]:
                cls = getattr(m, plot_cls, None)
                if cls is None:
                    continue
                owner = plot_cls.split("_")[1].lower()
                lines.append(f"### `.{owner}.plot`")
                _class_block(lines, mod, plot_cls, None)
        lines.append("")
    lines += ["# Modules", ""]
    for title, mod, intro in MODULE_SECTIONS:
        lines += [f"## {title} (`{mod}`)", "", intro, ""]
        _module_block(lines, mod)
        lines.append("")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    text = generate()
    with open(OUT, "w") as f:
        f.write(text)
    n_entries = text.count("\n- ")
    print(f"wrote {OUT}: {n_entries} entries, {len(text.splitlines())} lines")
    sys.exit(0)
