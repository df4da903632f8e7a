"""The generated API reference must stay in sync with the code.

`docs/api-reference.md` is produced by `docs/gen_api.py` (introspection over
the public surface, incl. recipe-name annotations). Regenerate and compare:
a signature or docstring change without `python docs/gen_api.py` fails here.
"""

import importlib.util
import os

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")


def _load_gen():
    spec = importlib.util.spec_from_file_location("gen_api", os.path.join(DOCS, "gen_api.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_api_reference_is_current():
    gen = _load_gen()
    fresh = gen.generate()
    with open(os.path.join(DOCS, "api-reference.md")) as f:
        committed = f.read()
    assert fresh == committed, (
        "docs/api-reference.md is stale — run `python docs/gen_api.py` and commit the result"
    )


def test_api_reference_covers_accessors():
    """Every public accessor method appears, with its recipe annotation."""
    with open(os.path.join(DOCS, "api-reference.md")) as f:
        text = f.read()
    # one spot check per accessor family + the recipe dispatch notation
    for needle in [
        "`normalize`", "`project`", "`get_piv`", "`get_stiv`",  # frames
        "recipe: `frames: {get_piv: ...}`",
        "`get_transect`", "recipe: `velocimetry: {get_transect: ...}`",
        "`window_replace`", "recipe: `mask: {<group>: {window_replace: ...}}`",
        "`get_river_flow`", "recipe: `transect: {<name>: {get_river_flow: ...}}`",
        "`detect_water_level_s2n`",  # cross-section
        "`to_ugrid`",  # writers
    ]:
        assert needle in text, f"API reference is missing {needle}"
