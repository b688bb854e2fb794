"""The port's native code (pbrt_tpu_torch/native/: the C++ tokenizer and
Morton radix sort, built with g++ into pbrt_tpu_torch/_build/) against
its plain twins and the reference's native code, with the cases of
tests/test_parser.py (test_native_tokenizer_matches_python,
test_native_morton_order_matches_numpy). Every comparison is exact:
tokens equal as strings, permutations equal index for index.

The callers take the native path: io/parser.tokenize and
accel/bvh.morton_order (and through it the K2, K3 and BVH builds). A
build that fails raises; nothing falls back to the twins.
"""

import glob
import os

import numpy as np
import pytest

from pbrt_tpu.accel.bvh import _morton3 as jax_morton3
from pbrt_tpu.native import morton_order_native as ref_morton_native
from pbrt_tpu.native import tokenize_native as ref_tokenize_native
from pbrt_tpu_torch import native
from pbrt_tpu_torch.accel import bvh
from pbrt_tpu_torch.io import parser
from pbrt_tpu_torch.scenes.meshes import fbm_blob

from . import torch_port_cli, torch_port_instanced

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXT = """
# a comment with "quotes" and [brackets]
Integrator "path" "integer maxdepth" [ 7 ]
LookAt 0 1.5 -3   0 0.25e1 0  0 1 0
Texture "t" "spectrum" "checkerboard" "rgb tex1" [.5 0.25 1e-2]
Shape "trianglemesh" "integer indices" [0 1 2]
   "point3 P" [-1 -1 4  1 -1 4  0 1 4] # trailing
WorldBegin
"""


def _scene_texts():
    """The 13 scene files with C++ goldens, the port's committed scenes,
    the CLI tests' scenes and the instanced field's text."""
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "goldens", "*.pbrt")))
    assert len(paths) == 13
    paths += sorted(glob.glob(os.path.join(ROOT, "tests", "data", "torch_port",
                                           "**", "*.pbrt"), recursive=True))
    texts = {os.path.relpath(p, ROOT): open(p).read() for p in paths}
    for name in ("IMAGE_SCENE", "GBUFFER_SCENE", "DEBUG_SCENE"):
        texts[f"cli:{name}"] = getattr(torch_port_cli, name)
    texts["instanced_field"] = torch_port_instanced.field_text()
    return texts


def test_native_tokenizer_matches_python():
    """The reference's case: the C++ pass gives the Python pass's tokens
    (the Python pass is the specification), and the reference's native
    pass's."""
    got = native.tokenize_native(TEXT)
    assert got == parser.tokenize_py(TEXT) == ref_tokenize_native(TEXT)
    assert parser.tokenize(TEXT) == got


@pytest.mark.parametrize("name", sorted(_scene_texts()))
def test_native_tokenizer_on_scene_files(name):
    text = _scene_texts()[name]
    toks = parser.tokenize(text)
    assert len(toks) > 10
    assert toks == parser.tokenize_py(text)


def test_native_tokenizer_edges():
    """Empty text, a text of one comment, tokens that run into brackets
    and quotes, non-ASCII bytes, a token count past the first guess of
    capacity, and an unterminated string (ValueError, as str.index)."""
    for text in ("", "# only a comment", 'a[b]"c d"e#f\ng',
                 'Shape "trié" [1 2]', "[" * 5000 + " x"):
        assert native.tokenize_native(text) == parser.tokenize_py(text), text
    with pytest.raises(ValueError):
        parser.tokenize_py('Shape "open')
    with pytest.raises(ValueError, match="unterminated"):
        parser.tokenize('Shape "open')


def test_native_morton_order_matches_numpy():
    """The reference's case: the C++ radix sort gives numpy's stable
    argsort of the Morton codes (ties in input order), and the
    reference's native sort's permutation."""
    rng = np.random.default_rng(7)
    for n in (1, 3, 257, 40000):
        cent = (rng.standard_normal((n, 3)) * 5.0).astype(np.float32)
        lo, hi = cent.min(0), cent.max(0)
        norm = (cent - lo) / np.maximum(hi - lo, 1e-12)
        ref = np.argsort(jax_morton3(norm), kind="stable")
        got = bvh.morton_order(cent)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(bvh.morton_order_np(cent), ref)
        np.testing.assert_array_equal(ref_morton_native(cent), ref)
    # Identical centroids keep the input (stable) order.
    np.testing.assert_array_equal(
        bvh.morton_order(np.ones((17, 3), np.float32)), np.arange(17))
    assert bvh.morton_order(np.zeros((0, 3), np.float32)).shape == (0,)


def test_native_morton_order_on_meshes():
    """A large mesh's centroids (fbm_blob(5), 20,480 triangles) and a flat
    plane's (a zero extent on one axis)."""
    tris = fbm_blob(5)
    for cent in (tris.mean(axis=1),
                 np.stack(np.meshgrid(np.arange(64), np.arange(64), [0.0]),
                          -1).reshape(-1, 3).astype(np.float32)):
        np.testing.assert_array_equal(bvh.morton_order(cent),
                                      bvh.morton_order_np(cent))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build([bad], name="native-test-bad")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build([bad], name="native-test-bad")
