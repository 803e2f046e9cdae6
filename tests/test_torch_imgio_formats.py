"""The port's image decoder (``craft_tpu_torch/data/imgio.py`` and its
``jpeg_progressive``, ``jpeg_arith`` and ``jpeg_lossless``) on every JPEG
and PNG form the JAX package decodes, on the CPU.

The fixtures under tests/data/formats/ and what the JAX package's two
decoders give for each (tests/data/image_formats.json) come from
tools/make_image_fixtures.py.  Each file must decode to the array that
``craft_tpu.data.imgio.load`` gives here, live, with its native core
built: the core's, or PIL's where the core refuses the file (lossless
JPEG), in dtype, shape and bytes, and that array must be the one the
JSON records (chip_smoke.py, which has neither PIL nor the core, holds
the port to the record); it must equal PIL's array live wherever the two
agree; and what the JAX package refuses, the port refuses with a
ValueError naming the form.
Among them: progressive Huffman JPEG (with libjpeg's block smoothing of
inexact coefficients, and an EOB run past a restart marker),
arithmetic-coded JPEG, lossless JPEG, CMYK and YCCK, interlaced PNG down
to 1x1, 1, 2 and 4-bit PNG, and gray and RGB PNG with tRNS (an alpha
channel, as libpng's png_set_tRNS_to_alpha gives it).
"""

import functools
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from craft_tpu.data import imgio as jax_imgio
from craft_tpu_torch.data import frame_utils, imgio

DATA = Path(__file__).resolve().parent / "data"
META = json.loads((DATA / "image_formats.json").read_text())
DECODED = [n for n, m in META.items() if m["load"]]
AGREE = [n for n, m in META.items() if m["agree"]]
REFUSED = [n for n, m in META.items() if not m["load"]]
# What each refusal's message names.
REFUSAL_NAMES = {"jpeg_hierarchical.jpg": "hierarchical",
                 "jpeg_12bit.jpg": "12-bit",
                 "jpeg_lossless_arith.jpg": "arithmetic-coded lossless",
                 "jpeg_lossless_12bit.jpg": "12-bit",
                 "jpeg_lossless_jfif.jpg": "lossless JPEG of 3 components",
                 "jpeg_lossless_ycck.jpg": "lossless JPEG of 4 components",
                 "jpeg_lossless_two_components.jpg":
                     "lossless JPEG of 2 components"}


@functools.lru_cache(maxsize=None)
def _decoded(name: str) -> np.ndarray:
    return imgio.load(str(DATA / "formats" / name))


@pytest.fixture(scope="module")
def jax_load(tmp_path_factory):
    """name -> what ``craft_tpu.data.imgio.load`` returns, or raises, with
    its native core built by ``build()``.  The core is built from a copy
    of native/imgio, so that this build and tests/test_imgio.py's, which
    may run at the same time, do not write one file."""
    folder = tmp_path_factory.mktemp("native_imgio")
    for name in ("Makefile", "imgio.cpp"):
        shutil.copy(Path(jax_imgio._DIR) / name, folder / name)
    cache = {}

    def load(name):
        if name not in cache:
            try:
                cache[name] = jax_imgio.load(str(DATA / "formats" / name))
            except Exception as e:  # noqa: BLE001 - PIL raises several kinds
                cache[name] = e
        return cache[name]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_imgio, "_DIR", str(folder))
        mp.setattr(jax_imgio, "_mod", None)
        mp.setattr(jax_imgio, "_tried", False)
        if not jax_imgio.build() or not jax_imgio.available():
            pytest.skip("the JAX package's native image core does not build")
        yield load


def _record(arr: np.ndarray) -> dict:
    """What image_formats.json holds of an array."""
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()
                                     ).hexdigest()}


def test_the_fixtures_cover_every_form():
    forms = " ".join(m["form"] for m in META.values())
    for form in ("progressive", "smoothed", "EOB runs past restart",
                 "arithmetic-coded JPEG", "arithmetic-coded progressive",
                 "without DAC", "lossless JPEG predictor 7",
                 "point transform", "CMYK", "YCCK", "two components",
                 "Adam7", "1-bit gray", "2-bit palette", "4-bit gray",
                 "8-bit gray with tRNS", "16-bit RGB with tRNS",
                 "Adam7 RGB 1x1", "progressive JPEG 1920x1080",
                 "arithmetic-coded JPEG 1920x1080",
                 "arithmetic-coded progressive JPEG 1920x1080",
                 "lossless JPEG RGB 1920x1080", "YCCK JPEG 1920x1080",
                 "PNG Adam7 RGB 1920x1080"):
        assert form in forms, form
    assert set(REFUSED) == set(REFUSAL_NAMES)


@pytest.mark.parametrize("name", DECODED)
def test_decodes_to_the_jax_package_array(name, jax_load):
    m = META[name]
    want = jax_load(name)
    assert isinstance(want, np.ndarray), f"{m['form']}: the JAX package " \
        f"raised {want!r}"
    got = _decoded(name)
    assert (got.shape, got.dtype) == (want.shape, want.dtype), m["form"]
    assert np.ascontiguousarray(got).tobytes() == \
        np.ascontiguousarray(want).tobytes(), m["form"]
    assert _record(want) == m[m["load"]], \
        f"{m['form']}: image_formats.json disagrees with the JAX package"


@pytest.mark.parametrize("name", AGREE)
def test_equals_pil_where_the_jax_decoders_agree(name):
    want = np.array(Image.open(DATA / "formats" / name))
    np.testing.assert_array_equal(_decoded(name), want)


@pytest.mark.parametrize("name", REFUSED)
def test_refuses_what_the_jax_package_refuses(name, jax_load):
    assert isinstance(jax_load(name), Exception), name
    with pytest.raises(ValueError, match=REFUSAL_NAMES[name]):
        imgio.load(str(DATA / "formats" / name))


@pytest.mark.parametrize("name,key", [("png_gray8_trns.png", (None,)),
                                      ("png_gray16_trns.png", (4242,)),
                                      ("png_rgb8_trns.png", (10, 20, 30)),
                                      ("png_rgb16_trns.png",
                                       (1000, 2000, 3000))])
def test_trns_becomes_an_alpha_channel(name, key):
    """png_set_tRNS_to_alpha: the pixels equal to the chunk's value get
    alpha 0, all others full scale, the samples unchanged."""
    got = _decoded(name)
    ch = 1 if "gray" in name else 3
    full = 65535 if "16" in name else 255
    assert got.ndim == 3 and got.shape[2] == ch + 1
    if key == (None,):  # the gray value of pixel (3, 3)
        key = (int(got[3, 3, 0]),)
    hit = (got[..., :ch] == np.array(key)).all(-1)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got[..., ch], np.where(hit, 0, full))


def test_read_gen_takes_the_new_forms():
    """The datasets' and the demo's reader (frame_utils.read_gen)."""
    for name in ("jpeg_prog_420.jpg", "jpeg_arith_prog.jpg",
                 "png_adam7_rgb8.png"):
        np.testing.assert_array_equal(
            frame_utils.read_gen(str(DATA / "formats" / name)),
            _decoded(name))
