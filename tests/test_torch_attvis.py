"""``eval/attvis.py`` of the port against the JAX package's on the CPU:
``dump_attention``'s keys, shapes and arrays against the JAX dump (the
flax 'intermediates' collection) under --f1 private and shared at 64x64
in fp32 (atol 1e-5), the capture's routing (the plain sites, raw volume),
``resize_bilinear_pil`` bit for bit against PIL's ``Image.resize(...,
BILINEAR)``, and ``vis_attention``'s PNGs against the JAX ones (one level
of a pixel).  Weights: ``test_torch_two_way.two_way_tree``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from craft_tpu.eval import attvis as jattvis
from craft_tpu_torch.data import imgio
from craft_tpu_torch.eval import attvis
from craft_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_two_way import (_one_thread, configs, frames,  # noqa: F401
                                two_way_tree)

ITERS = 2


@pytest.mark.parametrize("hw,size", [((8, 8), (64, 64)), ((5, 7), (61, 37)),
                                     ((40, 30), (13, 11)), ((1, 6), (6, 9)),
                                     ((9, 12), (96, 72))])
def test_resize_bilinear_pil_is_pil_bit_for_bit(rng, hw, size):
    img = rng.randint(0, 256, hw).astype(np.uint8)
    want = np.array(Image.fromarray(img).resize(size, Image.BILINEAR))
    np.testing.assert_array_equal(attvis.resize_bilinear_pil(img, size),
                                  want)


@pytest.fixture(scope="module", params=["private", "shared"])
def dumps(request, tmp_path_factory):
    f1 = request.param
    tmp = tmp_path_factory.mktemp(f"attvis_{f1}")
    img1, img2 = frames(seed=3)
    jcfg, tcfg = configs(f1, False)
    tree = two_way_tree(f1)
    want = jattvis.dump_attention(jcfg, jax.tree.map(jnp.asarray, tree),
                                  img1, img2, str(tmp / "jax.npz"),
                                  iters=ITERS)
    got = attvis.dump_attention(tcfg, state_dict_from_flax(tree), img1,
                                img2, str(tmp / "port.npz"), iters=ITERS,
                                device="cpu")
    return f1, tmp, img2, want, got


def test_dump_attention_matches_the_jax_dump(dumps):
    f1, tmp, _, want, got = dumps
    sites = ["f2_trans", "att"] + (["f1_trans"] if f1 == "private" else [])
    assert sorted(got) == sorted(want) == sorted(
        [f"{s}/setrans/attn_probs" for s in sites] + ["corr_fn/corr_volume"])
    saved = dict(np.load(tmp / "port.npz"))
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[key].shape == w.shape, key
        np.testing.assert_array_equal(saved[key], got[key])
        np.testing.assert_allclose(got[key], w, atol=1e-5, err_msg=key)
    U = 64
    assert got["corr_fn/corr_volume"].shape == (1, 2, U, U)
    assert got["att/setrans/attn_probs"].shape == (1, 4, U, U)


def test_capture_takes_the_plain_sites(dumps, monkeypatch):
    """While capturing, no kernel wrapper of B2, B3 or B4 is called; the
    probs are float rows summing to 1."""
    from craft_tpu_torch.nn import setrans as ts
    f1, tmp, _, _, got = dumps
    for name in ("flash_mode_attention", "fused_agg_corr_norm",
                 "mode_softmax_probs"):
        monkeypatch.setattr(ts, name, None)
    probs = got["att/setrans/attn_probs"]
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    _, tcfg = configs(f1, False)
    again = attvis.dump_attention(tcfg, state_dict_from_flax(
        two_way_tree(f1)), *frames(seed=3), str(tmp / "again.npz"), iters=1,
        device="cpu")
    assert sorted(again) == sorted(got)


def test_vis_attention_pngs_match_the_jax_ones(dumps, tmp_path):
    _, _, img2, want, _ = dumps
    attn = np.asarray(want["att/setrans/attn_probs"][0], np.float32)
    points = [(0, 0), (3, 5), (7, 7), (9, 1)]  # the last outside the grid
    image = img2[0].astype(np.uint8)
    jattvis.vis_attention(attn, image, points, str(tmp_path / "jax"),
                          (8, 8))
    n = attvis.vis_attention(attn, image, points, str(tmp_path / "port"),
                             (8, 8))
    assert n == 3
    for qy, qx in points[:3]:
        name = f"att_{qy}_{qx}.png"
        w = np.array(Image.open(tmp_path / "jax" / name))
        g = imgio.load(str(tmp_path / "port" / name))
        assert g.shape == w.shape == (64, 64, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
