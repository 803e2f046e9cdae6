"""The port's training data on the CPU against the JAX package: every
training dataset class with augmentation, ``fetch_training_dataset``'s
stage mixes, and the loaders' batches.

Synthetic trees are written with the port's codecs (PPM/PNG, .flo, .pfm,
the KITTI flow PNG) at small frames.  Augmented items are drawn with both
global streams (``np.random``, ``random``) seeded alike before each item:
uint8-valued images must be equal, flows within 1e-4 px, valid masks
equal.  The loaders must give equal batches (every array bit for bit) in
the same order, epoch after epoch.
"""

import os
import random

import numpy as np
import pytest

from craft_tpu.data import datasets as jds
from craft_tpu.data import loader as jld
from craft_tpu_torch.data import datasets as tds
from craft_tpu_torch.data import frame_utils as tfu
from craft_tpu_torch.data import imgio
from craft_tpu_torch.data import loader as tld

H, W = 80, 104          # frames: every stage's crop below fits with room
CROP = (64, 64)
FLOW_TOL = 1e-4  # px


def _img(rng):
    return rng.randint(0, 256, (H, W, 3)).astype(np.uint8)


def _flow(rng):
    return rng.uniform(-4, 4, (H, W, 2)).astype(np.float32)


def _kitti_flow(rng):
    flow = _flow(rng)
    return np.where(rng.uniform(size=(H, W, 1)) < 0.3, 0, flow)


def _write_pfm(path, flow):
    """A 3-channel PFM (the third channel zero), bottom-up, little end."""
    data = np.concatenate([flow, np.zeros_like(flow[..., :1])], -1)
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (flow.shape[1], flow.shape[0]))
        np.flipud(data).astype("<f4").tofile(f)


def write_trees(root, rng):
    """Chairs, FlyingThings3D (clean + final, .pfm flows), Sintel, KITTI,
    HD1K and Autoflow trees under root."""
    chairs = os.path.join(root, "FlyingChairs_release", "data")
    os.makedirs(chairs)
    for i in range(5):
        for k in (1, 2):
            imgio.write_ppm(f"{chairs}/{i + 1:05d}_img{k}.ppm", _img(rng))
        tfu.write_flo(f"{chairs}/{i + 1:05d}_flow.flo", _flow(rng))
    np.savetxt(os.path.join(root, "FlyingChairs_release",
                            "FlyingChairs_train_val.txt"),
               np.array([1, 1, 2, 1, 2]), fmt="%d")
    things = os.path.join(root, "FlyingThings3D")
    for scene in ("A/0000", "A/0001"):
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            d = os.path.join(things, dstype, "TRAIN", scene, "left")
            os.makedirs(d)
            for i in range(3):
                imgio.write_png(f"{d}/{i + 6:04d}.png", _img(rng))
        for direction in ("into_future", "into_past"):
            d = os.path.join(things, "optical_flow", "TRAIN", scene,
                             direction, "left")
            os.makedirs(d)
            for i in range(3):
                _write_pfm(f"{d}/OpticalFlowInto_{i + 6:04d}_L.pfm",
                           _flow(rng))
    for dstype in ("clean", "final"):
        for scene in ("alley_1", "bamboo_2"):
            d = os.path.join(root, "Sintel", "training", dstype, scene)
            os.makedirs(d)
            for i in range(3):
                imgio.write_png(f"{d}/frame_{i + 1:04d}.png", _img(rng))
    for scene in ("alley_1", "bamboo_2"):
        d = os.path.join(root, "Sintel", "training", "flow", scene)
        os.makedirs(d)
        for i in range(2):
            tfu.write_flo(f"{d}/frame_{i + 1:04d}.flo", _flow(rng))
    kitti = os.path.join(root, "KITTI", "training")
    for sub in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kitti, sub))
    for i in range(7):
        for suf in ("10", "11"):
            imgio.write_png(f"{kitti}/image_2/{i:06d}_{suf}.png", _img(rng))
        tfu.write_flow_kitti(f"{kitti}/flow_occ/{i:06d}_10.png",
                             _kitti_flow(rng))
    hd1k = os.path.join(root, "HD1k")
    for sub in ("hd1k_input/image_2", "hd1k_flow_gt/flow_occ"):
        os.makedirs(os.path.join(hd1k, sub))
    for seq in range(2):
        for i in range(3):
            imgio.write_png(f"{hd1k}/hd1k_input/image_2/{seq:06d}_{i:04d}"
                            ".png", _img(rng))
            tfu.write_flow_kitti(f"{hd1k}/hd1k_flow_gt/flow_occ/{seq:06d}_"
                                 f"{i:04d}.png", _kitti_flow(rng))
    for i in range(11):
        d = os.path.join(root, "autoflow", f"scene{i:03d}")
        os.makedirs(d)
        for name in ("im0", "im1"):
            imgio.write_png(f"{d}/{name}.png", _img(rng))
        tfu.write_flo(f"{d}/forward.flo", _flow(rng))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    write_trees(root, np.random.RandomState(0))
    return root


def _item(dataset, index, seed):
    np.random.seed(seed)
    random.seed(seed)
    return dataset[index]


def _same_item(got, want, where):
    assert sorted(got) == sorted(want), where
    for key, w in want.items():
        g = got[key]
        if key == "extra_info":
            assert g == w, where
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (where, key)
        if key == "flow":
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_TOL,
                                       err_msg=f"{where} {key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {key}")


def _same_dataset(tset, jset, n_items=None):
    """Lengths, each item's files, and the augmented items (seed = index)."""
    assert len(tset) == len(jset) > 0
    n = len(jset) if n_items is None else min(n_items, len(jset))
    for i in range(n):
        _same_item(_item(tset, i, i), _item(jset, i, i), i)


AUG = dict(crop_size=CROP, min_scale=-0.2, max_scale=0.5, do_flip=True,
           shift_prob=0.5)


@pytest.mark.parametrize("name", ["chairs", "things_clean", "things_final",
                                  "sintel_clean", "kitti", "kittitrain",
                                  "kittitrain_test", "hd1k", "autoflow"])
def test_training_dataset_matches_jax(trees, name):
    """Every training dataset class, augmented: file lists and items."""
    def make(m):
        r = trees
        return {
            "chairs": lambda: m.FlyingChairs(
                AUG, root=f"{r}/FlyingChairs_release/data",
                split_file=f"{r}/FlyingChairs_release/"
                           "FlyingChairs_train_val.txt"),
            "things_clean": lambda: m.FlyingThings3D(
                AUG, root=f"{r}/FlyingThings3D"),
            "things_final": lambda: m.FlyingThings3D(
                AUG, root=f"{r}/FlyingThings3D", dstype="frames_finalpass"),
            "sintel_clean": lambda: m.MpiSintel(AUG, root=f"{r}/Sintel"),
            "kitti": lambda: m.KITTI(AUG, root=f"{r}/KITTI"),
            "kittitrain": lambda: m.KITTITrain(AUG, root=f"{r}/KITTI"),
            "kittitrain_test": lambda: m.KITTITrain(None, split="test",
                                                    root=f"{r}/KITTI"),
            "hd1k": lambda: m.HD1K(AUG, root=f"{r}/HD1k"),
            "autoflow": lambda: m.Autoflow(AUG, root=f"{r}/autoflow"),
        }[name]()

    tset, jset = make(tds), make(jds)
    assert tset.image_list == jset.image_list
    assert tset.flow_list == jset.flow_list
    assert tset.extra_info == jset.extra_info
    assert tset.ds_name == jset.ds_name
    _same_dataset(tset, jset)


def _files(dataset, i):
    """The image pair behind item i of a dataset or concatenation."""
    if hasattr(dataset, "datasets"):
        di = int(np.searchsorted(dataset._offsets, i, side="right")) - 1
        return _files(dataset.datasets[di], i - int(dataset._offsets[di]))
    return dataset.image_list[i]


@pytest.mark.parametrize("stage", ["chairs", "things", "sintel", "kitti",
                                   "kittitrain", "autoflow"])
def test_stage_mix_matches_jax(trees, stage):
    """fetch_training_dataset: the mix's length (the 100x / 200x / 5x
    multipliers), every item's files in order, and augmented items at
    every part of the mix."""
    kw = dict(shift_prob=0.3, shift_sigmas=(12, 6), data_root=trees)
    tset = tds.fetch_training_dataset(stage, CROP, **kw)
    jset = jds.fetch_training_dataset(stage, CROP, **kw)
    assert len(tset) == len(jset)
    assert [_files(tset, i) for i in range(len(tset))] == \
        [_files(jset, i) for i in range(len(jset))]
    step = max(1, len(jset) // 12)
    for i in range(0, len(jset), step):
        _same_item(_item(tset, i, i), _item(jset, i, i), i)


def test_sintel_stage_mix_lengths(trees):
    tset = tds.fetch_training_dataset("sintel", CROP, data_root=trees)
    # 100 x (4 clean + 4 final) + 200 x 7 KITTI + 5 x 4 HD1K + 8 things.
    assert len(tset) == 100 * 8 + 200 * 7 + 5 * 4 + 8
    assert len(tds.fetch_training_dataset(
        "sintel", CROP, data_root=trees, sintel_train_ds="C+T+S")) == 808


def test_viper_stage_matches_jax(tmp_path):
    """The viper stage (its JPEG frames through the port's decoder, PIL's
    on the JAX side; sparse KITTI-PNG flows; scaled to 2^-1..2^-0.5 before
    the crop): every item's files and augmented items."""
    import io

    from PIL import Image

    from chip_smoke import write_viper_tree

    rng = np.random.RandomState(3)
    hw = (192, 256)

    def jpeg():
        buf = io.BytesIO()
        img = rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        return buf.getvalue()
    flows = [np.where(rng.uniform(size=(*hw, 1)) < 0.3, 0,
                      rng.uniform(-8, 8, (*hw, 2))).astype(np.float32)
             for _ in range(2)]
    write_viper_tree(tmp_path, [(jpeg(), jpeg()) for _ in range(2)], flows,
                     split="train")
    kw = dict(shift_prob=0.3, data_root=str(tmp_path))
    tset = tds.fetch_training_dataset("viper", CROP, **kw)
    jset = jds.fetch_training_dataset("viper", CROP, **kw)
    assert tset.image_list == jset.image_list and len(tset) == 2
    _same_dataset(tset, jset)


# ------------------------------------------------------------ loaders

def _chairs(trees, m):
    return m.fetch_training_dataset("chairs", CROP, data_root=trees)


def _drain(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, wv in w.items():
            if key == "extra_info":
                assert g[key] == wv
            else:
                got = g[key].numpy()
                assert got.dtype == wv.dtype
                np.testing.assert_array_equal(got, wv, err_msg=key)


@pytest.mark.parametrize("backend,workers,rank,world", [
    ("process", 1, 0, 1), ("process", 2, 0, 1), ("thread", 1, 0, 1),
    ("process", 2, 0, 2), ("process", 2, 1, 2)])
def test_loader_batches_match_jax(trees, backend, workers, rank, world):
    """Epochs 0 and 1 of the chairs stage (augmented: the workers' seeds
    decide every item), batch 1, shard `rank` of `world`."""
    cls = {"process": (tld.MultiprocessLoader, jld.MultiprocessLoader),
           "thread": (tld.ShardedLoader, jld.ShardedLoader)}[backend]
    kw = dict(batch_size=1, num_workers=workers, process_index=rank,
              process_count=world, seed=11)
    got = _drain(cls[0](_chairs(trees, tds), **kw))
    want = _drain(cls[1](_chairs(trees, jds), **kw))
    assert len(got) == 2 * len(range(rank, 3, world))  # 3 pairs, 2 epochs
    _same_batches(got, want)


def test_loader_lengths_and_infinite_epochs(trees):
    loader = tld.MultiprocessLoader(_chairs(trees, tds), 2, num_workers=2,
                                    seed=3)
    assert len(loader) == 1  # 3 training pairs, drop_last
    it = iter(tld.InfiniteLoader(loader))
    for epoch in range(3):
        next(it)
        assert loader.epoch == epoch
