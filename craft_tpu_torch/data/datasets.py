"""The datasets (port of ``craft_tpu.data.datasets``; reference
core/datasets.py:25-567): MPI Sintel, FlyingChairs (its splits through
FlyingChairs_train_val.txt), FlyingThings3D, KITTI 2015 (and its 70/30
re-split, KITTITrain), HD1K and Autoflow, with or without augmentation,
and the training curriculum's mixes (``fetch_training_dataset``).

Items are numpy dicts, as in the JAX package: image1 and image2 [H, W, 3]
fp32 in [0, 255], flow [H, W, 2] fp32, valid [H, W] fp32, extra_info.  The
directory layouts, file lists, multipliers and augmentation parameters are
the reference's.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from craft_tpu_torch.cli import ROADMAP_EVAL, not_ported
from craft_tpu_torch.data import frame_utils
from craft_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor


class FlowDataset:
    """An image pair and its flow per item, augmented when aug_params are
    given; validity from the KITTI codec or the sparse augmentor (sparse),
    the shift augmentation's mask, or |flow| < 1000 (dense), reference
    datasets.py:25-152."""

    ds_name = "flow"

    def __init__(self, aug_params=None, sparse: bool = False):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(self.ds_name, **aug_params)
        self.is_test = False
        self.flow_list: List[str] = []
        self.image_list: List[List[str]] = []
        self.extra_info: Optional[list] = None

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        extra = self.extra_info[index] if self.extra_info is not None \
            else index
        img1 = np.asarray(frame_utils.read_gen(self.image_list[index][0]),
                          np.uint8)
        img2 = np.asarray(frame_utils.read_gen(self.image_list[index][1]),
                          np.uint8)
        if img1.ndim == 2:  # grayscale -> 3 channels
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:  # strip alpha
            img1, img2 = img1[..., :3], img2[..., :3]
        if self.is_test:
            return {"image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32), "extra_info": extra}
        valid = None
        if self.sparse:
            flow, valid = frame_utils.read_flow_kitti(self.flow_list[index])
        else:
            flow = frame_utils.read_gen(self.flow_list[index])
        flow = np.asarray(flow, np.float32)
        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid)
            else:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow)
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & \
                (np.abs(flow[..., 1]) < 1000)
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": valid.astype(np.float32),
                "extra_info": extra}

    def __rmul__(self, v: int) -> "FlowDataset":
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        if self.extra_info is not None:
            self.extra_info = v * self.extra_info
        return self

    def __add__(self, other) -> "ConcatDataset":
        return ConcatDataset([self, other])

    def __len__(self):
        return len(self.image_list)


class ConcatDataset:
    """Datasets end to end (nested concatenations flattened)."""

    def __init__(self, datasets: Sequence):
        self.datasets = []
        for d in datasets:
            if isinstance(d, ConcatDataset):
                self.datasets.extend(d.datasets)
            else:
                self.datasets.append(d)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        di = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[di][index - int(self._offsets[di])]

    def __add__(self, other):
        return ConcatDataset([self, other])

    def __rmul__(self, v: int):
        return ConcatDataset([self] * v)


class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean"):
        self.ds_name = f"sintel-{split}-{dstype}"
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        self.extra_info = []
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list += [[images[i], images[i + 1]]]
                self.extra_info += [(scene, i)]
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene,
                                                       "*.flo")))


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file="datasets/FlyingChairs_release/"
                            "FlyingChairs_train_val.txt"):
        self.ds_name = f"chairs-{split}"
        super().__init__(aug_params)
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        if len(images) // 2 != len(flows):
            raise ValueError(f"{root}: {len(images)} images for "
                             f"{len(flows)} flows")
        split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or \
               (split == "validation" and xid == 2):
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class FlyingThings3D(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 split="training", dstype="frames_cleanpass",
                 val_filter_file="things_val_test_set.txt"):
        short = {"frames_cleanpass": "clean", "frames_finalpass": "final"}
        self.ds_name = f"things-{split}-{short[dstype]}"
        super().__init__(aug_params)
        subset = "TRAIN" if split == "training" else "TEST"
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(osp.join(f, "left") for f in glob(
                osp.join(root, dstype, f"{subset}/*/*")))
            flow_dirs = sorted(osp.join(f, direction, "left") for f in glob(
                osp.join(root, f"optical_flow/{subset}/*/*")))
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob(osp.join(idir, "*.png")))
                flows = sorted(glob(osp.join(fdir, "*.flo"))) or \
                    sorted(glob(osp.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_list += [[images[i], images[i + 1]]]
                        self.flow_list += [flows[i]]
                    else:
                        self.image_list += [[images[i + 1], images[i]]]
                        self.flow_list += [flows[i + 1]]
        if split == "validation" and osp.isfile(val_filter_file):
            sel = np.loadtxt(val_filter_file, dtype=np.int32)
            self.image_list = [p for p, s in zip(self.image_list, sel) if s]
            self.flow_list = [p for p, s in zip(self.flow_list, sel) if s]


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        self.ds_name = f"kitti-{split}"
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        self.extra_info = []
        for img1, img2 in zip(images1, images2):
            self.image_list += [[img1, img2]]
            self.extra_info += [[img1.split("/")[-1]]]
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


def _train_test_split_42(items_list, test_size=0.3, seed=42):
    """sklearn ``train_test_split(random_state=42)``: a RandomState
    permutation, n_test = ceil(test_size * n); (train, test) per list."""
    n = len(items_list[0])
    n_test = int(np.ceil(test_size * n))
    perm = np.random.RandomState(seed).permutation(n)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    out = []
    for items in items_list:
        out.append([items[i] for i in train_idx])
        out.append([items[i] for i in test_idx])
    return out


class KITTITrain(FlowDataset):
    """70/30 re-split of KITTI training (reference datasets.py:310-342)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        self.ds_name = f"kittitrain-{split}"
        super().__init__(aug_params, sparse=True)
        root = osp.join(root, "training")
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))
        image_list = [[a, b] for a, b in zip(images1, images2)]
        extra = [[a.split("/")[-1]] for a in images1]
        img_tr, img_te, flo_tr, flo_te, ex_tr, ex_te = _train_test_split_42(
            [image_list, flow_list, extra])
        if split == "training":
            self.image_list, self.flow_list, self.extra_info = \
                img_tr, flo_tr, ex_tr
        else:
            self.image_list, self.flow_list, self.extra_info = \
                img_te, flo_te, ex_te


class HD1K(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/HD1k"):
        self.ds_name = "hd1k"
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                         "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(root, "hd1k_input",
                                          "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list += [flows[i]]
                self.image_list += [[images[i], images[i + 1]]]
            seq_ix += 1


class Autoflow(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/autoflow"):
        self.ds_name = f"autoflow-{split}"
        super().__init__(aug_params)
        scenes = sorted(os.listdir(root))
        training_size = int(len(scenes) * 0.9)
        for i, scene in enumerate(scenes):
            if (split == "training" and i <= training_size) or \
               (split == "test" and i > training_size):
                self.image_list += [[osp.join(root, scene, "im0.png"),
                                     osp.join(root, scene, "im1.png")]]
                self.flow_list += [osp.join(root, scene, "forward.flo")]


TRAINING_STAGES = ("chairs", "things", "sintel", "kitti", "kittitrain",
                   "viper", "autoflow")


def fetch_training_dataset(stage: str, image_size, shift_prob=0.0,
                           shift_sigmas=(16, 10), data_root="datasets",
                           sintel_train_ds="C+T+K+S+H"):
    """Per-stage dataset mixes and augmentation parameters (reference
    datasets.py:509-567).  The viper stage reads JPEG frames, which the
    port does not decode yet (SystemExit naming its ROADMAP.md item)."""
    base = dict(crop_size=image_size, shift_prob=shift_prob,
                shift_sigmas=shift_sigmas)
    if stage == "chairs":
        aug = dict(base, min_scale=-0.1, max_scale=1.0, do_flip=True)
        return FlyingChairs(aug, split="training",
                            root=f"{data_root}/FlyingChairs_release/data",
                            split_file=f"{data_root}/FlyingChairs_release/"
                                       "FlyingChairs_train_val.txt")
    if stage == "things":
        aug = dict(base, min_scale=-0.4, max_scale=0.8, do_flip=True)
        root = f"{data_root}/FlyingThings3D"
        return (FlyingThings3D(aug, root=root, dstype="frames_cleanpass")
                + FlyingThings3D(aug, root=root, dstype="frames_finalpass"))
    if stage == "autoflow":
        aug = dict(base, min_scale=-0.2, max_scale=0.8, spatial_aug_prob=1,
                   do_flip=True)
        return Autoflow(aug, root=f"{data_root}/autoflow")
    if stage == "sintel":
        aug = dict(base, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things_clean = FlyingThings3D(aug, root=f"{data_root}/FlyingThings3D",
                                      dstype="frames_cleanpass")
        sintel_clean = MpiSintel(aug, split="training", dstype="clean",
                                 root=f"{data_root}/Sintel")
        sintel_final = MpiSintel(aug, split="training", dstype="final",
                                 root=f"{data_root}/Sintel")
        if sintel_train_ds == "C+T+K+S+H":
            kitti = KITTI(dict(base, min_scale=-0.3, max_scale=0.5,
                               do_flip=True), root=f"{data_root}/KITTI")
            hd1k = HD1K(dict(base, min_scale=-0.5, max_scale=0.2,
                             do_flip=True), root=f"{data_root}/HD1k")
            return (100 * sintel_clean + 100 * sintel_final + 200 * kitti
                    + 5 * hd1k + things_clean)
        return 100 * sintel_clean + 100 * sintel_final + things_clean
    if stage == "kitti":
        aug = dict(base, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return KITTI(aug, split="training", root=f"{data_root}/KITTI")
    if stage == "kittitrain":
        aug = dict(base, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return KITTITrain(aug, split="training", root=f"{data_root}/KITTI")
    if stage == "viper":
        raise not_ported("--stage viper (VIPER's JPEG frames)", ROADMAP_EVAL)
    raise ValueError(f"unknown stage {stage}")
