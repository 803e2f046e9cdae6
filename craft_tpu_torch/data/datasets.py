"""The datasets (port of ``craft_tpu.data.datasets``; reference
core/datasets.py:25-580): MPI Sintel (with its occlusion masks),
FlyingChairs (its splits through FlyingChairs_train_val.txt),
FlyingThings3D, KITTI 2015 (and its 70/30 re-split, KITTITrain), HD1K,
Autoflow, VIPER (JPEG frames) and SlowFlow, with or without augmentation,
and the training curriculum's mixes (``fetch_training_dataset``).

Items are numpy dicts, as in the JAX package: image1 and image2 [H, W, 3]
fp32 in [0, 255], flow [H, W, 2] fp32, valid [H, W] fp32, extra_info, and
occ [H, W] bool where the dataset reads occlusion masks.  The directory
layouts, file lists, multipliers and augmentation parameters are the
reference's.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

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
        self.occ_list: Optional[List[str]] = None

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
        item = {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": valid.astype(np.float32),
                "extra_info": extra}
        if self.occ_list is not None:
            occ = np.asarray(frame_utils.read_gen(self.occ_list[index]))
            item["occ"] = (occ.astype(np.uint8) // 255).astype(bool)
        return item

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
    """MPI Sintel; with occlusion=True each item also carries the pair's
    occlusion mask from <split>/occlusions (item["occ"])."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean", occlusion=False):
        self.ds_name = f"sintel-{split}-{dstype}"
        super().__init__(aug_params)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        occ_root = osp.join(root, split, "occlusions")
        if occlusion:
            self.occ_list = []
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
                if occlusion:
                    self.occ_list += sorted(glob(osp.join(occ_root, scene,
                                                          "*.png")))


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


class VIPER(FlowDataset):
    """VIPER with its flows converted to KITTI PNGs (reference
    datasets.py:391-458): JPEG (or PNG) frames, every tenth frame's pair
    in the train and val splits, the listed frames in the test split."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/viper/", filetype="jpg"):
        self.ds_name = f"viper-{split}"
        super().__init__(aug_params, sparse=True)
        split = {"training": "train", "validation": "val",
                 "test": "test"}[split]
        img_root = osp.join(root, filetype, split, "img")
        flow_root = osp.join(root, filetype, split, "flow")
        self.extra_info = []
        test_frames = set()
        if split == "test":
            with open(osp.join(root, "test_frames.txt")) as f:
                test_frames = {line.strip() for line in f if line.strip()}
            self.is_test = True
        for scene in sorted(os.listdir(img_root)):
            for img0_name in sorted(os.listdir(osp.join(img_root, scene))):
                m = re.match(r"(\d{3})_(\d{5}).(jpg|png)", img0_name)
                if not m:
                    continue
                img0_idx, suffix = m.group(2), m.group(3)
                trunk = f"{scene}_{img0_idx}"
                first = (split in ("train", "val") and img0_idx[-1] == "0") \
                    or (split == "test" and trunk in test_frames)
                if not first:
                    continue
                img1_name = f"{scene}_{int(img0_idx) + 1:05d}.{suffix}"
                image0 = osp.join(img_root, scene, img0_name)
                image1 = osp.join(img_root, scene, img1_name)
                flow_p = osp.join(flow_root, scene, img0_name[:-3] + "png")
                if not osp.isfile(image1):
                    continue
                if split != "test" and not osp.isfile(flow_p):
                    continue
                self.image_list += [[image0, image1]]
                self.flow_list += [flow_p]
                self.extra_info += [[trunk]]


class SlowFlow(FlowDataset):
    """SlowFlow (reference datasets.py:460-507): every frame pair
    seqN_xxx0 -> seqN_xxx1 with a .flo, at one blur magnitude and blur
    frame count."""

    def __init__(self, aug_params=None, split="test",
                 root="datasets/slowflow/", blur_mag=100, blur_num_frames=0):
        self.ds_name = f"slowflow-{split}-{blur_mag}-{blur_num_frames}"
        super().__init__(aug_params, sparse=False)
        seq_folder = ("sequence" if blur_num_frames == 0
                      else f"sequence_R0{blur_num_frames}")
        seq_root = osp.join(root, str(blur_mag), seq_folder)
        flow_root = osp.join(root, str(blur_mag), "flow")
        self.extra_info = []
        for scene in sorted(os.listdir(seq_root)):
            for img0_name in sorted(os.listdir(osp.join(seq_root, scene))):
                m = re.match(r"seq(\d+)_(\d+).png", img0_name)
                if not m or m.group(2)[-1] != "0":
                    continue
                trunk = f"seq{m.group(1)}_{m.group(2)}"
                img1_name = f"seq{m.group(1)}_{m.group(2)[:-1]}1.png"
                flow_p = osp.join(flow_root, scene, trunk + ".flo")
                if not osp.isfile(flow_p):
                    continue
                self.image_list += [[osp.join(seq_root, scene, img0_name),
                                     osp.join(seq_root, scene, img1_name)]]
                self.flow_list += [flow_p]
                self.extra_info += [[scene, trunk]]


TRAINING_STAGES = ("chairs", "things", "sintel", "kitti", "kittitrain",
                   "viper", "autoflow")


def fetch_training_dataset(stage: str, image_size, shift_prob=0.0,
                           shift_sigmas=(16, 10), data_root="datasets",
                           sintel_train_ds="C+T+K+S+H"):
    """Per-stage dataset mixes and augmentation parameters (reference
    datasets.py:509-567)."""
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
        aug = dict(base, min_scale=-1, max_scale=-0.5, spatial_aug_prob=1,
                   do_flip=False)
        return VIPER(aug, split="training", root=f"{data_root}/viper/")
    raise ValueError(f"unknown stage {stage}")
