"""The evaluation datasets (port of the evaluation side of
``craft_tpu.data.datasets``; reference core/datasets.py:25-240): MPI
Sintel, FlyingChairs (its validation split through
FlyingChairs_train_val.txt) and KITTI 2015, read without augmentation.

Items are numpy dicts, as in the JAX package: image1 and image2 [H, W, 3]
fp32 in [0, 255], flow [H, W, 2] fp32, valid [H, W] fp32, extra_info.  The
directory layouts and file lists are the reference's.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from craft_tpu_torch.data import frame_utils


class FlowDataset:
    """An image pair and its flow per item; validity from the KITTI codec
    (sparse) or |flow| < 1000 (dense), reference datasets.py:25-152."""

    def __init__(self, sparse: bool = False):
        self.sparse = sparse
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
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & \
                (np.abs(flow[..., 1]) < 1000)
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow, "valid": valid.astype(np.float32),
                "extra_info": extra}

    def __len__(self):
        return len(self.image_list)


class MpiSintel(FlowDataset):
    def __init__(self, split="training", root="datasets/Sintel",
                 dstype="clean"):
        super().__init__()
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
    def __init__(self, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file="datasets/FlyingChairs_release/"
                            "FlyingChairs_train_val.txt"):
        super().__init__()
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


class KITTI(FlowDataset):
    def __init__(self, split="training", root="datasets/KITTI"):
        super().__init__(sparse=True)
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
