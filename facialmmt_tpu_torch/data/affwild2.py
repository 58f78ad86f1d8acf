"""Aff-Wild2 auxiliary FER dataset (counterpart of
facialmmt_tpu/data/affwild2.py; reference utils/dataset.py:72-153).

List-file format: one "relative/path.jpg label" per line.  When the list is
absent it is generated from the EXPR annotation folder: per-video txt files
whose line i (1-based, after a header of class names) labels frame
0000i.jpg; labels -1 and 7 ('other') are dropped and the ABAW label order is
remapped to MELD's via [0, 6, 5, 2, 4, 3, 1, 7] (reference
utils/dataset.py:76-79, 119-153).

Batches are decoded uint8 frames (BGR, the reference's cv2.imread order) and
int32 labels; augmentation runs on the device
(data/image_pipeline.py::affwild2_train_augment).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from facialmmt_tpu_torch.utils.observability import trace_span

ABAW_TO_MELD = [0, 6, 5, 2, 4, 3, 1, 7]  # reference utils/dataset.py:79


def generate_data_list(file_folder: str, anno_folder: str,
                       save_path: Optional[str] = None,
                       class_mapping: Optional[List[int]] = ABAW_TO_MELD
                       ) -> List[Tuple[str, int]]:
    """Scan the annotation txts -> [(relative_path, label)] for the frames
    that exist (reference :119-153); written to `save_path` when given."""
    out: List[Tuple[str, int]] = []
    for label_file in glob.glob(os.path.join(anno_folder, "*.txt")):
        vid_name = os.path.basename(label_file)[:-4]
        with open(label_file) as f:
            for idx, line in enumerate(f):
                if idx == 0:
                    continue  # header line of class names
                label = int(line)
                if label == -1 or label == 7:
                    continue
                if class_mapping is not None:
                    label = class_mapping[label]
                image_name = f"{str(idx).zfill(5)}.jpg"
                if os.path.isfile(os.path.join(file_folder, vid_name,
                                               image_name)):
                    out.append((os.path.join(vid_name, image_name), label))
    if save_path:
        with open(save_path, "w") as f:
            for path, label in out:
                f.write(f"{path} {label}\n")
    return out


class AffwildDataset:
    def __init__(self, file_folder: str, anno_folder: str = "",
                 data_list: str = "", img_size: int = 112):
        self.file_folder = file_folder
        self.img_size = img_size  # cropped_aligned frames are 112 px
        if data_list and os.path.isfile(data_list):
            self.data_list = []
            with open(data_list) as f:
                for line in f:
                    p, label = line.rsplit(" ", 1)
                    self.data_list.append((p, int(label)))
        else:
            self.data_list = generate_data_list(
                file_folder, anno_folder, save_path=data_list or None)

    def __len__(self):
        return len(self.data_list)

    def get_batch(self, indices: Sequence[int]):
        """(uint8 (B, img_size, img_size, 3) BGR frames, int32 labels)."""
        from facialmmt_tpu_torch.native import decode_images

        with trace_span("fmmt.data.fetch"):
            idx = list(indices)
            labels = np.asarray([self.data_list[i][1] for i in idx],
                                np.int32)
            paths = [os.path.join(self.file_folder, self.data_list[i][0])
                     for i in idx]
            return decode_images(paths, self.img_size,
                                 upscale_interp="area"), labels
