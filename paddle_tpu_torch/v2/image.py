"""``paddle.v2.image`` (counterpart of ``paddle_tpu/v2/image.py``): image
preprocessing for CHW pipelines.

Reference: ``python/paddle/v2/image.py`` (cv2-based).  The same
``__all__`` surface on PIL + numpy, PIL imported at first use (cv2 is
not in this stack); images flow as HWC uint8/float arrays and convert
to the reference's CHW layout with :func:`to_chw` exactly as the
reference documents.
"""

from __future__ import annotations

import io
import tarfile
from typing import Optional

import numpy as np

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _pil():
    from PIL import Image
    return Image


def load_image_bytes(bytes_data, is_color: bool = True) -> np.ndarray:
    """Decode an in-memory image to HWC (or HW when grayscale)."""
    img = _pil().open(io.BytesIO(bytes_data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file: str, is_color: bool = True) -> np.ndarray:
    img = _pil().open(file)
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER edge equals ``size`` (aspect preserved)."""
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    pil = _pil().fromarray(np.asarray(im, np.uint8))
    return np.asarray(pil.resize((w_new, h_new), _pil().BILINEAR))


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC → CHW (the reference's storage layout for dense image rows)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int,
                is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = int(rng.randint(0, h - size + 1))
    w_start = int(rng.randint(0, w - size + 1))
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean=None,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """resize-short → crop (random+flip when training, center otherwise)
    → CHW float32 → optional mean subtraction (``image.py``
    simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(0, 2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and len(im.shape) == 3:
            mean = mean[:, None, None]     # per-channel
        im -= mean
    return im


def load_and_transform(filename: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean=None) -> np.ndarray:
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: dict, num_per_batch: int = 1024):
    """Pack images from a tar into pickled batches next to the tar
    (``image.py`` batch_images_from_tar; numpy arrays instead of the
    reference's cPickle'd cv2 buffers)."""
    import os
    import pickle

    out_path = f"{data_file}_{dataset_name}_batch"
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id = [], [], 0
    meta = []
    with tarfile.open(data_file) as f:
        for mem in f:
            if mem.name not in img2label:
                continue
            data.append(load_image_bytes(f.extractfile(mem).read()))
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                output = {"label": labels,
                          "data": [np.asarray(d) for d in data]}
                name = os.path.join(out_path, f"batch_{file_id}")
                with open(name, "wb") as o:
                    pickle.dump(output, o, protocol=2)
                meta.append(name)
                file_id += 1
                data, labels = [], []
    if data:
        output = {"label": labels, "data": [np.asarray(d) for d in data]}
        name = os.path.join(out_path, f"batch_{file_id}")
        with open(name, "wb") as o:
            pickle.dump(output, o, protocol=2)
        meta.append(name)
    with open(os.path.join(out_path, "batch_meta"), "w") as o:
        o.write("\n".join(meta))
    return out_path
