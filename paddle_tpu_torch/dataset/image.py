"""Image preprocessing utilities (counterpart of
paddle_tpu/dataset/image.py, copied: numpy, with Pillow imported only
when a decode or resize is called, so nothing else needs it).
All functions take/return HWC uint8-or-float numpy arrays except where
noted; `simple_transform` is the train/test pipeline image models feed
through.
"""
from __future__ import annotations

import io

import numpy as np

__all__ = [
    'load_image_bytes', 'load_image', 'resize_short', 'to_chw',
    'center_crop', 'random_crop', 'left_right_flip', 'simple_transform',
    'load_and_transform', 'batch_images_from_tar'
]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError:                      # pragma: no cover
        raise ImportError(
            'dataset.image needs Pillow for decode/resize; raw-array '
            'transforms (crop/flip/to_chw) work without it')


def load_image_bytes(data, is_color=True):
    """Decode an encoded image (jpeg/png/... bytes) to an HWC uint8
    array; grayscale HW when is_color=False."""
    img = _pil().open(io.BytesIO(data))
    img = img.convert('RGB' if is_color else 'L')
    return np.asarray(img)


def load_image(file_path, is_color=True):
    """Load an image file to an HWC uint8 array (HW if not color)."""
    with open(file_path, 'rb') as f:
        return load_image_bytes(f.read(), is_color=is_color)


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size`, keeping aspect."""
    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / float(w)))
    else:
        new_w, new_h = int(round(w * size / float(h))), size
    Image = _pil()
    mode = 'RGB' if im.ndim == 3 else 'L'
    arr = im if im.dtype == np.uint8 else \
        np.clip(im, 0, 255).astype(np.uint8)
    out = Image.fromarray(arr, mode=mode).resize((new_w, new_h),
                                                 Image.BILINEAR)
    return np.asarray(out)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (the layout the reference's conv stack feeds)."""
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = int(rng.uniform(0, h - size + 1))
    w_start = int(rng.uniform(0, w - size + 1))
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None, rng=None):
    """resize_short -> (random crop + coin-flip LR flip | center crop)
    -> CHW float32 -> optional mean subtraction (per-channel 3-vector
    or full array) — the reference's standard train/eval pipeline."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype('float32')
    if mean is not None:
        mean = np.array(mean, dtype='float32')
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch a tar of images into pickled (data, label) block files
    (reference image.py:48 — the out-of-core preprocessing helper).
    Returns the meta-file path listing the batch files."""
    import os
    import pickle
    import tarfile

    out_path = data_file + '_batch'
    meta = '%s/batch_meta' % out_path
    if os.path.exists(meta):
        return meta
    os.makedirs(out_path, exist_ok=True)
    tf = tarfile.open(data_file)
    data, labels, file_id, batch_files = [], [], 0, []
    for mem in tf.getmembers():
        if mem.name not in img2label:
            continue
        data.append(tf.extractfile(mem).read())
        labels.append(img2label[mem.name])
        if len(data) == num_per_batch:
            bf = '%s/batch_%d' % (out_path, file_id)
            with open(bf, 'wb') as f:
                pickle.dump({'data': data, 'label': labels}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            batch_files.append(bf)
            data, labels, file_id = [], [], file_id + 1
    if data:
        bf = '%s/batch_%d' % (out_path, file_id)
        with open(bf, 'wb') as f:
            pickle.dump({'data': data, 'label': labels}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        batch_files.append(bf)
    tf.close()
    with open(meta, 'w') as f:
        f.write('\n'.join(batch_files))
    return meta
