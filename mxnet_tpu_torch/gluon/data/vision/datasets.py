"""Vision datasets: MNIST, FashionMNIST, CIFAR10/100, ImageRecordDataset
and ImageFolderDataset.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py`` (MXNet's
python/mxnet/gluon/data/vision/datasets.py) with its behaviour: nothing
is downloaded; each dataset reads its standard files from ``root`` when
they are there, and otherwise makes a seeded class-structured set of the
same shape and dtype (with a warning).  Items are CPU ``NDArray``s (HWC
uint8) and labels, as MXNet's are; ``ImageRecordDataset`` decodes with
``recordio.unpack_img`` (PIL, or a ``RAWN`` payload).
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as _np

from ....context import cpu
from ....ndarray import array as nd_array
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synth_image_classification(num, shape, num_classes, seed):
    """Deterministic class-structured synthetic data: each class gets a fixed
    random template; samples are noisy copies.  Linearly separable enough for
    convergence smoke tests."""
    rng = _np.random.RandomState(seed)
    templates = rng.uniform(0, 255, (num_classes,) + shape)
    labels = rng.randint(0, num_classes, num)
    noise = rng.normal(0, 32, (num,) + shape)
    data = _np.clip(templates[labels] + noise, 0, 255).astype(_np.uint8)
    return data, labels.astype(_np.int32)


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        x = nd_array(self._data[idx], ctx=cpu())
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST; reads idx-ubyte(.gz) files from root when present, else
    makes the seeded set."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _shape = (28, 28, 1)
    _classes = 10
    _seed = 2901

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read_idx(self, path_base):
        for ext in ("", ".gz"):
            p = path_base + ext
            if os.path.exists(p):
                op = gzip.open if ext else open
                with op(p, "rb") as f:
                    raw = f.read()
                return raw
        return None

    def _get_data(self):
        imgf, labf = self._files[self._train]
        raw_img = self._read_idx(os.path.join(self._root, imgf))
        raw_lab = self._read_idx(os.path.join(self._root, labf))
        if raw_img is not None and raw_lab is not None:
            magic, num = struct.unpack(">II", raw_lab[:8])
            label = _np.frombuffer(raw_lab, _np.uint8, offset=8)
            magic, num, rows, cols = struct.unpack(">IIII", raw_img[:16])
            data = _np.frombuffer(raw_img, _np.uint8, offset=16).reshape(
                num, rows, cols, 1)
            self._data = data
            self._label = label.astype(_np.int32)
            return
        warnings.warn(
            f"{type(self).__name__}: files not found under {self._root}; "
            f"using a seeded synthetic set of the same shape")
        num = 60000 if self._train else 10000
        seed = self._seed if self._train else self._seed + 1
        self._data, self._label = _synth_image_classification(
            num, self._shape, self._classes, seed)


class FashionMNIST(MNIST):
    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _seed = 2902

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _classes = 10
    _seed = 2903

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        base = os.path.join(self._root, "cifar-10-batches-py")
        if os.path.isdir(base):
            import pickle
            datas, labels = [], []
            for b in batches:
                with open(os.path.join(base, b), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                datas.append(d[b"data"].reshape(-1, 3, 32, 32)
                             .transpose(0, 2, 3, 1))
                labels.extend(d[b"labels"])
            self._data = _np.concatenate(datas)
            self._label = _np.asarray(labels, _np.int32)
            return
        warnings.warn(
            f"{type(self).__name__}: files not found under {self._root}; "
            f"using a seeded synthetic set of the same shape")
        num = 50000 if self._train else 10000
        seed = self._seed if self._train else self._seed + 1
        self._data, self._label = _synth_image_classification(
            num, self._shape, self._classes, seed)


class CIFAR100(CIFAR10):
    _classes = 100
    _seed = 2905

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        base = os.path.join(self._root, "cifar-100-python")
        name = "train" if self._train else "test"
        p = os.path.join(base, name)
        if os.path.exists(p):
            import pickle
            with open(p, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            self._data = d[b"data"].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1)
            self._label = _np.asarray(d[b"fine_labels"], _np.int32)
            return
        warnings.warn(
            f"CIFAR100: files not found under {self._root}; using a "
            f"seeded synthetic set of the same shape")
        num = 50000 if self._train else 10000
        seed = self._seed if self._train else self._seed + 1
        self._data, self._label = _synth_image_classification(
            num, self._shape, self._classes, seed)


class ImageRecordDataset(Dataset):
    """Dataset over a RecordIO pack of (header, jpeg/raw image) records
    (MXNet: mx.gluon.data.vision.ImageRecordDataset over .rec).  One
    reader serves every loader thread: ``read_idx`` reads by position."""

    def __init__(self, filename, flag=1, transform=None):
        from ....recordio import MXIndexedRecordIO, unpack_img
        idx_file = filename[:-4] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform
        self._unpack = unpack_img

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack(record, iscolor=self._flag)
        x = nd_array(img, ctx=cpu())
        y = header.label
        if self._transform is not None:
            return self._transform(x, y)
        return x, y


class ImageFolderDataset(Dataset):
    """A class-per-subfolder image dataset (MXNet:
    gluon/data/vision/datasets.py ImageFolderDataset): ``root/cat/1.jpg``
    has the label of ``cat`` among the sorted folder names.  Decodes with
    ``mx.image`` (PIL)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = {".jpg", ".jpeg", ".png", ".bmp"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, fname),
                                       label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, flag=self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
