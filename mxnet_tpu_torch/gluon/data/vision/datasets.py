"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``).

Nothing downloads: every dataset reads standard local files (idx-ubyte
for MNIST, pickled batches for CIFAR, image trees for
``ImageFolderDataset``, a ``.lst`` for ``ImageListDataset``, a ``.rec``
for ``ImageRecordDataset``) and raises ``FileNotFoundError`` when they
are absent.  Images stay numpy (HWC uint8) on the host, decoded by cv2:
a ``DataLoader`` worker may index them, and the loader copies each batch
to the device once.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _onp

from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset", "ImageListDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx-ubyte files under ``root``."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_pair(self, image_file, label_file):
        def _open(p):
            if os.path.exists(p + ".gz"):
                return gzip.open(p + ".gz", "rb")
            return open(p, "rb")
        with _open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = _onp.frombuffer(fin.read(), dtype=_onp.uint8) \
                .astype(_onp.int32)
        with _open(image_file) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = _onp.frombuffer(fin.read(), dtype=_onp.uint8)
            data = data.reshape(num, rows, cols, 1)
        return data, label

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        image_file = os.path.join(self._root, files[0])
        label_file = os.path.join(self._root, files[1])
        if not (os.path.exists(image_file) or
                os.path.exists(image_file + ".gz")):
            raise FileNotFoundError(
                "MNIST files not found under %s (nothing is downloaded: "
                "place %s/%s there)" % (self._root, *files))
        data, label = self._read_pair(image_file, label_file)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickled batches under ``root``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _unpickle(self, f):
        with open(f, "rb") as fin:
            d = pickle.load(fin, encoding="bytes")
        data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = _onp.asarray(d.get(b"labels", d.get(b"fine_labels")),
                              dtype=_onp.int32)
        return data, labels

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if self._train:
            return [os.path.join(base, "data_batch_%d" % i)
                    for i in range(1, 6)]
        return [os.path.join(base, "test_batch")]

    def _get_data(self):
        files = self._batch_files()
        if not os.path.exists(files[0]):
            tar = os.path.join(self._root, "cifar-10-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
            else:
                raise FileNotFoundError(
                    "CIFAR batches not found under %s" % self._root)
        data, labels = zip(*[self._unpickle(f) for f in files])
        self._data = _onp.concatenate(data).astype(_onp.uint8)
        self._label = _onp.concatenate(labels)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=True,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-100-python")
        return [os.path.join(base, "train" if self._train else "test")]


class ImageFolderDataset(Dataset):
    """Images arranged as ``root/category/image.jpg``, labelled by the
    sorted category folders."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        import cv2
        img = cv2.imread(self.items[idx][0],
                         cv2.IMREAD_COLOR if self._flag else
                         cv2.IMREAD_GRAYSCALE)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if self._flag else img
        img = _onp.ascontiguousarray(img, dtype=_onp.uint8)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(RecordFileDataset):
    """(image, label) records of a ``.rec`` file: HWC uint8 numpy
    decoded by cv2 (BGR, as the reference leaves it), a scalar label as
    a float."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = super().__getitem__(idx)
        header, img = unpack_img(record, self._flag)
        img = _onp.ascontiguousarray(img).astype(_onp.uint8)
        label = header.label
        if isinstance(label, _onp.ndarray) and label.size == 1:
            label = float(label)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageListDataset(Dataset):
    """Images named by a .lst file (``index\\tlabel...\\tpath`` lines) or
    an in-memory ``[[label(s), path], ...]`` list
    (the reference's ``ImageListDataset``)."""

    def __init__(self, root=".", imglist=None, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split("\t")
                    if len(parts) < 3:
                        raise ValueError(
                            "%s:%d: expected 'index\\tlabel...\\tpath', "
                            "got %r" % (imglist, lineno, line))
                    label = [float(v) for v in parts[1:-1]]
                    self.items.append((parts[-1], label[0]
                                       if len(label) == 1 else
                                       _onp.array(label, "float32")))
        elif isinstance(imglist, list):
            for entry in imglist:
                label, path = entry[:-1], entry[-1]
                label = label[0] if len(label) == 1 else \
                    _onp.array(label, "float32")
                self.items.append((path, label))
        else:
            raise ValueError("imglist must be a path or a list")

    def __getitem__(self, idx):
        import cv2
        path, label = self.items[idx]
        full = os.path.join(self._root, path)
        img = cv2.imread(full, cv2.IMREAD_COLOR if self._flag
                         else cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError("cannot read image %s" % full)
        img = img[:, :, ::-1] if self._flag else img[:, :, None]
        img = _onp.ascontiguousarray(img)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
