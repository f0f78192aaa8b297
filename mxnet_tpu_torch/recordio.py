"""RecordIO: MXNet's binary record container, on the host.

Counterpart of ``mxnet_tpu/recordio.py`` (``MXRecordIO``,
``MXIndexedRecordIO``, ``IRHeader``, ``pack`` / ``unpack`` /
``pack_img`` / ``unpack_img``) over dmlc-core's recordio format.  Format (dmlc-core recordio.h): each
record is ``uint32 magic=0xced7230a``, ``uint32 lrecord=(cflag<<29)|len``,
payload, zero-padded to 4 bytes.  Continuation flags (cflag 1/2/3) split
records containing the magic bytes; this writer never splits (cflag 0) and
the reader handles both.

The ``.rec`` / ``.idx`` files written here are byte for byte those of
the JAX package and of MXNet's ``tools/im2rec.py``, and each reads the
others'.  Nothing here touches torch: records are bytes and numpy, so a
``DataLoader`` worker process may use them.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as _onp

_MAGIC = 0xCED7230A
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record reader/writer."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            # mxlint: disable=R2 -- a streaming record writer; a torn tail
            # record is caught by the per-record magic / length framing on
            # read
            self.fhandle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fhandle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.fhandle.close()
            self.is_open = False
            self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["fhandle"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def _check_pid(self):
        # reopen after a fork (a DataLoader worker gets its own handle)
        if self.pid != os.getpid():
            pos = self.fhandle.tell() if self.is_open else 0
            self.open()
            self.fhandle.seek(pos)

    def write(self, buf):
        assert self.writable
        self._check_pid()
        data = struct.pack("<II", _MAGIC, len(buf)) + buf
        pad = (-len(buf)) % 4
        self.fhandle.write(data + b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid()
        parts = []
        while True:
            header = self.fhandle.read(8)
            if len(header) < 8:
                if parts:
                    raise IOError("truncated record")
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise IOError("invalid record magic %x" % magic)
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            data = self.fhandle.read(length)
            self.fhandle.read((-length) % 4)
            parts.append(data)
            if cflag in (0, 3):  # whole record or last chunk
                break
        return b"".join(parts) if len(parts) > 1 else parts[0]

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fhandle.tell()

    def seek(self, pos):
        assert not self.writable
        self._check_pid()
        self.fhandle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with a ``.idx`` sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            from .utils.serialization import atomic_write
            with atomic_write(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """``header`` (an ``IRHeader`` or 4-tuple) and the bytes ``s`` as one
    record's payload."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        # numeric label: flag 0, so unpack does not read payload bytes as
        # label floats (MXNet's pack: _replace(flag=0))
        out = struct.pack(_IR_FORMAT, 0, header.label, header.id,
                          header.id2) + s
    else:
        # array label: flag = element count (label.size, so 0-d and
        # multi-dimensional labels work)
        label = _onp.asarray(header.label, dtype=_onp.float32)
        out = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2) + label.ravel().tobytes() + s
    return out


def unpack(s):
    """(``IRHeader``, payload bytes) of a record; an array label comes
    back as a float32 numpy array."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _onp.frombuffer(s[:header.flag * 4], dtype=_onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``pack`` of ``img`` (HWC uint8, BGR as cv2 reads) encoded by cv2."""
    import cv2
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """(``IRHeader``, the image cv2 decodes from the payload)."""
    import cv2
    header, s = unpack(s)
    img = cv2.imdecode(_onp.frombuffer(s, dtype=_onp.uint8), iscolor)
    return header, img
