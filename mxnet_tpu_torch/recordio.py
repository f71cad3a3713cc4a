"""RecordIO: MXNet's packed binary record format.

Counterpart of ``mxnet_tpu/recordio.py`` (:1-207).  A record is
``[u32 magic 0xced7230a][u32 length (29 bits) | continuation (3 bits)]``,
its payload, and zero padding to 4 bytes; ``IRHeader`` (flag, label, id,
id2) heads an image record, with ``flag`` float labels after it when the
label is a vector.  ``MXIndexedRecordIO`` adds the ``.idx`` sidecar
(``key\\toffset`` per line).  Files are byte for byte the JAX package's,
so either package reads the other's ``.rec`` and ``.idx``.  ``pack_img``
encodes with PIL and, where PIL is missing, writes the ``RAWN`` raw
payload (``b"RAWN"``, u8 ndim, ndim x u32 shape, the uint8 pixels), which
``unpack_img`` and the native io core read back.

Departure from the JAX package, following MXNet: ``read_idx`` reads its
record with positional reads (``os.pread``) and never moves the shared
file position, so threads that share one reader (``DataLoader`` workers
over ``vision.ImageRecordDataset``) each get the record they asked for.
The JAX package's ``read_idx`` is ``seek`` then ``read`` on one file
object, which interleaves under threads.
"""
from __future__ import annotations

import collections
import io
import os
import struct
from typing import Optional

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1
_HDR_FMT = "IfQQ"
_HDR_SIZE = struct.calcsize(_HDR_FMT)

IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])


def _padded(length: int) -> int:
    return length + (4 - length % 4) % 4


class MXRecordIO:
    """Sequential reader/writer for .rec files."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self._fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("flag must be 'r' or 'w'")
        self.is_open = True

    def close(self):
        if self.is_open:
            self._fp.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self._fp.tell()

    def seek(self, pos: int) -> None:
        self._fp.seek(pos)

    def write(self, buf: bytes) -> None:
        if not self.writable:
            raise MXNetError("not opened for writing")
        length = len(buf)
        self._fp.write(struct.pack("<II", _MAGIC, length & _LEN_MASK))
        self._fp.write(buf)
        pad = _padded(length) - length
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.writable:
            raise MXNetError("not opened for reading")
        head = self._fp.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: bad record magic {magic:#x}")
        length = lrec & _LEN_MASK
        data = self._fp.read(length)
        if _padded(length) > length:
            self._fp.read(_padded(length) - length)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with a .idx sidecar (key\\toffset)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
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
            with open(self.idx_path) as f:
                for line in f:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx) -> bytes:
        """The record of key ``idx``, read at its offset without moving
        the file position: safe from any number of threads."""
        if self.writable:
            raise MXNetError("not opened for reading")
        pos = self.idx[idx]
        fd = self._fp.fileno()
        head = os.pread(fd, 8, pos)
        if len(head) < 8:
            raise MXNetError(f"{self.uri}: record {idx!r} at {pos} is cut")
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: bad record magic {magic:#x}")
        length = lrec & _LEN_MASK
        data = os.pread(fd, length, pos + 8)
        if len(data) < length:
            raise MXNetError(f"{self.uri}: record {idx!r} at {pos} is cut")
        return data

    def write_idx(self, idx, buf: bytes) -> None:
        pos = self.tell()
        self.write(buf)
        self.idx[self.key_type(idx)] = pos
        self.keys.append(self.key_type(idx))


def pack(header: IRHeader, s: bytes) -> bytes:
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_HDR_FMT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = _np.asarray(header.label, dtype=_np.float32)
        hdr = struct.pack(_HDR_FMT, label.size, 0.0, header.id, header.id2) \
            + label.tobytes()
    return hdr + s


def unpack(s: bytes):
    flag, label, id_, id2 = struct.unpack(_HDR_FMT, s[:_HDR_SIZE])
    s = s[_HDR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def _try_encode_img(img: _np.ndarray, quality: int, img_fmt: str):
    try:
        from PIL import Image
    except ImportError:
        return None
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG" if "jpg" in img_fmt
                              or "jpeg" in img_fmt else "PNG",
                              quality=quality)
    return buf.getvalue()


def _raw_payload(img) -> bytes:
    """The ``RAWN`` payload of a uint8 image: what ``pack_img`` writes
    where PIL is missing."""
    img = _np.asarray(img, dtype=_np.uint8)
    return b"RAWN" + struct.pack("<B", img.ndim) + \
        struct.pack(f"<{img.ndim}I", *img.shape) + img.tobytes()


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    img = _np.asarray(img, dtype=_np.uint8)
    encoded = _try_encode_img(img, quality, img_fmt)
    if encoded is None:
        encoded = _raw_payload(img)
    return pack(header, encoded)


def unpack_img(s: bytes, iscolor: int = -1):
    header, payload = unpack(s)
    if payload[:4] == b"RAWN":
        ndim = struct.unpack("<B", payload[4:5])[0]
        shape = struct.unpack(f"<{ndim}I", payload[5:5 + 4 * ndim])
        img = _np.frombuffer(payload[5 + 4 * ndim:], dtype=_np.uint8) \
            .reshape(shape)
        return header, img
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("no image decoder available (PIL missing) and "
                         "payload is not raw format") from e
    return header, _np.asarray(Image.open(io.BytesIO(payload)))
