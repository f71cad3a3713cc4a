"""im2rec: pack an image folder (or a .lst manifest) into RecordIO.

Counterpart of ``mxnet_tpu/tools/im2rec.py`` (:23-106): the same .lst
format (``index\tlabel[\tlabels...]\trelpath``), class per sorted
subfolder, and the same .rec/.idx output, which ``ImageRecordIter``
(the native io core too) and ``vision.ImageRecordDataset`` read.

Usage:
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list      # make .lst
    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT             # pack .rec
"""
from __future__ import annotations

import argparse
import os
import random
import sys

from ..recordio import IRHeader, MXIndexedRecordIO, pack_img

_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def make_list(prefix: str, root: str, shuffle: bool = True,
              seed: int = 0) -> str:
    """Walk ``root``; one class per subdirectory (sorted), exactly the
    reference's folder convention."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    entries = []
    if classes:
        for label, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if os.path.splitext(fn)[1].lower() in _EXTS:
                    entries.append((float(label),
                                    os.path.join(cls, fn)))
    else:       # flat folder: label 0
        for fn in sorted(os.listdir(root)):
            if os.path.splitext(fn)[1].lower() in _EXTS:
                entries.append((0.0, fn))
    if shuffle:
        random.Random(seed).shuffle(entries)
    lst = f"{prefix}.lst"
    with open(lst, "w") as f:
        for i, (label, rel) in enumerate(entries):
            f.write(f"{i}\t{label}\t{rel}\n")
    return lst


def read_list(lst_path: str):
    with open(lst_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def pack(prefix: str, root: str, quality: int = 95,
         resize: int = 0) -> str:
    """Read ``prefix.lst``, write ``prefix.rec`` + ``prefix.idx``."""
    import numpy as np
    from PIL import Image

    rec = MXIndexedRecordIO(f"{prefix}.idx", f"{prefix}.rec", "w")
    n = 0
    for idx, labels, rel in read_list(f"{prefix}.lst"):
        img = Image.open(os.path.join(root, rel)).convert("RGB")
        if resize:
            w, h = img.size
            s = resize / min(w, h)
            img = img.resize((max(1, round(w * s)),
                              max(1, round(h * s))), Image.BILINEAR)
        label = labels[0] if len(labels) == 1 else \
            np.asarray(labels, np.float32)
        rec.write_idx(idx, pack_img(IRHeader(0, label, idx, 0),
                                    np.asarray(img), quality=quality))
        n += 1
    rec.close()
    print(f"packed {n} images -> {prefix}.rec")
    return f"{prefix}.rec"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="im2rec")
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true",
                    help="generate PREFIX.lst instead of packing")
    ap.add_argument("--no-shuffle", action="store_true")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--resize", type=int, default=0)
    args = ap.parse_args(argv)
    if args.list:
        make_list(args.prefix, args.root, shuffle=not args.no_shuffle)
    else:
        if not os.path.isfile(f"{args.prefix}.lst"):
            make_list(args.prefix, args.root,
                      shuffle=not args.no_shuffle)
        pack(args.prefix, args.root, args.quality, args.resize)


if __name__ == "__main__":
    sys.exit(main())
