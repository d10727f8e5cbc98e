"""File lists: ShapeNet split lists -> (cat_id, obj, view) triples (a copy
of disn_tpu/data/listing.py).

The dataset keeps 13 categories x {train,test} `.lst` files (one object id
per line, <root>/filelists/), and `listinfo` is every (cat_id, obj, view)
combination over `view_num` rendered views. Category quotas for epoch
balancing are counted per cat_id.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

ListInfo = list[tuple[str, str, int]]

#: The 26 ShapeNet split lists (<synset>_{train,test}.lst: 13 categories,
#: 38,317 ids), a copy of those the JAX package ships.
BUNDLED_FILELISTS = os.path.join(os.path.dirname(__file__), "filelists")


def read_lst(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_split(lst_dir: str, cats: dict[str, str], split: str,
               view_num: int = 24) -> tuple[ListInfo, dict[str, int]]:
    """listinfo for a split: every object of `<lst_dir>/<synset>_<split>.lst`
    contributes `view_num` entries (one per rendered view), counted in
    `cats_limit[cat]`. An empty `lst_dir` reads the bundled lists."""
    if not lst_dir:
        lst_dir = BUNDLED_FILELISTS
    listinfo: ListInfo = []
    cats_limit: dict[str, int] = {}
    for _, cat_id in sorted(cats.items()):
        path = os.path.join(lst_dir, f"{cat_id}_{split}.lst")
        if not os.path.exists(path):
            continue
        cats_limit.setdefault(cat_id, 0)
        for obj in read_lst(path):
            for view in range(view_num):
                listinfo.append((cat_id, obj, view))
                cats_limit[cat_id] += 1
    return listinfo, cats_limit


def cat_counts(listinfo: ListInfo) -> dict[str, int]:
    out: dict[str, int] = {}
    for cat_id, _, _ in listinfo:
        out[cat_id] = out.get(cat_id, 0) + 1
    return out


@dataclass(frozen=True)
class SplitPaths:
    """Per-object/view layout on disk: sdf
    `<sdf_dir>/<cat>/<obj>/ori_sample.h5`, image
    `<img_dir>/<cat>/<obj>/<view:02d>.h5`."""

    sdf_dir: str
    img_dir: str

    def sdf_path(self, cat_id: str, obj: str) -> str:
        return os.path.join(self.sdf_dir, cat_id, obj, "ori_sample.h5")

    def img_path(self, cat_id: str, obj: str, view: int) -> str:
        return os.path.join(self.img_dir, cat_id, obj, f"{view:02d}.h5")
