"""Mesh post-processing (port of disn_tpu/postprocessing.py).

Splits a mesh into connected components (union-find over shared vertices),
keeps components with at least `vert_ratio` x the largest component's
vertex count AND centroid within `center_dist` of the origin, and re-merges.
Host-side numpy; clean_mesh_file does it to an OBJ file (the `clean`
subcommand).
"""
from __future__ import annotations

import numpy as np


def connected_components(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """[n_verts] component label per vertex (union-find)."""
    parent = np.arange(n_verts)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for f in faces:
        a = find(f[0])
        for v in f[1:]:
            b = find(v)
            if a != b:
                parent[b] = a
    return np.asarray([find(i) for i in range(n_verts)])


def clean_small_parts(verts: np.ndarray, faces: np.ndarray,
                      vert_ratio: float = 0.3, center_dist: float = 0.5
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Drop small / far-from-center components; reindex the kept mesh."""
    if len(faces) == 0:
        return verts, faces
    labels = connected_components(len(verts), faces)
    uniq, counts = np.unique(labels, return_counts=True)
    max_count = counts.max()
    keep_labels = [int(lab) for lab, cnt in zip(uniq, counts)
                   if cnt >= vert_ratio * max_count
                   and np.linalg.norm(verts[labels == lab].mean(axis=0))
                   <= center_dist]
    keep_mask = np.isin(labels, keep_labels)
    remap = -np.ones(len(verts), np.int64)
    remap[keep_mask] = np.arange(keep_mask.sum())
    face_keep = keep_mask[faces].all(axis=1)
    return verts[keep_mask], remap[faces[face_keep]].astype(np.int32)


def clean_mesh_file(src: str, dst: str, vert_ratio: float = 0.3,
                    center_dist: float = 0.5) -> None:
    """clean_small_parts on the OBJ at `src`, written to `dst`."""
    from disn_tpu_torch.core import codecs
    verts, faces = codecs.read_obj(src)
    v, f = clean_small_parts(verts, faces, vert_ratio, center_dist)
    codecs.write_obj(dst, v, f)
