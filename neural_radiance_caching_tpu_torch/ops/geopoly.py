"""Geodesic polyhedron bases for lifted integrated positional encoding
(counterpart of ``ops/geopoly.py``). Pure numpy, run once at construction.
"""

from __future__ import annotations

import itertools
import math as pymath

import numpy as np


def _pairwise_sq_dist(mat0, mat1=None):
    if mat1 is None:
        mat1 = mat0
    n0 = np.sum(mat0**2, 0)
    n1 = np.sum(mat1**2, 0)
    return np.maximum(0, n0[:, None] + n1[None, :] - 2 * mat0.T @ mat1)


def _tesselation_weights(v):
    if v < 1:
        raise ValueError(f"v {v} must be >= 1")
    weights = [(i, j, v - (i + j)) for i in range(v + 1) for j in range(v + 1 - i)]
    return np.array(weights) / v


def _tesselate(base_verts, base_faces, v, eps=1e-4):
    if not isinstance(v, int):
        raise ValueError(f"v {v} must be an integer")
    tri_w = _tesselation_weights(v)
    verts = []
    for face in base_faces:
        new_verts = tri_w @ base_verts[face, :]
        new_verts /= np.sqrt(np.sum(new_verts**2, 1, keepdims=True))
        verts.append(new_verts)
    verts = np.concatenate(verts, 0)
    sq_dist = _pairwise_sq_dist(verts.T)
    assignment = np.array([np.min(np.argwhere(d <= eps)) for d in sq_dist])
    return verts[np.unique(assignment), :]


def generate_basis(base_shape, angular_tesselation, remove_symmetries=True, eps=1e-4):
    """Tesselate a polyhedron into a [n, 3] direction basis.

    base_shape is one of 'tetrahedron', 'icosahedron', 'octahedron'; with
    remove_symmetries, mirror-image directions are dropped.
    """
    if base_shape == "tetrahedron":
        verts = np.array([
            (pymath.sqrt(8 / 9), 0, -1 / 3),
            (-pymath.sqrt(2 / 9), pymath.sqrt(2 / 3), -1 / 3),
            (-pymath.sqrt(2 / 9), -pymath.sqrt(2 / 3), -1 / 3),
            (0, 0, 1),
        ])
        faces = np.array([(0, 1, 2), (0, 2, 3), (0, 1, 3), (1, 2, 3)])
    elif base_shape == "icosahedron":
        a = (pymath.sqrt(5) + 1) / 2
        verts = np.array([
            (-1, 0, a), (1, 0, a), (-1, 0, -a), (1, 0, -a),
            (0, a, 1), (0, a, -1), (0, -a, 1), (0, -a, -1),
            (a, 1, 0), (-a, 1, 0), (a, -1, 0), (-a, -1, 0),
        ]) / pymath.sqrt(a + 2)
        faces = np.array([
            (0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1),
            (8, 10, 1), (8, 3, 10), (5, 3, 8), (5, 2, 3), (2, 7, 3),
            (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6), (0, 1, 6),
            (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11),
        ])
    elif base_shape == "octahedron":
        verts = np.array(
            [(0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)]
        )
        corners = np.array(list(itertools.product([-1, 1], repeat=3)))
        pairs = np.argwhere(_pairwise_sq_dist(corners.T, verts.T) == 2)
        faces = np.sort(np.reshape(pairs[:, 1], [3, -1]).T, 1)
    else:
        raise ValueError(f"base_shape {base_shape} not supported")

    verts = _tesselate(verts, faces, angular_tesselation)
    if remove_symmetries:
        match = _pairwise_sq_dist(verts.T, -verts.T) < eps
        verts = verts[~np.any(np.triu(match), axis=0), :]
    return verts[:, ::-1]
