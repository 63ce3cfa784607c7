"""Triangle meshes and ray intersection for the sampler's mesh shortcut
(counterpart of the JAX package's ``ops/mesh.py``).

A ``TriangleMesh`` holds its vertices, faces and vertex normals as tensors
on one device; ``intersect`` is a batched Moller-Trumbore test over chunks
of triangles, keeping the nearest hit per ray, in plain torch ops on the
mesh's device (JAX runs it as jnp under ``lax.scan``, not as a Pallas
kernel). ``load_obj`` parses a Wavefront OBJ itself, with no mesh library.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-7


def _dot(a, b):
    """Sum over the last axis of three products, in sequence."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


class TriangleMesh:
    """Vertices [V, 3] float32, faces [F, 3] int64 and vertex normals
    [V, 3] float32 on `device` (the normals computed area-weighted where
    none are given)."""

    def __init__(self, vertices, faces, vertex_normals=None, device="cpu"):
        if vertex_normals is None:
            vertex_normals = compute_vertex_normals(np.asarray(vertices), np.asarray(faces))
        self.vertices = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
        self.faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.vertex_normals = torch.as_tensor(np.asarray(vertex_normals, np.float32),
                                              device=device)

    @property
    def device(self):
        return self.vertices.device

    @property
    def num_faces(self):
        return self.faces.shape[0]

    def intersect(self, origins, directions, chunk=512):
        """The nearest hit of each ray.

        origins, directions: [..., 3] on the mesh's device; t is in units of
        the directions' length. chunk: triangles tested at once, which
        bounds the intermediates at rays x chunk x 3 floats per tensor.

        Returns (t [...] (+inf where no hit), points [..., 3] (the origins
        where no hit), smooth normals [..., 3] (the vertex normals
        interpolated barycentrically), face normals [..., 3], valid [...]).
        """
        batch_shape = origins.shape[:-1]
        o = origins.reshape(-1, 3)
        d = directions.reshape(-1, 3)
        num_rays = o.shape[0]
        tri = self.vertices[self.faces]  # [F, 3, 3]
        tri_n = self.vertex_normals[self.faces]
        num_faces = tri.shape[0]
        chunk = int(min(chunk, max(num_faces, 1)))
        pad = (-num_faces) % chunk
        if pad:
            # Zero-area padding triangles never intersect.
            tri = torch.cat([tri, tri.new_zeros((pad, 3, 3))])
            tri_n = torch.cat([tri_n, tri_n.new_zeros((pad, 3, 3))])
        best_t = torch.full((num_rays,), float("inf"), device=o.device)
        best_n = torch.zeros((num_rays, 3), device=o.device)
        best_fn = torch.zeros((num_rays, 3), device=o.device)
        rows = torch.arange(num_rays, device=o.device)
        for start in range(0, tri.shape[0], chunk):
            tri_blk, nrm_blk = tri[start:start + chunk], tri_n[start:start + chunk]
            v0, v1, v2 = tri_blk[:, 0], tri_blk[:, 1], tri_blk[:, 2]  # [C, 3]
            e1, e2 = v1 - v0, v2 - v0
            # Rays [R, 1, 3] against triangles [1, C, 3].
            h = _cross(d[:, None, :], e2[None])
            a = _dot(e1[None], h)
            inv_a = torch.where(torch.abs(a) > _EPS,
                                1.0 / torch.where(a == 0, torch.ones_like(a), a),
                                torch.zeros_like(a))
            s = o[:, None, :] - v0[None]
            u = inv_a * _dot(s, h)
            q = _cross(s, e1[None])
            v = inv_a * _dot(d[:, None, :], q)
            t = inv_a * _dot(e2[None], q)
            hit = (torch.abs(a) > _EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS)
            t = torch.where(hit, t, torch.full_like(t, float("inf")))
            j = torch.argmin(t, dim=-1)  # the block's nearest triangle (the first of ties)
            t_blk = t[rows, j]
            u_blk = u[rows, j][:, None]
            v_blk = v[rows, j][:, None]
            n_blk = ((1.0 - u_blk - v_blk) * nrm_blk[j, 0] + u_blk * nrm_blk[j, 1]
                     + v_blk * nrm_blk[j, 2])
            fn_blk = _cross(e1[j], e2[j])
            better = t_blk < best_t
            best_t = torch.where(better, t_blk, best_t)
            best_n = torch.where(better[:, None], n_blk, best_n)
            best_fn = torch.where(better[:, None], fn_blk, best_fn)
        valid = torch.isfinite(best_t)

        def normalize(x):
            return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

        points = o + d * torch.where(valid, best_t, torch.zeros_like(best_t))[:, None]
        return (best_t.reshape(batch_shape), points.reshape(batch_shape + (3,)),
                normalize(best_n).reshape(batch_shape + (3,)),
                normalize(best_fn).reshape(batch_shape + (3,)), valid.reshape(batch_shape))


def compute_vertex_normals(vertices, faces):
    """Area-weighted vertex normals (numpy, at construction): each face's
    cross product, whose length is twice its area, summed at its vertices."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(vertices[faces[:, 1]] - vertices[faces[:, 0]],
                  vertices[faces[:, 2]] - vertices[faces[:, 0]])
    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    return vn.astype(np.float32)


def load_obj(path, device="cpu"):
    """A Wavefront OBJ's ``v``, ``vn`` and ``f`` records as a TriangleMesh on
    `device`. Faces index as ``v``, ``v/vt``, ``v//vn`` or ``v/vt/vn``,
    negative (relative) indices included; polygons are fanned into
    triangles. The file's normals are kept where its normal indexing is
    vertex-aligned (each face corner's normal index equal to its vertex
    index, and at least as many normals as vertices); otherwise the normals
    are recomputed area-weighted."""
    verts, norms, faces, face_norm_ids = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx, nidx = [], []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = int(fields[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(fields) >= 3 and fields[2]:
                        ni = int(fields[2])
                        nidx.append(ni - 1 if ni > 0 else len(norms) + ni)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if len(nidx) == len(idx):
                        face_norm_ids.append([nidx[0], nidx[k], nidx[k + 1]])
    vertices = np.asarray(verts, np.float32)
    faces_arr = np.asarray(faces, np.int64).reshape(-1, 3)
    vertex_normals = None
    if norms and len(face_norm_ids) == len(faces):
        aligned = all(n == i for tri, ntri in zip(faces, face_norm_ids)
                      for i, n in zip(tri, ntri))
        if aligned and len(norms) >= len(verts):
            vertex_normals = np.asarray(norms, np.float32)[:len(verts)]
    return TriangleMesh(vertices, faces_arr, vertex_normals, device=device)
