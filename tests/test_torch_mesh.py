"""The triangle mesh (`ops/mesh.py`) and the sampler's mesh shortcut against
the JAX package on the CPU: `load_obj`, `intersect`, `Dataset.reload_mesh`,
the narrow flagship cache under `mesh=` (with `use_mesh` on and off) and
the narrow flagship material model under `mesh=`; and JAX's quirk that the
trainer never hands the dataset's mesh to the model.

Tolerances (float32):
- `load_obj`: vertices, faces and vertex normals equal (the same parse and
  the same float64 area weighting).
- `intersect`: t and the hit points to 1e-5 relative, both normals to 1e-5
  absolute, `valid` equal; the grazing rays through shared and outer edges
  of a quad whose coordinates are small dyadic numbers are exact in both.
- The cache forward and step: rgb to 1e-5, every loss term to 1e-5
  relative, and each gradient leaf to a relative L2 of 1e-3 (a wrong term
  is off by O(1)); a leaf the mesh path never reaches (under `use_mesh` the
  proposal MLPs and the density head) is zero in JAX and has no gradient
  in the port.
- The material forward: the renders and material outputs as
  `test_torch_material_slice.py` holds them (1e-4 / 1e-5), per-secondary-ray
  statistics to 1e-3 / 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cache_slice as cache_slice
import test_torch_material_slice as material_slice
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import mesh as jmesh
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.ops import mesh as tmesh
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import weights


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    trainer_test.jgin.clear_config()
    trainer_test.tgin.clear_config()


def icosphere(subdivisions=1, radius=1.0, center=(0.0, 0.0, 0.0)):
    """A triangulated icosphere: vertices [V, 3], faces [F, 3] (outward)."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        mid, new_faces = {}, []

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts) * radius + np.asarray(center)
    return v.astype(np.float32), np.asarray(faces, np.int64)


def write_obj(path, vertices, faces, normals=None, style="v"):
    """An OBJ of `faces` in the given index style ("v", "v/vt", "v//vn",
    "v/vt/vn", or "neg": relative indices)."""
    with open(path, "w") as f:
        f.write("# test mesh\n")
        for v in vertices:
            f.write("v %r %r %r\n" % tuple(float(x) for x in v))
        if normals is not None:
            for n in normals:
                f.write("vn %r %r %r\n" % tuple(float(x) for x in n))
        f.write("vt 0 0\n")
        nv = len(vertices)
        for face in faces:
            tok = {"v": lambda i: f"{i + 1}", "v/vt": lambda i: f"{i + 1}/1",
                   "v//vn": lambda i: f"{i + 1}//{i + 1}",
                   "v/vt/vn": lambda i: f"{i + 1}/1/{i + 1}",
                   "neg": lambda i: f"{i - nv}//{i - nv}"}[style]
            f.write("f " + " ".join(tok(int(i)) for i in face) + "\n")
    return path


def scene_mesh():
    """An icosphere of radius 0.55 at the origin (the sphere scene's big
    sphere, 80 faces) and a 2 x 2 quad at z = 3 whose diagonal runs from
    (-1, -1) to (1, 1)."""
    v, f = icosphere(1, 0.55)
    quad_v = np.array([[-1, -1, 3], [1, -1, 3], [1, 1, 3], [-1, 1, 3]], np.float32)
    quad_f = np.array([[0, 2, 1], [0, 3, 2]]) + len(v)
    return np.concatenate([v, quad_v]), np.concatenate([f, quad_f])


def _rays():
    """Rays that hit the sphere, miss everything, and graze the quad's
    shared diagonal and its outer edges (exactly), with unnormalised
    directions."""
    rng = np.random.RandomState(0)
    targets = rng.uniform(-0.8, 0.8, (64, 3))
    origins = rng.normal(size=(64, 3))
    origins = 3.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = (targets - origins) * rng.uniform(0.5, 2.0, (64, 1))
    edge_o = np.array([[a, a, 0.0] for a in (-0.5, 0.5, 0.75, 1.0)]
                      + [[1.0, 0.25, 0.0], [-1.0, -0.5, 0.0], [0.25, 1.0, 0.0],
                         [1.25, 0.0, 0.0], [0.0, -1.25, 0.0]])
    edge_o[:, :2] += 0.0
    edge_o += np.array([0.0, 0.0, -4.0])
    edge_d = np.tile([0.0, 0.0, 2.0], (len(edge_o), 1))
    return (np.concatenate([origins, edge_o]).astype(np.float32),
            np.concatenate([dirs, edge_d]).astype(np.float32))


@pytest.mark.parametrize("chunk", [512, 16, 7])
def test_intersect_equals_jax(chunk):
    """`intersect` on the sphere and the quad, over whole, even and ragged
    chunks of triangles."""
    v, f = scene_mesh()
    o, d = _rays()
    want = jmesh.TriangleMesh(v, f).intersect(jnp.asarray(o), jnp.asarray(d), chunk=chunk)
    got = tmesh.TriangleMesh(v, f).intersect(torch.as_tensor(o), torch.as_tensor(d),
                                             chunk=chunk)
    t_w, p_w, n_w, fn_w, valid_w = (np.asarray(x) for x in want)
    t_g, p_g, n_g, fn_g, valid_g = (x.numpy() for x in got)
    np.testing.assert_array_equal(valid_g, valid_w)
    assert 0 < valid_g.sum() < len(valid_g)
    np.testing.assert_allclose(t_g, t_w, rtol=1e-5)
    np.testing.assert_allclose(p_g, p_w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n_g, n_w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fn_g, fn_w, rtol=0, atol=1e-5)
    # The grazing rays: the diagonal and the outer edges hit at t = 3.5 (the
    # doubled direction), the two beyond the edges miss.
    np.testing.assert_array_equal(valid_g[64:], [True] * 7 + [False] * 2)
    np.testing.assert_array_equal(t_g[64:71], 3.5)


def test_intersect_batch_shape_and_device():
    """A [2, 3, ...] batch keeps its shape, and the tensors stay on the
    mesh's device."""
    v, f = scene_mesh()
    o, d = _rays()
    mesh = tmesh.TriangleMesh(v, f, device="cpu")
    out = mesh.intersect(torch.as_tensor(o[:6]).reshape(2, 3, 3),
                         torch.as_tensor(d[:6]).reshape(2, 3, 3))
    assert [tuple(x.shape) for x in out] == [(2, 3), (2, 3, 3), (2, 3, 3), (2, 3, 3), (2, 3)]
    assert mesh.device.type == "cpu" and mesh.num_faces == len(f)


OBJ_STYLES = ["v", "v/vt", "v//vn", "v/vt/vn", "neg"]


@pytest.mark.parametrize("style", OBJ_STYLES)
@pytest.mark.parametrize("normals", ["aligned", "not aligned", "none"])
def test_load_obj_equals_jax(style, normals, tmp_path):
    """Triangles and fanned polygons (a quad and a pentagon) in each index
    style; the file's normals kept where they are vertex-aligned and
    recomputed area-weighted otherwise."""
    v, f = icosphere(1, 0.8, (0.1, -0.2, 0.3))
    poly_v = np.array([[2, 0, 0], [3, 0, 0], [3.5, 1, 0], [2.5, 1.8, 0], [1.6, 1, 0]],
                      np.float32)
    verts = np.concatenate([v, poly_v])
    faces = [list(face) for face in f] + [[len(v) + i for i in range(5)],
                                           [len(v) + i for i in (0, 1, 2, 3)]]
    n = {"aligned": verts / np.linalg.norm(verts, axis=-1, keepdims=True),
         "not aligned": np.tile([[0.0, 0.0, 1.0]], (2, 1)), "none": None}[normals]
    if normals == "none" and style in ("v//vn", "v/vt/vn", "neg"):
        style = "v/vt"
    path = write_obj(str(tmp_path / "m.obj"), verts, faces, n, style)
    if normals == "not aligned":
        # Two normals only: the faces' normal indices run past them.
        text = open(path).read().replace("//", "/1/") if "vn" in style or style == "neg" else \
            open(path).read()
        open(path, "w").write(text)
    want = jmesh.load_obj(path)
    got = tmesh.load_obj(path)
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(want.faces))
    np.testing.assert_array_equal(got.vertex_normals.numpy(), np.asarray(want.vertex_normals))
    assert got.num_faces == len(f) + 3 + 2


def test_reload_mesh_loads_the_meshfile(tmp_path):
    """`Config.meshfile` loads onto the dataset's device in every loader,
    as the JAX loader loads it."""
    v, f = scene_mesh()
    path = write_obj(str(tmp_path / "scene.obj"), v, f)
    kw = dict(batch_size=16, num_dataset_images=2, meshfile=path)
    want = jdatasets.SyntheticSpheres("train", None, JConfig(**kw), resolution=8)
    got = tdatasets.SyntheticSpheres("train", None, TConfig(**kw), resolution=8, device="cpu")
    assert isinstance(got.mesh, tmesh.TriangleMesh) and got.mesh.device.type == "cpu"
    np.testing.assert_array_equal(got.mesh.faces.numpy(), np.asarray(want.mesh.faces))
    np.testing.assert_array_equal(got.mesh.vertex_normals.numpy(),
                                  np.asarray(want.mesh.vertex_normals))
    plain = tdatasets.SyntheticSpheres("train", None, TConfig(batch_size=16,
                                                              num_dataset_images=2),
                                       resolution=8, device="cpu")
    assert plain.mesh is None


# --- the cache under mesh= ------------------------------------------------------------------


def _jax_forward_with_mesh(self, rays, train_frac, mesh, use_mesh):
    """`cache_slice.jax_forward` with the mesh handed to the sampler."""
    sampler = self.sampler(rng=None, rays=rays, train_frac=train_frac, train=True,
                           sampling_strategy=self.train_sampling_strategy, use_raydist_fn=True,
                           is_secondary=False, compute_extras=False, mesh=mesh,
                           use_mesh=use_mesh)
    filtered, _ = self.maybe_resample(rng=None, resample=False, sampler_results=sampler[-1],
                                      num_resample=1)
    shader = self.shader(rng=None, rays=rays, sampler_results=filtered,
                         filtered_sampler_results=filtered, train_frac=train_frac, train=True,
                         is_secondary=False, compute_extras=False)
    shader.setdefault("weights_no_filter", shader["weights"])
    render = self.integrator(rng=None, rays=rays, shader_results=shader, bg_intensity_range=None,
                             train_frac=train_frac, train=True, is_secondary=False,
                             compute_extras=False)
    main = dict(loss_weight=1.0, sampler=sampler, filtered_sampler_inds=None, shader=shader,
                geometry=sampler[-1], integrator=render)
    return {"main": main, "render": render}


def _rel_l2(got, want):
    scale = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / max(scale, 1e-30)


MESH_CASES = [(True, False), (True, True), (False, False)]


@pytest.mark.parametrize("use_mesh,face_normals", MESH_CASES,
                         ids=["use_mesh", "use_mesh-face_normals", "annotated"])
def test_cache_step_with_mesh_equals_jax(use_mesh, face_normals):
    """The narrow flagship cache on a sphere-scene batch with the icosphere
    mesh: one surface sample per ray under `use_mesh` (the proposal levels
    skipped, the mesh's normals), or every level's samples annotated with
    the hit; rgb, the loss terms and every gradient leaf."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = cache_slice.build()
    jcfg.use_mesh_face_normals = tcfg.use_mesh_face_normals = face_normals
    v, f = scene_mesh()
    jm, tm = jmesh.TriangleMesh(v, f), tmesh.TriangleMesh(v, f)
    frac = cache_slice.TRAIN_FRAC

    def loss_fn(variables, batch):
        results = jmodel.apply(variables, batch.rays, frac, jm, use_mesh,
                               method=_jax_forward_with_mesh)
        losses, stats = {}, {}
        jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, frac, "main",
                                          losses, stats)
        geo = results["main"]["geometry"]
        return sum(jax.tree_util.tree_leaves(losses)), (losses, results["render"]["rgb"], geo)

    with jhash.xla_encoder_scope():
        (_, (jloss_terms, jrgb, jgeo)), jgrad = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables, jbatch)

    out = tmodel(None, tbatch.rays, train_frac=frac, train=True, compute_extras=False, mesh=tm,
                 use_mesh=use_mesh)
    np.testing.assert_allclose(out["render"]["rgb"].detach().numpy(), np.asarray(jrgb),
                               rtol=1e-5, atol=1e-5)
    geo = out["main"]["geometry"]
    if use_mesh:
        assert len(out["main"]["sampler"]) == 1 and geo["means"].shape[-2] == 1
        np.testing.assert_array_equal(geo["weights"].detach().numpy(), 1.0)
    else:
        for k in ("mesh_points", "mesh_normals", "t_to_nearest"):
            np.testing.assert_allclose(geo[k].detach().numpy(), np.asarray(jgeo[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    for k in ("means", "tdist") + (("normals_to_use", "normals") if use_mesh else ()):
        np.testing.assert_allclose(geo[k].detach().numpy(), np.asarray(jgeo[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    losses, stats = {}, {}
    ttrain._compute_losses_for_output(tbatch, tbatch.rays, out, tcfg, frac, "main", losses,
                                      stats)
    assert sorted(losses) == sorted(jloss_terms)
    for k, val in jloss_terms.items():
        np.testing.assert_allclose(float(losses[k]), float(val), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    sum(losses.values()).backward()
    jg = cache_slice._leaves(jlosses.clip_gradients(
        jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)["params"])
    ttrain.losses_lib.clip_gradients(tmodel, tcfg)
    params = dict(tmodel.named_parameters())
    unreached = set()
    for key, g in jg.items():
        g = material_slice._tr(key, g)
        p = params[key]
        if p.grad is None:
            unreached.add(key)
            np.testing.assert_array_equal(g, 0.0, err_msg=key)
            continue
        assert _rel_l2(p.grad.numpy(), g) < 1e-3, (key, _rel_l2(p.grad.numpy(), g))
    # Under the shortcut the proposal MLPs and the density head (the density
    # is the constant 1e5) are reached by no loss.
    mesh_only = {k for k in params if k.startswith(("sampler.mlps.0.", "sampler.mlps.1."))}
    mesh_only.add("sampler.mlps.2.output_density_layer.bias")
    assert (mesh_only <= unreached) == use_mesh


def test_material_forward_with_mesh_equals_jax():
    """The narrow flagship material model under `mesh=`: the primary rays
    take the mesh shortcut in the cache pass, the secondary rays start at
    their near point and take it in their cache queries."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = material_slice.build()
    v, f = scene_mesh()
    jm, tm = jmesh.TriangleMesh(v, f), tmesh.TriangleMesh(v, f)
    kw = dict(train_frac=material_slice.TRAIN_FRAC, train=True, compute_extras=False)

    def forward(variables, rays):
        out = jmodel.apply(variables, jax.random.PRNGKey(0), rays, mesh=jm, **kw)
        shader = out["main"]["shader"]
        return dict(rgb=out["render"]["rgb"], cache_rgb=out["render"]["cache_rgb"],
                    **{k: shader[k] for k in ("material_albedo", "material_roughness",
                                             "lighting_irradiance", "indirect_occ")})

    with material_slice.injected(11), jhash.xla_encoder_scope():
        jout = jax.jit(forward)(variables, jbatch.rays)
    with material_slice.injected(11), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, mesh=tm, **kw)
    render, shader = tout["render"], tout["main"]["shader"]
    for k, got in (("rgb", render["rgb"]), ("cache_rgb", render["cache_rgb"]),
                   ("material_albedo", shader["material_albedo"]),
                   ("material_roughness", shader["material_roughness"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(jout[k]), err_msg=k,
                                   **material_slice.FWD)
    for k in ("lighting_irradiance", "indirect_occ"):
        np.testing.assert_allclose(shader[k].numpy(), np.asarray(jout[k]), err_msg=k,
                                   **material_slice.SEC)
    assert tout["cache_main"]["sampler"][-1]["means"].shape[-2] == 1


def test_trainer_does_not_hand_the_mesh_to_the_model(tmp_path, monkeypatch):
    """As in JAX, a `Config.meshfile` loads the dataset's mesh but the
    trainer's step never passes it to the model: the step's losses equal
    those of the same step without the mesh, and the model is never called
    with one."""
    v, f = scene_mesh()
    path = write_obj(str(tmp_path / "scene.obj"), v, f)
    seen = []
    stats = {}
    for mesh_binding in ([], [f"Config.meshfile = '{path}'"]):
        tt = trainer_test.synthesize("torch", [trainer_test.SPHERES],
                                     trainer_test.TINY + mesh_binding, "cache")
        tt._setup_rng()
        tt._load_datasets()
        tt._setup_model()
        forward = tt.model.forward

        def spy(*args, _forward=forward, **kwargs):
            seen.append(kwargs.get("mesh"))
            return _forward(*args, **kwargs)

        monkeypatch.setattr(tt.model, "forward", spy)
        assert (tt.dataset.mesh is not None) == bool(mesh_binding)
        with material_slice.injected(7):
            _, out = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), 0.0)
        stats[bool(mesh_binding)] = {k: float(val) for k, val in out["losses"].items()}
    assert seen and all(m is None for m in seen)
    assert stats[True] == stats[False]
    jt = trainer_test.synthesize("jax", [trainer_test.SPHERES],
                                 trainer_test.TINY + [f"Config.meshfile = '{path}'"], "cache")
    jdata = jdatasets.load_dataset("train", None, jt.config)
    assert jdata.mesh is not None and jconstruct is not None
    assert os.path.exists(path)
