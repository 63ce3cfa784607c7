"""The sampling options of the port's models against the JAX package on the
same numpy-seeded inputs, weights carried across and one numpy stream
feeding both packages' random draws: DensityMLP under each of its options,
the SampleNetwork, the ProposalVolumeSampler's near anneal, sample
network, radii, density filters and weight normalisations, the
integrators' random backgrounds, colour network and normalised weights,
the weight converter's new parameters; then one narrow flagship cache step
under option set A (julier with a Cholesky root and a scale-aware grid
query, the covariance options, the feature filter on primary rays with its
far field, density noise, corrected and offset normals, glorot_uniform
init, the near anneal, the normal / far-field / uniform radii, the sample
network, the "piecewise" ray warp, a random background with the colour
network, and Config.volume_variate), one narrow material step under set B
(the secondary-ray filters, the uniform radius with
normalize_uniform_weights on the secondary rays, the backfacing near
filter, volume_variate_secondary and volume_variate_material), and one
narrow cache step with a triplane and one with a TensoRF appearance grid,
through both packages' losses.

normalize_uniform_weights spreads each ray's missing mass over its samples
beyond the radius, so every such ray's opacity sums to exactly 1: the kink
of the background weight max(0, 1 - opacity). There a one-ulp difference
in the summed opacity (another summation order) flips the gradient of a
primary ray's render between -1, -0.5 and 0 times the background, in JAX
against itself as much as against the port. So the option is held on the
secondary rays of set B (black background, no kink) and by the sampler
test, not in set A's cache step.

Tolerances (float32):
- Module outputs: rtol 1e-5, atol 1e-6 (the same ops in the same order);
  outputs of a chain of levels (the sampler) rtol 1e-4, atol 1e-5.
- Gradients: rtol 1e-3 with an atol of 1e-4 x the leaf's largest entry
  (sums in another order whose terms cancel; a wrong term is O(1)).
- The steps: every loss term to 1e-4 relative, every gradient leaf to a
  relative L2 of 1e-3 (the material step's secondary-ray leaves to 1e-2:
  a 1e-5 move of a surface normal turns a GGX direction, as in
  tests/test_torch_material_slice.py).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_torch_cache_slice as cache_slice
import test_torch_material_slice as material_slice
from test_torch_encoder_options import injected
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.engine.configs import Config as JConfig
from neural_radiance_caching_tpu.models import geometry as jgeometry
from neural_radiance_caching_tpu.models import integrator as jintegrator
from neural_radiance_caching_tpu.models import sample_net as jsample_net
from neural_radiance_caching_tpu.models import sampler as jsampler
from neural_radiance_caching_tpu.models.nerf_model import NeRFModel as JNeRFModel
from neural_radiance_caching_tpu.ops import coord as jcoord
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets as tdatasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.engine.configs import Config as TConfig
from neural_radiance_caching_tpu_torch.models import geometry as tgeometry
from neural_radiance_caching_tpu_torch.models import integrator as tintegrator
from neural_radiance_caching_tpu_torch.models import sample_net as tsample_net
from neural_radiance_caching_tpu_torch.models import sampler as tsampler
from neural_radiance_caching_tpu_torch.ops import coord as tcoord
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

VAL = dict(rtol=1e-5, atol=1e-6)
CHAIN = dict(rtol=1e-4, atol=1e-5)
TRAIN_FRAC = 0.5


def _close_grad(actual, desired, err_msg="", rtol=1e-3, atol_frac=1e-4):
    desired = np.asarray(desired)
    scale = max(float(np.abs(desired).max()), 1e-30)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol_frac * scale,
                               err_msg=err_msg)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)) / max(float(np.linalg.norm(want)), 1e-30)


RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "lights", "imageplane", "look", "up",
              "cam_origins", "vcam_look", "vcam_up", "vcam_origins", "lossmult", "near", "far",
              "cam_idx", "light_idx")


def _rays(seed, n=6):
    """The same rays in both packages: (jax Rays, port Rays, numpy dict)."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    look = rng.normal(size=(n, 3))
    look /= np.linalg.norm(look, axis=-1, keepdims=True)
    up = np.cross(look, rng.normal(size=(n, 3)))
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    o = rng.uniform(-1.5, 1.5, (n, 3))
    f = dict(origins=o, directions=d, viewdirs=d, radii=rng.uniform(1e-3, 1e-2, (n, 1)),
             lights=o + 1.0, imageplane=np.zeros((n, 2)), look=look, up=up,
             cam_origins=o - 0.5 * look, vcam_look=look, vcam_up=up, vcam_origins=o,
             lossmult=np.ones((n, 1)), near=rng.uniform(0.05, 0.3, (n, 1)),
             far=rng.uniform(3.0, 5.0, (n, 1)))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["cam_idx"] = rng.randint(0, 3, (n, 1)).astype(np.int32)
    f["light_idx"] = np.zeros((n, 1), np.int32)
    jr = jpytrees.Rays(**{k: jnp.asarray(f[k]) for k in RAY_FIELDS})
    tr = tpytrees.Rays(**{k: torch.as_tensor(f[k]) for k in RAY_FIELDS})
    return jr, tr, f


def _gaussians(seed, rays, s=5):
    """Cone Gaussians along each ray over sorted distances (numpy)."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(0.3, 3.5, (rays["origins"].shape[0], s + 1)), -1).astype(np.float32)
    means, covs = jcoord_cast(t, rays)
    return t, np.asarray(means), np.asarray(covs)


def jcoord_cast(t, rays):
    from neural_radiance_caching_tpu.ops import render as jrender

    return jrender.cast_rays(jnp.asarray(t), jnp.asarray(rays["origins"]),
                             jnp.asarray(rays["directions"]), jnp.asarray(rays["radii"]), "cone",
                             diag=False)


def _variables(module_init, seed, scale=0.5):
    shapes = jax.eval_shape(module_init)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda sh: rng.uniform(-scale, scale, sh.shape).astype(np.float32), shapes)


def _pair(jmodule, tmodule, init, seed, scale=0.5, owner=None):
    """Random JAX variables for `jmodule`, carried into `tmodule`. `owner`:
    the JAX module name the converter reads the tree under (a module whose
    parameter names depend on its owner), e.g. "SampleNetwork"."""
    variables = _variables(init, seed, scale)
    if owner is None:
        tmodule.load_state_dict(weights.state_dict_from_jax(variables, tmodule))
    else:
        holder = torch.nn.Module()
        holder.add_module(weights.torch_key((owner,)), tmodule)
        holder.load_state_dict(weights.state_dict_from_jax({owner: variables["params"]}, holder))
    return variables


def _jleaves(tree, owner=None):
    """A JAX parameter tree's leaves by the port's state_dict key (read
    under `owner`, as _pair carries them)."""
    if owner is None:
        return cache_slice._leaves(tree)
    prefix = weights.torch_key((owner,)) + "."
    return {k[len(prefix):]: v for k, v in cache_slice._leaves({owner: tree}).items()}


# --- models/geometry: DensityMLP ------------------------------------------------------------

GRID = dict(hash_map_size=4096, max_grid_size=64, min_grid_size=8, num_features=4,
            scale_supersample=1.0, interpolation="simplex", bbox_scaling=2.0)
BASE_MLP = dict(net_depth=2, net_width=16, disable_density_normals=True, grid_params=GRID)

DENSITY_CASES = {
    "noise": dict(density_noise=0.5),
    "corrected_offset_normals": dict(enable_pred_normals=True, use_corrected_normals=True,
                                     enable_normals_offset=True, disable_density_normals=False),
    "covariances_ipe": dict(use_grid=False, isotropize_gaussians=True,
                            gaussian_covariance_scale=2.0, gaussian_covariance_pad=0.01,
                            warp_fn="contract_radius_2"),
    "julier_cholesky_scale": dict(unscented_mip_basis="julier", unscented_sqrt_fn="cholesky",
                                  unscented_scale_mult=0.5, warp_fn="contract_radius_2"),
    "octahedron_sqrtm_contract": dict(unscented_mip_basis="octahedron_1",
                                      unscented_scale_mult=0.5, warp_fn="contract"),
    "hexify": dict(unscented_mip_basis="hexify", warp_fn="contract_radius_2"),
    "feature_filter_far_field": dict(use_feature_filter=True,
                                     use_feature_filter_secondary_only=False,
                                     use_feature_filter_far_field=True, feature_filter_radius=1.5,
                                     feature_filter_size=16, warp_fn="contract_radius_2"),
    "squash_before": dict(squash_before=True, warp_fn="contract_radius_2"),
    "backfacing_near": dict(enable_pred_normals=True, use_backfacing_near=True,
                            backfacing_target="normals_to_use", backfacing_near=1.5),
    "glorot_normal": dict(weight_init="glorot_normal", enable_pred_normals=True),
}


def _fns(opts, pkg):
    coord = jcoord if pkg == "jax" else tcoord
    out = dict(opts)
    if "warp_fn" in out:
        out["warp_fn"] = getattr(coord, out["warp_fn"])
    return out


@pytest.mark.parametrize("case", sorted(DENSITY_CASES))
def test_density_mlp_options_match_jax(case):
    """One DensityMLP call per option (secondary rays for the backfacing
    filter): every output, and the gradient of a projection of the
    density, feature and normals to every parameter."""
    opts = DENSITY_CASES[case]
    secondary = case == "backfacing_near"
    jr, tr, f = _rays(1)
    t, means, covs = _gaussians(2, f)
    jcfg, tcfg = JConfig(), TConfig()
    jm = jgeometry.DensityMLP(config=jcfg, **{**BASE_MLP, **_fns(opts, "jax")})
    tm = tgeometry.DensityMLP(config=tcfg, **{**BASE_MLP, **_fns(opts, "torch")})
    kw = dict(tdist=jnp.asarray(t), train_frac=TRAIN_FRAC, is_secondary=secondary)
    gauss = (jnp.asarray(means), jnp.asarray(covs))
    variables = _pair(jm, tm, lambda: jm.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jr,
                                              gauss, **kw), 3)
    keys = ("density", "feature", "normals", "normals_pred", "normals_to_use", "normals_shading")
    rng = np.random.RandomState(4)

    def project(out, lib):
        total = 0.0
        for k in keys:
            if out.get(k) is not None:
                r = rng_proj[k]
                total = total + (out[k] * (jnp.asarray(r) if lib == "jax" else
                                           torch.as_tensor(r))).sum()
        return total

    with injected(5), jhash.xla_encoder_scope():
        jout = jax.jit(lambda v: jm.apply(v, jax.random.PRNGKey(2), jr, gauss, **kw))(variables)
    rng_proj = {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in jout.items()
                if k in keys and v is not None}
    with injected(5), jhash.xla_encoder_scope():
        jg = jax.jit(jax.grad(lambda v: project(
            jm.apply(v, jax.random.PRNGKey(2), jr, gauss, **kw), "jax")))(variables)
    with injected(5):
        tout = tm(torch.Generator(), tr, (torch.as_tensor(means), torch.as_tensor(covs)),
                  tdist=torch.as_tensor(t), train_frac=TRAIN_FRAC, is_secondary=secondary)
    for k in keys:
        assert (tout[k] is None) == (jout[k] is None), k
        if tout[k] is not None:
            np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), err_msg=k,
                                       **CHAIN)
    project(tout, "torch").backward()
    jleaves = cache_slice._leaves(jg["params"])
    for key, p in tm.named_parameters():
        g = material_slice._tr(key, jleaves[key])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        _close_grad(got, g, err_msg=key)
    if case == "backfacing_near":
        assert float((tout["density"] == 0).float().mean()) > 0
    if case == "glorot_normal":
        fresh = tgeometry.DensityMLP(config=tcfg, **{**BASE_MLP, **opts})
        assert fresh.output_density_layer.kernel_init == "glorot_normal"
        assert all(layer.kernel_init == "glorot_normal"
                   for layer in fresh.density_layers.children())


def test_density_mlp_on_triplane_raises_as_in_jax():
    """JAX's DensityMLP hands its grid the feature filter's arguments, which
    the triplane and factored grids do not take: both raise TypeError."""
    jr, tr, f = _rays(1)
    t, means, covs = _gaussians(2, f)
    opts = dict(BASE_MLP, grid_representation="triplane", grid_params=dict(grid_size=8))
    jm = jgeometry.DensityMLP(config=JConfig(), **opts)
    with pytest.raises(TypeError, match="feature_filter"):
        jm.init(jax.random.PRNGKey(0), None, jr, (jnp.asarray(means), jnp.asarray(covs)),
                tdist=jnp.asarray(t))
    tm = tgeometry.DensityMLP(config=TConfig(), **opts)
    with pytest.raises(TypeError, match="feature_filter"):
        tm(None, tr, (torch.as_tensor(means), torch.as_tensor(covs)), tdist=torch.as_tensor(t))


# --- models/sample_net ----------------------------------------------------------------------


@pytest.mark.parametrize("use_time,contract", [(False, False), (True, True)])
def test_sample_network_matches_jax(use_time, contract):
    """The eased offsets at train_frac 0.25 of a window of 0.5, with and
    without the time input and a contraction, and their gradients."""
    rng = np.random.RandomState(6)
    kw = dict(window_frac=0.5, num_views=3, use_time=use_time, mlp_width=16, mlp_depth=3)
    jkw, tkw = dict(kw), dict(kw)
    if contract:
        jkw.update(contract_fn=jcoord.contract, inv_contract_fn=jcoord.inv_contract)
        tkw.update(contract_fn=tcoord.contract, inv_contract_fn=tcoord.inv_contract)
    jm, tm = jsample_net.SampleNetwork(**jkw), tsample_net.SampleNetwork(**tkw)
    pts = rng.uniform(-1.5, 1.5, (20, 3)).astype(np.float32)
    orig = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    vd = rng.normal(size=(20, 3)).astype(np.float32)
    tid = rng.randint(0, 3, (20, 1)).astype(np.float32)
    args = [jnp.asarray(a) for a in (pts, orig, vd, tid)]
    variables = _pair(jm, tm, lambda: jm.init(jax.random.PRNGKey(0), 0.25, *args), 7, 0.3,
                      owner="SampleNetwork")
    r = rng.normal(size=(20, 3)).astype(np.float32)
    jout = jm.apply(variables, 0.25, *args)
    jg = jax.grad(lambda v: jnp.sum(jm.apply(v, 0.25, *args)["point_offset"] * r))(variables)
    tout = tm(0.25, *(torch.as_tensor(a) for a in (pts, orig, vd, tid)))
    for k in ("point_offset", "point_offset_contract"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]), err_msg=k,
                                   **CHAIN)
    (tout["point_offset"] * torch.as_tensor(r)).sum().backward()
    jleaves = _jleaves(jg["params"], "SampleNetwork")
    for key, p in tm.named_parameters():
        _close_grad(p.grad.numpy(), material_slice._tr(key, jleaves[key]), err_msg=key)
    o, d = rng.normal(size=(9, 3)).astype(np.float32), rng.normal(size=(9, 3)).astype(np.float32)
    for a, b in zip(tsample_net.intersect_sphere(torch.as_tensor(o), torch.as_tensor(d), 1.2),
                    jsample_net.intersect_sphere(jnp.asarray(o), jnp.asarray(d), 1.2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL)
    np.testing.assert_allclose(tsample_net.pluecker(torch.as_tensor(o), torch.as_tensor(d)).numpy(),
                               np.asarray(jsample_net.pluecker(jnp.asarray(o), jnp.asarray(d))),
                               **VAL)


# --- models/sampler -------------------------------------------------------------------------

SAMPLER_MLP = dict(net_depth=2, net_width=16, disable_density_normals=True,
                   enable_pred_normals=True)
SAMPLER_CASES = {
    "near_anneal_normalize": dict(near_anneal_rate=0.8, normalize_weights=True),
    "disable_integration_piecewise": dict(disable_integration=True, raydist_fn="piecewise"),
    "sample_network_reciprocal": dict(use_sample_network=True, raydist_fn="reciprocal"),
    "radii_uniform": dict(use_normal_radius=True, normal_radius=1.0, use_far_field_radius=True,
                          far_field_radius=1.5, use_uniform_radius=True, uniform_radius=1.2,
                          use_uniform_radius_secondary_only=False,
                          normalize_uniform_weights=True),
    "secondary_filters": dict(use_vertical_filter=True, vertical_fov=0.6,
                              use_horizontal_filter=True, horizontal_fov=0.7,
                              use_backwards_filter=True, use_density_radius=True,
                              density_radius=2.5, use_uniform_radius=True, uniform_radius=1.5),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_options_match_jax(case):
    """Three levels (IPE proposal, grid final) under each option (secondary
    rays for the filters): each level's weights, samples and density, and
    the gradient of a projection of the final weights and normals."""
    opts = dict(SAMPLER_CASES[case])
    secondary = case == "secondary_filters"
    jr, tr, f = _rays(8, n=5)
    raydist = opts.pop("raydist_fn", None)
    jfn = {"reciprocal": jnp.reciprocal}.get(raydist, raydist)
    tfn = {"reciprocal": torch.reciprocal}.get(raydist, raydist)
    prop = dict(SAMPLER_MLP, use_grid=False, max_deg_point=4)
    final = dict(SAMPLER_MLP)
    kw = dict(sampling_strategy=((0, 0, 6), (0, 0, 6), (1, 1, 5)), dilation_bias=0.0025,
              dilation_multiplier=0.5, grid_params_per_level=(None, GRID), **opts)
    jcfg, tcfg = JConfig(), TConfig()
    jm = jsampler.ProposalVolumeSampler(config=jcfg, mlp_params_per_level=(prop, final),
                                        raydist_fn=jfn, **kw)
    tm = tsampler.ProposalVolumeSampler(config=tcfg, mlp_params_per_level=(prop, final),
                                        raydist_fn=tfn, **kw)
    call = dict(train_frac=TRAIN_FRAC, train=True, is_secondary=secondary)
    variables = _pair(jm, tm, lambda: jm.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jr,
                                              **call), 9)
    rng = np.random.RandomState(10)

    with injected(11), jhash.xla_encoder_scope():
        jhist = jax.jit(lambda v: jm.apply(v, jax.random.PRNGKey(2), jr, **call))(variables)
    r_w = rng.normal(size=np.shape(jhist[-1]["weights"])).astype(np.float32)
    r_n = rng.normal(size=np.shape(jhist[-1]["normals_to_use"])).astype(np.float32)

    def jproj(v):
        h = jm.apply(v, jax.random.PRNGKey(2), jr, **call)
        return jnp.sum(h[-1]["weights"] * r_w) + jnp.sum(h[-1]["normals_to_use"] * r_n)

    with injected(11), jhash.xla_encoder_scope():
        jg = jax.jit(jax.grad(jproj))(variables)
    with injected(11):
        thist = tm(torch.Generator(), tr, **call)
    assert len(thist) == len(jhist)
    for level, (th, jh) in enumerate(zip(thist, jhist)):
        for k in ("tdist", "sdist", "weights", "density", "means", "points"):
            np.testing.assert_allclose(th[k].detach().numpy(), np.asarray(jh[k]),
                                       err_msg=f"level {level} {k}", **CHAIN)
    ((thist[-1]["weights"] * torch.as_tensor(r_w)).sum()
     + (thist[-1]["normals_to_use"] * torch.as_tensor(r_n)).sum()).backward()
    jleaves = cache_slice._leaves(jg["params"])
    for key, p in tm.named_parameters():
        g = material_slice._tr(key, jleaves[key])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        _close_grad(got, g, err_msg=key)
    if case == "secondary_filters":
        assert float((thist[-1]["density"] == 0).float().mean()) > 0


# --- models/integrator ----------------------------------------------------------------------


@pytest.mark.parametrize("color_net", [False, True])
@pytest.mark.parametrize("bg", [(1.0, 1.0), (0.0, 1.0)])
def test_integrator_background_and_color_net_match_jax(bg, color_net):
    """A random background (its normal draw, the bg_noise it reports and
    takes out of the rgb) and the colour network, with and without a
    generator; the colour network's gradients."""
    jr, tr, f = _rays(12, n=7)
    rng = np.random.RandomState(13)
    s = 6
    sr = dict(rgb=rng.uniform(size=(7, s, 3)), weights=rng.uniform(0, 0.3, (7, s)),
              tdist=np.sort(rng.uniform(0, 4, (7, s + 1)), -1))
    sr = {k: v.astype(np.float32) for k, v in sr.items()}
    sr["weights_no_filter"] = sr["weights"]
    kw = dict(bg_intensity_range=bg, use_color_net=color_net, net_depth=3, net_width=16,
              skip_layer=1)
    jcfg, tcfg = JConfig(), TConfig()
    jm, tm = jintegrator.VolumeIntegrator(config=jcfg, **kw), \
        tintegrator.VolumeIntegrator(config=tcfg, **kw)
    jsr = {k: jnp.asarray(v) for k, v in sr.items()}
    variables = _pair(jm, tm, lambda: jm.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jr,
                                              dict(jsr)), 14, 0.3, owner="Integrator") \
        if color_net else {}
    for with_rng in (False, True):
        with injected(15):
            jout = jm.apply(variables, jax.random.PRNGKey(1) if with_rng else None, jr, dict(jsr))
        with injected(15):
            tout = tm(torch.Generator() if with_rng else None, tr,
                      {k: torch.as_tensor(v) for k, v in sr.items()})
        assert ("bg_noise" in tout) == ("bg_noise" in jout) == (with_rng and bg[0] != bg[1])
        for k in ("rgb", "acc", "bg_noise"):
            if k in jout:
                np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                           err_msg=k, **VAL)
    if color_net:
        r = rng.normal(size=(7, 3)).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(jm.apply(v, None, jr, dict(jsr))["rgb"] * r))(variables)
        (tm(None, tr, {k: torch.as_tensor(v) for k, v in sr.items()})["rgb"]
         * torch.as_tensor(r)).sum().backward()
        jleaves = _jleaves(jg["params"], "Integrator")
        for key, p in tm.named_parameters():
            _close_grad(p.grad.numpy(), material_slice._tr(key, jleaves[key]), err_msg=key)
    else:
        assert not list(tm.parameters())


@pytest.mark.parametrize("normalize", [False, True])
def test_geometry_integrator_matches_jax(normalize):
    rng = np.random.RandomState(16)
    s = 5
    res = dict(means=rng.normal(size=(4, s, 3)), covs=rng.normal(size=(4, s, 3, 3)),
               normals=rng.normal(size=(4, s, 3)), feature=rng.normal(size=(4, s, 8)),
               weights=rng.uniform(0, 0.3, (4, s)), tdist=np.sort(rng.uniform(0, 3, (4, s + 1))))
    res = {k: v.astype(np.float32) for k, v in res.items()}
    jout = jintegrator.GeometryVolumeIntegrator(config=JConfig(), normalize_weights=normalize).apply(
        {}, None, {k: jnp.asarray(v) for k, v in res.items()})
    tout = tintegrator.GeometryVolumeIntegrator(config=TConfig(), normalize_weights=normalize)(
        None, {k: torch.as_tensor(v) for k, v in res.items()})
    assert sorted(k for k, v in tout.items() if v is not None) == sorted(
        k for k, v in jout.items() if v is not None)
    for k, v in jout.items():
        if v is not None:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(v), err_msg=k, **VAL)


# --- the narrow steps -----------------------------------------------------------------------


def set_a(params, pkg):
    """Option set A on the narrow flagship cache params (edits common to both
    packages; `pkg` picks the warp functions)."""
    coord = jcoord if pkg == "jax" else tcoord
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(isotropize_gaussians=True, gaussian_covariance_scale=1.5,
                 gaussian_covariance_pad=1e-4, weight_init="glorot_uniform")
    mlps[2].update(unscented_mip_basis="julier", unscented_sqrt_fn="cholesky",
                   unscented_scale_mult=0.5, use_feature_filter=True,
                   use_feature_filter_secondary_only=False, use_feature_filter_far_field=True,
                   feature_filter_radius=1.0, feature_filter_size=32, density_noise=0.1,
                   use_corrected_normals=True, enable_normals_offset=True,
                   weight_init="glorot_uniform", warp_fn=coord.contract_radius_2)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp.update(near_anneal_rate=0.8, use_normal_radius=True, normal_radius=0.8,
              use_far_field_radius=True, far_field_radius=1.5, use_uniform_radius=True,
              uniform_radius=1.2, use_uniform_radius_secondary_only=False,
              use_sample_network=True, raydist_fn="piecewise")
    p["integrator_params"] = dict(bg_intensity_range=(0.0, 1.0), use_color_net=True,
                                  net_depth=2, net_width=16)
    return p


SET_A_CONFIG = dict(volume_variate=True, volume_variate_passes=["direct"])


def build_set_a(seed=0):
    jcfg = dataclasses.replace(bench._cache_config(), batch_size=cache_slice.BATCH,
                               lr_delay_steps=0, **SET_A_CONFIG)
    tcfg = flagship.cache_config(batch_size=cache_slice.BATCH, lr_delay_steps=0, **SET_A_CONFIG)
    jmodel = JNeRFModel(config=jcfg, **set_a(cache_slice.narrow(
        bench.flagship_cache_params(jcfg)), "jax"))
    tmodel = flagship.build_flagship_cache_model(
        tcfg, set_a(cache_slice.narrow(flagship.flagship_cache_params()), "torch"), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = cache_slice.jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                                   resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


@pytest.fixture
def narrow_sample_net():
    """The sample network at width 16 and depth 2 in both packages: the
    sampler builds it with its gin bindings, as JAX's does."""
    for gin in (jgin, tgin):
        gin.bind("SampleNetwork", "mlp_width", 16)
        gin.bind("SampleNetwork", "mlp_depth", 2)
    yield
    jgin.clear_config()
    tgin.clear_config()


def _jax_cache_step(jmodel, jcfg, variables, jbatch, draws):
    def loss_fn(v, batch):
        results = jmodel.apply(v, jax.random.PRNGKey(0), batch.rays, train_frac=TRAIN_FRAC,
                               train=True, compute_extras=False)
        losses, stats = {}, {}
        jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, TRAIN_FRAC,
                                          "main", losses, stats)
        return sum(jax.tree_util.tree_leaves(losses)), (losses, results["render"])

    with injected(draws), jhash.xla_encoder_scope():
        (total, (terms, render)), grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables, jbatch)
    return total, terms, render, grad


def _port_step(tmodel, tcfg, tbatch, draws, calls=None):
    state, _ = ttrain.create_optimizer(tcfg, tmodel)
    step = ttrain.create_train_step(tmodel, tcfg)
    with injected(draws), pytest.MonkeyPatch.context() as mp:
        if calls is not None:
            material_slice._counting_scatters(mp, calls)
        _, stats = step(torch.Generator().manual_seed(1), state, tbatch, TRAIN_FRAC)
    return stats


def _compare_leaves(tmodel, jgrad, jcfg, limit=1e-3, loose=(), loose_limit=1e-2):
    jg = cache_slice._leaves(jlosses.clip_gradients(
        jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)["params"])
    params = dict(tmodel.named_parameters())
    assert sorted(jg) == sorted(params)
    worst = {}
    for key, g in jg.items():
        g = material_slice._tr(key, g)
        p = params[key]
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        if not np.abs(g).max():
            np.testing.assert_array_equal(got, 0.0, err_msg=key)
            continue
        worst[key] = _rel_l2(got, g)
        bound = loose_limit if any(key.startswith(x) for x in loose) else limit
        assert worst[key] < bound, (key, worst[key])
    return worst


def test_set_a_cache_step_matches_jax(narrow_sample_net):
    """One narrow flagship cache step under option set A through both
    packages: the render, every loss term (bg_noise's among the data
    loss), every gradient leaf (the sample network's, the colour
    network's and the normals offset's among them); the final level's
    encoder backward takes one leveled scatter (4 x 7 julier points per
    ray below the planes threshold)."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build_set_a()
    jtotal, jterms, jrender, jgrad = _jax_cache_step(jmodel, jcfg, variables, jbatch, 21)
    assert "bg_noise" in jrender
    calls = []
    stats = _port_step(tmodel, tcfg, tbatch, 21, calls)
    assert sorted(stats["losses"]) == sorted(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(stats["loss"]), float(jtotal), rtol=1e-4)
    _compare_leaves(tmodel, jgrad, jcfg)
    # One encoder backward per chain: the main chain and the variate's two.
    assert calls == ["leveled"]
    for name in ("sampler.sample_net.output_layer.weight", "integrator.layer.0.weight",
                 "sampler.mlps.2.normals_offset_layer.weight"):
        assert dict(tmodel.named_parameters())[name].grad is not None, name


def test_set_a_forward_matches_jax(narrow_sample_net):
    """The set-A forward's render (rgb with the colour network and the
    background taken out, bg_noise) and its final level (the sample
    network's moved means, the radii) against JAX's."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build_set_a(seed=1)
    def forward(v, rays):
        return jmodel.apply(v, jax.random.PRNGKey(0), rays, train_frac=TRAIN_FRAC, train=True,
                            compute_extras=False)

    with injected(22), jhash.xla_encoder_scope():
        jout = jax.jit(forward)(variables, jbatch.rays)
    with injected(22), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True,
                      compute_extras=False)
    for k in ("rgb", "acc", "bg_noise"):
        np.testing.assert_allclose(tout["render"][k].numpy(), np.asarray(jout["render"][k]),
                                   err_msg=k, **CHAIN)
    for k in ("means", "points", "weights", "tdist", "normals_to_use"):
        np.testing.assert_allclose(tout["main"]["geometry"][k].numpy(),
                                   np.asarray(jout["main"]["geometry"][k]), err_msg=k, **CHAIN)


SET_B_CONFIG = dict(volume_variate_secondary=True, volume_variate_passes_secondary=["direct"])


def set_b(params):
    """Option set B on the narrow flagship material params."""
    p = copy.deepcopy(params)
    sp = p["cache_model_params"]["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    mlps[2].update(use_backfacing_near=True, backfacing_target="normals_to_use",
                   backfacing_near=0.3)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp.update(use_vertical_filter=True, vertical_fov=1.2, use_horizontal_filter=True,
              horizontal_fov=1.3, use_backwards_filter=True, use_uniform_radius=True,
              uniform_radius=1.5, normalize_uniform_weights=True)
    return p


def build_set_b(seed=0, **overrides):
    common = dict(batch_size=material_slice.BATCH, lr_delay_steps=0, secondary_far=4.0,
                  material_loss_radius=4.0, data_loss_type="rawnerf_unbiased",
                  use_gradient_debias=True, gradient_checkpointing=False,
                  distortion_loss_mult=0.0, predicted_normal_loss_mult=0.0,
                  predicted_normal_reverse_loss_mult=0.0, **{**SET_B_CONFIG, **overrides})
    jcfg = dataclasses.replace(bench._cache_config(), **common)
    tcfg = flagship.material_config(**common)
    jfull = bench.build_flagship_material_model(jcfg)
    jparams = set_b(material_slice.narrow_material(jfull.cache_model_params,
                                                   jfull.light_sampler_params,
                                                   jfull.shader_params))
    jmodel = jfull.clone(**jparams)
    tparams = flagship.flagship_material_params()
    tparams.update(material_slice.narrow_material(tparams["cache_model_params"],
                                                  tparams["light_sampler_params"],
                                                  tparams["shader_params"]))
    tmodel = flagship.build_flagship_material_model(tcfg, set_b(tparams), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, seed)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jdata = cache_slice.jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                                   resolution=16)
    tdata = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                       device="cpu")
    return jcfg, tcfg, jmodel, tmodel, variables, jdata.next_train(), tdata.next_train()


def test_set_b_material_step_matches_jax():
    """One narrow material step under option set B through both packages'
    losses (the gradient-debias pass included): every loss term and every
    gradient leaf; the secondary-ray filters zero some secondary density."""
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = build_set_b()
    with injected(31), jhash.xla_encoder_scope():
        (jtotal, (jterms, jout)), jgrad = material_slice.jax_loss(jmodel, jcfg)(variables,
                                                                               jbatch)
    with injected(31), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    np.testing.assert_allclose(tout["render"]["rgb"].numpy(), np.asarray(jout["rgb"]),
                               **material_slice.FWD)
    state, stats, calls = material_slice.run_port_step(tmodel, tcfg, tbatch, 31)
    assert sorted(stats["losses"]) == sorted(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    _compare_leaves(tmodel, jgrad, jcfg, limit=2e-3, loose=("cache.", "shader."))
    assert "planes" in calls


def test_steady_material_volume_variate_raises_as_in_jax():
    """Config.volume_variate_material on the steady material model: the
    material render's one-channel direct_rgb meets the cache's three, and
    the variate's reshape raises in JAX (at the model's first call) and in
    the port (at its first forward) alike."""
    with pytest.raises(TypeError, match="cannot reshape"):
        build_set_b(volume_variate_material=True)
    jcfg, tcfg, _, tmodel, _, _, tbatch = build_set_b()
    tcfg.volume_variate_material = True
    with pytest.raises(TypeError, match="direct_rgb"):
        tmodel(torch.Generator().manual_seed(0), tbatch.rays, train_frac=TRAIN_FRAC, train=True)


GRID_KINDS = {"triplane": dict(grid_size=16, num_features=8),
              "tensorf": dict(grid_size=12, num_features=8, num_components=4)}


@pytest.mark.parametrize("kind", sorted(GRID_KINDS))
def test_grid_representation_cache_step_matches_jax(kind):
    """The narrow flagship cache with a triplane or TensoRF appearance grid
    in its shader (beside the density feature): every loss term and
    gradient leaf; the grid's backward launches no scatter."""
    def with_grid(params):
        p = copy.deepcopy(params)
        p["shader_params"].update(use_grid=True, grid_representation=kind,
                                  grid_params=GRID_KINDS[kind])
        return p

    jcfg = bench._cache_config()
    jcfg.batch_size, jcfg.lr_delay_steps = cache_slice.BATCH, 0
    tcfg = flagship.cache_config(batch_size=cache_slice.BATCH, lr_delay_steps=0)
    jmodel = JNeRFModel(config=jcfg, **with_grid(cache_slice.narrow(
        bench.flagship_cache_params(jcfg))))
    tmodel = flagship.build_flagship_cache_model(
        tcfg, with_grid(cache_slice.narrow(flagship.flagship_cache_params())), device="cpu")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jpytrees.dummy_rays(4), train_frac=1.0,
        train=False))
    variables = material_slice.random_variables(shapes, 3)
    tmodel.load_state_dict(weights.state_dict_from_jax(variables, tmodel))
    jbatch = cache_slice.jdatasets.SyntheticSpheres("train", None, jcfg, num_images=3,
                                                    resolution=16).next_train()
    tbatch = tdatasets.SyntheticSpheres("train", None, tcfg, num_images=3, resolution=16,
                                        device="cpu").next_train()
    jstep = cache_slice.jax_loss(jmodel, jcfg)
    (jtotal, (jterms, _)), jgrad = jstep(variables, jbatch)
    # JAX's own noise floor: the same step with the rays' origins one ulp up,
    # and one ulp down.
    o = np.asarray(jbatch.rays.origins)
    nudged = [jstep(variables, jbatch.replace(rays=jbatch.rays.replace(
        origins=np.nextafter(o, np.float32(side)))))[1] for side in (np.inf, -np.inf)]
    calls = []

    def port_grads(batch):
        model = flagship.build_flagship_cache_model(
            tcfg, with_grid(cache_slice.narrow(flagship.flagship_cache_params())), device="cpu")
        model.load_state_dict(weights.state_dict_from_jax(variables, model))
        state, _ = ttrain.create_optimizer(tcfg, model)
        _, stats = ttrain.create_train_step(model, tcfg)(None, state, batch, TRAIN_FRAC)
        return {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}

    # The port's own floor likewise.
    tgrads = port_grads(tbatch)
    to = tbatch.rays.origins
    tnudged = port_grads(tbatch.replace(rays=tbatch.rays.replace(
        origins=torch.nextafter(to, torch.full_like(to, float("inf"))))))
    with pytest.MonkeyPatch.context() as mp:
        material_slice._counting_scatters(mp, calls)
        state, _ = ttrain.create_optimizer(tcfg, tmodel)
        _, stats = ttrain.create_train_step(tmodel, tcfg)(None, state, tbatch, TRAIN_FRAC)
    for k, v in jterms.items():
        np.testing.assert_allclose(cache_slice._num(stats["losses"][k]), float(v), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    # Leaves that sum terms of both signs move with float32 noise: JAX
    # against itself with the origins one ulp up moves the density tables
    # by a relative L2 of 5e-4 (triplane) and 3e-3 (TensoRF; 7e-3 with no
    # shader grid), and the port against itself likewise. Each leaf is held
    # to 1e-3 or 3x its floor (the largest of the three nudges').
    want = cache_slice._leaves(jgrad["params"])
    floors = {k: max([_rel_l2(np.asarray(cache_slice._leaves(g["params"])[k]), np.asarray(w))
                      for g in nudged] + ([_rel_l2(tnudged[k], tgrads[k])] if k in tgrads
                                          else [])) for k, w in want.items()}
    worst = _compare_leaves(tmodel, jgrad, jcfg, limit=float("inf"))
    for key, err in worst.items():
        assert err < max(1e-3, 3 * floors[key]), (key, err, floors[key])
    # The density grid's leveled backward only; the shader grid gathers.
    assert calls == ["leveled"]
    assert any(k.startswith("shader.grid.") for k, _ in tmodel.named_parameters())


def test_converter_round_trips_the_new_parameters(narrow_sample_net):
    """The JAX tree of set A's model (the sample network, the colour
    network, the normals offset) from the port's state_dict equals the
    tree it was filled from, leaf for leaf."""
    _, _, _, tmodel, variables, _, _ = build_set_a(seed=2)
    back = weights.jax_tree_from_state_dict(tmodel.state_dict(), material=False)
    want = dict(cache_slice._leaves(variables["params"]))
    got = dict(cache_slice._leaves(back["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    names = {k for k, _ in tmodel.named_parameters()}
    assert {"sampler.sample_net.layer.0.weight", "integrator.layer.1.bias",
            "integrator.output_layer.weight", "sampler.mlps.2.normals_offset_layer.bias"} <= names


def test_transient_material_volume_variate_matches_jax(monkeypatch):
    """Config.volume_variate_material on the narrow transient material model
    (where both packages run it): the material render with the cache's
    full render minus its render at the surface points added, its cache
    render and its direct term, against JAX's forward on the same draws;
    without the variate the render differs."""
    import test_torch_transient_material_slice as tmat

    base = tmat.bench._cache_config
    monkeypatch.setattr(tmat.bench, "_cache_config",
                        lambda: dataclasses.replace(base(), volume_variate_material=True))
    jcfg, tcfg, jmodel, tmodel, variables, jbatch, tbatch = tmat.build(
        volume_variate_material=True)
    assert jcfg.volume_variate_material and tcfg.volume_variate_material

    def forward(v, rays):
        out = jmodel.apply(v, jax.random.PRNGKey(0), rays, train_frac=TRAIN_FRAC, train=True,
                           compute_extras=False)
        return out["render"]["rgb"], out["render"]["cache_rgb"]

    with material_slice.injected(11), jhash.xla_encoder_scope():
        jrgb, jcache = jax.jit(forward)(variables, jbatch.rays)
    with material_slice.injected(11), torch.no_grad():
        tout = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    material_slice._close(tout["render"]["rgb"].numpy(), np.asarray(jrgb), err_msg="rgb",
                          **tmat.FWD)
    material_slice._close(tout["render"]["cache_rgb"].numpy(), np.asarray(jcache),
                          err_msg="cache_rgb", **tmat.FWD)
    tcfg.volume_variate_material = False
    with material_slice.injected(11), torch.no_grad():
        plain = tmodel(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)
    assert float((plain["render"]["rgb"] - tout["render"]["rgb"]).abs().max()) > 1e-4
