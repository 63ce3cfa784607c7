"""The transient material stage's light at the unit level, against the JAX
package: the learnable pulsed light source (``LightSourceMap``: forward,
getters and parameter gradients, with every ``optimize_*`` flag off and on,
the angular network and the angular Gaussian, in the global and the
camera-relative frame), the active-light sampler (alone and through the MIS
fan-out with the direct lobe's light-sampler records) and the time-binned
reflection estimator (direct and indirect lobes, with and without the BRDF
correction integrals). Inputs are made from numpy seeds; the parameters are
drawn from U(-0.5, 0.5) and bridged by ``utils/weights.state_dict_from_jax``.

Tolerances (float32): the same operations in the same order, so values to
1e-5 relative (1e-6 absolute); the light's parameter gradients are sums over
the points in another order, to 1e-5 relative with an atol of 1e-6 x the
leaf's largest entry. A wrong term is off by O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_torch_material_slice as material_slice
import test_torch_transient_slice as transient_slice
from neural_radiance_caching_tpu.models import light_sampler as jlight
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.models import light_sampler as tlight
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.utils import weights

UNIT = dict(rtol=1e-5, atol=1e-6)
# Non-unit multipliers and shift, so that each getter's arithmetic shows.
CALIBRATION = dict(transient_shift=0.3, transient_shift_multiplier=2.0, dark_level_multiplier=0.5,
                   light_pos_multiplier=1.5)


def _configs():
    jcfg = dataclasses.replace(bench._cache_config(), **transient_slice.TRANSIENT, **CALIBRATION)
    tcfg = flagship.transient_config(**CALIBRATION)
    return jcfg, tcfg


def _unit(rng, *shape):
    v = rng.randn(*shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _light_inputs(seed, lead=(3, 4)):
    """points, viewdirs, lights, look, up, origins, each lead + (3,)."""
    rng = np.random.RandomState(seed)
    look = _unit(rng, *lead, 3)
    up = _unit(rng, *lead, 3)
    return (rng.randn(*lead, 3).astype(np.float32), _unit(rng, *lead, 3),
            rng.randn(*lead, 3).astype(np.float32) + 2.0, look, up,
            rng.randn(*lead, 3).astype(np.float32) * 3.0)


@pytest.mark.parametrize("frame", ["global", "camera_local"])
@pytest.mark.parametrize("use_gaussian", [False, True])
@pytest.mark.parametrize("optimize", [False, True])
def test_light_source_map_matches_jax(optimize, use_gaussian, frame):
    jcfg, tcfg = _configs()
    fields = dict(optimize_light_position=optimize, optimize_transient_shift=optimize,
                  optimize_dark_level=optimize, optimize_gaussian=optimize and use_gaussian,
                  use_gaussian=use_gaussian, global_light_source=frame == "global",
                  relative_to_camera=frame == "global")
    inputs = _light_inputs(1)
    jmod = jlight.LightSourceMap(config=jcfg, **fields)
    tmod = tlight.LightSourceMap(config=tcfg, **fields)
    jin = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin))
    variables = material_slice.random_variables(shapes, 2)
    tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
    tin = [torch.as_tensor(x) for x in inputs]

    # Forward: the light radiance and the angular multiplier.
    want = jmod.apply(variables, *jin)
    got = tmod(*tin)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == inputs[0].shape[:-1] + (1,)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **UNIT)

    # Getters.
    points, _, lights, look, up, origins = range(6)

    def jgetters(m):
        return (m.get_lights(jin[lights], jin[look], jin[up]),
                m.get_light_source_look(jin[lights], jin[look], jin[up]),
                m.get_lights_opencv(jin[lights], jin[look], jin[up], jin[origins]),
                m.get_transient_shift(), m.get_dark_level())

    want = jmod.apply(variables, method=jgetters)
    got = (tmod.get_lights(tin[lights], tin[look], tin[up]),
           tmod.get_light_source_look(tin[lights], tin[look], tin[up]),
           tmod.get_lights_opencv(tin[lights], tin[look], tin[up], tin[origins]),
           tmod.get_transient_shift(), tmod.get_dark_level())
    for name, g, w in zip(("lights", "look", "opencv", "shift", "dark_level"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.float32(g)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **UNIT)
    if not optimize:
        assert tmod.get_dark_level() == 0.0 and tmod.get_transient_shift() == 0.3

    # Parameter gradients of the radiance and the calibration getters.
    def jloss(v):
        radiance, _ = jmod.apply(v, *jin)
        return radiance.sum() + jmod.apply(v, method=lambda m: (
            m.get_transient_shift() + m.get_dark_level()
            + m.get_lights(jin[lights], jin[look], jin[up]).sum()))

    jgrad = material_slice._leaves(jax.grad(jloss)(variables)["params"])
    tloss = tmod(*tin)[0].sum() + tmod.get_transient_shift() + tmod.get_dark_level() \
        + tmod.get_lights(tin[lights], tin[look], tin[up]).sum()
    tloss.backward()
    tparams = dict(tmod.named_parameters())
    assert sorted(jgrad) == sorted(tparams)
    for key, g in jgrad.items():
        tg = tparams[key].grad
        tg = np.zeros_like(material_slice._tr(key, g)) if tg is None else tg.numpy()
        material_slice._close(tg, material_slice._tr(key, g), rtol=1e-5, atol_frac=1e-6,
                              err_msg=key)
    reached = {k for k, g in jgrad.items() if np.any(g)}
    offsets = {"light_source_offset", "transient_shift_offset", "dark_level_offset"}
    assert (offsets <= reached) if optimize else not (offsets & reached)


def test_light_source_network_skip_reads_the_last_index():
    """The angular network joins its input back only when its last layer's
    index is a positive multiple of skip_layer, as the JAX loop leaves it."""
    jcfg, tcfg = _configs()
    inputs = _light_inputs(3)
    for depth, skip, joined in ((2, 4, False), (3, 2, True), (5, 4, True), (4, 2, False)):
        tmod = tlight.LightSourceMap(config=tcfg, net_depth=depth, skip_layer=skip, net_width=8)
        width = 8 + (2 * 5 if joined else 0)
        assert tmod.output_layer_mult.in_features == width, (depth, skip)
        jmod = jlight.LightSourceMap(config=jcfg, net_depth=depth, skip_layer=skip, net_width=8)
        jin = [jnp.asarray(x) for x in inputs]
        variables = material_slice.random_variables(
            jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jin)), 4)
        tmod.load_state_dict(weights.state_dict_from_jax(variables, tmod))
        np.testing.assert_allclose(tmod(*map(torch.as_tensor, inputs))[0].detach().numpy(),
                                   np.asarray(jmod.apply(variables, *jin)[0]), **UNIT)


def test_active_sampler_matches_jax():
    rng = np.random.RandomState(5)
    n, s = 6, 1
    kwargs = {"origins": rng.randn(n, s, 3).astype(np.float32),
              "lights": rng.randn(n, s, 3).astype(np.float32) * 4.0}
    wo = _unit(rng, n, s, 3)
    u = rng.rand(n, s).astype(np.float32)
    want = jru.ActiveSampler().sample_directions(
        None, jnp.asarray(u), jnp.asarray(u), jnp.asarray(wo), None, None,
        {k: jnp.asarray(v) for k, v in kwargs.items()})
    got = tru.ActiveSampler().sample_directions(
        None, torch.as_tensor(u), torch.as_tensor(u), torch.as_tensor(wo), None, None,
        {k: torch.as_tensor(v) for k, v in kwargs.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **UNIT)
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(
        tru.ActiveSampler().pdf(torch.as_tensor(wo), None, None, None).numpy(),
        np.asarray(jru.ActiveSampler().pdf(jnp.asarray(wo), None, None, None)))


def test_direct_lobe_fan_out_matches_jax():
    """One secondary ray per surface point toward the light, through
    get_secondary_rays with the direct lobe's light-sampler records; the
    uniforms it is handed are drawn in both packages."""
    normals, viewdirs, material = material_slice._unit_inputs(6)
    n = normals.shape[0]
    jrays, trays = material_slice._unit_rays(n, 7)
    rng = np.random.RandomState(8)
    means = rng.randn(n, 1, 3).astype(np.float32)
    lsr = {"origins": means[:, :, None], "lights": np.broadcast_to(
        rng.randn(n, 1, 1, 3).astype(np.float32) * 4.0, (n, 1, 1, 3)).copy()}
    kw = dict(normal_eps=1e-2, refdir_eps=0.1, num_secondary_samples=1, far=4.0)
    with material_slice.injected(9):
        jr, js = jru.get_secondary_rays(
            jax.random.PRNGKey(0), jrays, jnp.asarray(means), jnp.asarray(viewdirs),
            jnp.asarray(normals[:, None]),
            {k: jnp.asarray(v[:, None]) for k, v in material.items()},
            random_generator_2d=jru.RandomGenerator2D(1, 1, False),
            samplers=[(jru.ActiveSampler(), 1)],
            light_sampler_results={k: jnp.asarray(v) for k, v in lsr.items()}, **kw)
        tr, ts = tru.get_secondary_rays(
            torch.Generator(), trays, torch.as_tensor(means), torch.as_tensor(viewdirs),
            torch.as_tensor(normals[:, None]),
            {k: torch.as_tensor(v[:, None]) for k, v in material.items()},
            random_generator_2d=tru.RandomGenerator2D(1, 1, False),
            samplers=[(tru.ActiveSampler(), 1)],
            light_sampler_results={k: torch.as_tensor(v) for k, v in lsr.items()}, **kw)
        # Both streams stand at the same place after the fan-out.
        assert float(jax.random.uniform(None, ())) == float(material_slice.torchutil.uniform(
            None, (), "cpu"))
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), err_msg=k, **UNIT)
    np.testing.assert_allclose(tr.directions.numpy(), np.asarray(jr.directions), **UNIT)
    to_light = lsr["lights"][:, 0] - means
    np.testing.assert_allclose(tr.directions.numpy(),
                               to_light / np.linalg.norm(to_light, axis=-1, keepdims=True),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("direct", [True, False])
def test_transient_reflection_estimates_match_jax(direct, correction):
    normals, viewdirs, material = material_slice._unit_inputs(10)
    n, s, bins = normals.shape[0], 1 if direct else 5, 7
    rng = np.random.RandomState(11)
    radiance_shape = (n, s, 3) if direct else (n, s, bins, 3)
    samples = {
        "local_lightdirs": _unit(rng, n, s, 3),
        "local_viewdirs": np.repeat(viewdirs[:, None], s, axis=1),
        "brdf_correction": rng.uniform(0.5, 1.5, (n, s, 2)).astype(np.float32),
        "radiance_in": rng.uniform(0, 2, radiance_shape).astype(np.float32),
        "weight": rng.uniform(0, 2, (n, s, 1)).astype(np.float32),
        "pdf": rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
        "indirect_occ": rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
    }
    for shading in ("microfacet_specular", "microfacet_diffuse"):
        args = dict(use_mirrorness=False, use_diffuseness=False, use_specular_albedo=False,
                    direct=direct, max_radiance=1.5)
        want = jru.transient_integrate_reflect_rays(
            shading, correction, {k: jnp.asarray(v) for k, v in material.items()},
            {k: jnp.asarray(v) for k, v in samples.items()}, **args)
        got = tru.transient_integrate_reflect_rays(
            shading, correction, {k: torch.as_tensor(v) for k, v in material.items()},
            {k: torch.as_tensor(v) for k, v in samples.items()}, **args)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if w is None:
                assert got[k] is None and direct and k == "indirect_occ"
                continue
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k, **UNIT)
        lead = (n, 3) if direct else (n, bins, 3)
        assert tuple(got["radiance_out"].shape) == lead
