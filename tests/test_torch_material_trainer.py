"""The staged trainer's material stages against the JAX package's: the
extra losses they bind (light sampling, the secondary-ray sampler's
supervision, material smoothness, the consistency loss), the material
model's bypass passes, the orientation loss and the secondary rays'
stop-gradient weights, on the same gin files, weights and random draws.

Every uniform, normal and categorical draw of both packages comes from one
numpy stream (`test_torch_material_slice.injected`), in the order both take
them; the extra losses draw after the forwards, in dict order, and only
material_smoothness draws (its resample and its jitter; the JAX perturbed
pass then draws for secondary rays that no loss reads, and the port traces
none, after every draw the two share).

The weights are drawn from U(-0.5, 0.5), the hash tables from the grid's
own init range U(-1e-4, 1e-4), as a from-scratch stage starts them, and on
synthetic_spheres.gin from U(-0.5, 0.5) too (as trained tables hold). On the
ngp_yobo family U(-0.5, 0.5) tables put float32 noise above the step's
tolerance: the secondary rays follow the predicted normals, and the hotdog's
1e2 weight on their gradient multiplies the grid's positional derivative,
which jumps at cell faces. `test_trained_table_gaps_are_float32_noise` holds
the port there against that noise floor, measured on both packages by
moving the ray origins one ulp.

Tolerances (float32): unit-level losses on the same inputs agree to 1e-5
relative (the same ops in the same order), 1e-4 through the vMF mixture's
exp and the sRGB curve and through the interlevel loss's blur; their
gradients to the same rtol with an absolute rtol x the input's largest
entry. One train step: loss terms to 1e-4 relative with an
absolute 1e-7 (a ~100-op forward through two sampler hierarchies), but
material_smoothness to 1e-3: it is an L1 of the differences between the
material heads at points 0.01 apart, which cancel to ~1e-3 of the heads'
size. Every gradient leaf to rtol 2e-3 with an absolute 2e-4 x the leaf's
largest entry (sums in another order whose terms cancel; a wrong term is off
by O(1)), as in the other slices' tests; after the trainer's Adam step a
parameter is within 2 x its group's learning rate of optax's (the step
moves it by about +-lr, with the sign of a gradient that may be near zero).
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_material_slice as material_slice
import test_torch_trainer as trainer_test
from neural_radiance_caching_tpu.data import datasets as jdatasets
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.engine import gin_config as jgin
from neural_radiance_caching_tpu.models import construct as jconstruct
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import render_utils as jru
from neural_radiance_caching_tpu.parallel import extra_losses as jextra
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.parallel import train as jtrain
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.ops import render_utils as tru
from neural_radiance_caching_tpu_torch.parallel import extra_losses as textra
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.parallel import train as ttrain
from neural_radiance_caching_tpu_torch.utils import checkpoints as tckpt
from neural_radiance_caching_tpu_torch.utils import weights

SPHERES = trainer_test.SPHERES
SMOOTHNESS_LOSS = dict(rtol=1e-3, atol=1e-9)
MATERIAL = trainer_test.MATERIAL
LOSS = trainer_test.LOSS
UNIT = dict(rtol=1e-5, atol=1e-7)
# A gradient leaf's rtol, and its absolute tolerance as a fraction of the
# leaf's largest entry.
GRAD = (2e-3, 2e-4)
VMF = dict(rtol=1e-4, atol=1e-7)
TRAIN_FRAC = 0.25
# The material stage of ngp_yobo.gin at test widths: NGP_TINY's cache, a
# narrow light sampler, and the secondary rays' cache queries on the narrow
# sampling strategy; the smoothness weights of nerf_ngp_yobo.gin, so that the
# loss has a gradient.
MATERIAL_TINY = [
    "LightMLP.num_components = 8", "LightMLP.net_width = 16", "LightMLP.bottleneck_width = 16",
    "MaterialMLP.net_width = 16", "MaterialMLP.bottleneck_width = 16",
    "MaterialMLP.cache_train_sampling_strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))",
    "MaterialMLP.cache_render_sampling_strategy = ((0, 0, 8), (1, 1, 8), (2, 2, 8))",
]
SMOOTH = ["Config.material_smoothness_weight_albedo = 0.0001",
          "Config.material_smoothness_weight_other = 0.0001"]
NGP = ["configs/ngp_yobo.gin"]
HOTDOG = [trainer_test.HOTDOG]
# (gin files, bindings): every one a material_light_from_scratch stage with
# resampling; the hotdog's own orientation loss and stop-gradient weights. On
# spheres the secondary sampler's interlevel term too, so that the secondary
# rays' proposal levels keep their graph (on the others nothing reads them).
SCENES = {
    "synthetic_spheres": ([SPHERES], trainer_test.TINY + MATERIAL + SMOOTH + [
        "Config.material_ray_sampler_interlevel_loss_mult = 1.0"]),
    "ngp_yobo": (NGP, trainer_test.NGP_TINY + MATERIAL_TINY + MATERIAL + SMOOTH),
    "nerf_ngp_yobo_hotdog": (HOTDOG, trainer_test.NGP_TINY + MATERIAL_TINY + MATERIAL),
}
# The scatter launches of one material step: on synthetic_spheres.gin the
# leveled kernel for the cache's primary samples, its secondary samples, the
# "geometry" re-evaluation of material_smoothness and the light sampler's
# grid (which light_sampling trains); none on the ngp_yobo family, whose
# final level takes density normals (the plain encoder) and whose light
# sampler has no grid.
STEP_LAUNCHES = {"synthetic_spheres": ["leveled"] * 4, "ngp_yobo": [],
                 "nerf_ngp_yobo_hotdog": []}
# The shader outputs the JAX train step grafts from its debias forward.
NOCORR_KEYS = ("diffuse_rgb", "specular_rgb", "direct_rgb", "indirect_rgb", "transient_indirect",
               "lighting_irradiance", "cache_diffuse_rgb", "cache_specular_rgb",
               "cache_direct_rgb", "cache_indirect_rgb", "cache_transient_indirect")


@pytest.fixture(autouse=True)
def clean_gin():
    yield
    jgin.clear_config()
    tgin.clear_config()


def jax_step_loss(jmodel, jcfg, train_frac):
    """The JAX train step's loss (`parallel/train.py` without the mesh): the
    forward, the debias forward and its `_nocorr` grafts, per *main output
    its losses and its extra losses, then the parameter regularizers of
    `Config.param_regularizers`."""

    def loss_fn(variables, batch):
        rng = jax.random.PRNGKey(0)
        kw = dict(train_frac=train_frac, train=True, compute_extras=False)
        results = jmodel.apply(variables, rng, batch.rays, **kw)
        nocorr = jmodel.apply(
            variables, jax.random.fold_in(rng, 0x5EED), batch.rays,
            cache_outputs={"sampler": results["cache_main"]["sampler"]},
            filtered_sampler_inds=results["cache_main"]["filtered_sampler_inds"], **kw)
        results["render"]["rgb_nocorr"] = nocorr["render"]["rgb"]
        for out_key in ("main", "cache_main"):
            shader, nocorr_shader = results[out_key]["shader"], nocorr[out_key]["shader"]
            for k in NOCORR_KEYS:
                if k in nocorr_shader:
                    shader[k + "_nocorr"] = nocorr_shader[k]
        losses, stats = {}, {}
        for i, key in enumerate(sorted(k for k in results if k.endswith("main"))):
            jtrain._compute_losses_for_output(None, batch, batch.rays, results, jcfg, train_frac,
                                              key, losses, stats)
            jextra.compute_extra_losses(jmodel, variables, jax.random.fold_in(rng, 7919 + i),
                                        batch.rays, jcfg, batch, results, key, losses,
                                        train_frac)
        for k, v in jlosses.param_regularizer_loss(variables, jcfg).items():
            losses["regularizer_" + k] = v
        return sum(jax.tree_util.tree_leaves(losses)), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# The open parity checks (a material_light_from_scratch step from a scene on
# disk through both trainers: `test_torch_colmap.py`,
# `test_torch_more_loaders.py`, and `--vis_only` in
# `test_torch_eval_extras.py`): their bindings, stage and the extra losses
# every one of them carries. `from_disk` serves every step from disk.
OPEN_CHECK_MATERIAL = MATERIAL_TINY + MATERIAL + SMOOTH
OPEN_CHECK_STAGE = "material_light_from_scratch"
OPEN_CHECK_EXTRA = ["material_ray_sampler", "material_smoothness", "light_sampling",
                    "direct_indirect_consistency"]


def from_disk(monkeypatch, cast=None):
    """`_step_parity`'s JAX batch from the JAX loader of the scene on disk,
    its rays cast by `cast` where the port casts them in the step."""
    load = jdatasets.load_dataset

    def load_from_disk(split, _, cfg, **kw):
        data = load(split, cfg.data_dir, cfg, **kw)
        if cast is not None:
            next_train = data.next_train
            data.next_train = lambda: (lambda b: b.replace(rays=cast(data, b.rays)))(next_train())
        return data

    monkeypatch.setattr(jdatasets, "load_dataset", load_from_disk)

def _variables(jmodel, seed, table_scale=2e-4):
    """Every parameter from U(-0.5, 0.5), the hash tables from that range
    times `table_scale` (by default U(-1e-4, 1e-4))."""
    def scale(path, x):
        table = str(getattr(path[-1], "key", "")) in ("hash_levels", "dense_levels")
        return x * np.float32(table_scale) if table else x

    return jax.tree_util.tree_map_with_path(scale, trainer_test._jax_variables(jmodel, seed))


def _trainers(files, bindings, stage):
    """The JAX stage's Config and model, and the port's Trainer set up (rng,
    datasets, model, optimizer) without its loop."""
    jt = trainer_test.synthesize("jax", files, bindings, stage)
    jmodel = jconstruct.make_model(jt.config)
    tt = trainer_test.synthesize("torch", files, bindings, stage)
    tt._setup_rng()
    tt._load_datasets()
    tt._setup_model()
    return jt, jmodel, tt


def _step_parity(jt, jmodel, tt, variables, monkeypatch, launches):
    """One step through both trainers from `variables`: every loss term,
    every gradient leaf, and the parameters after the trainer's Adam step
    against optax's update of the JAX gradient. Returns the losses."""
    jcfg = jt.config
    jbatch = jdatasets.load_dataset("train", None, jcfg).next_train()
    with material_slice.injected(7), jhash.xla_encoder_scope():
        (_, jlosses_), jgrad = jax_step_loss(jmodel, jcfg, TRAIN_FRAC)(variables, jbatch)
    jgrad = jlosses.clip_gradients(jax.tree_util.tree_map(jnp.nan_to_num, jgrad), jcfg)
    jstate, _ = jtrain.create_optimizer(jcfg, variables)
    updates, _ = jstate.tx.update(jgrad, jstate.opt_state, variables)
    jnew = material_slice._leaves(optax.apply_updates(variables, updates)["params"])

    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    calls = []
    material_slice._counting_scatters(monkeypatch, calls)
    with material_slice.injected(7):
        state, stats = tt.train_step(tt.rng, tt.state, tt.dataset.next_train(), TRAIN_FRAC)
    assert calls == launches

    got = {k: float(v) for k, v in stats["losses"].items()}
    assert sorted(got) == sorted(jlosses_)
    for k, v in jlosses_.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k,
                                   **(SMOOTHNESS_LOSS if k.endswith("smoothness") else LOSS))
    want = material_slice._leaves(jgrad["params"])
    params = dict(tt.model.named_parameters())
    assert sorted(params) == sorted(want)
    for k, p in params.items():
        material_slice._close(p.grad.numpy(), material_slice._tr(k, want[k]), *GRAD, k)
    for k, p in params.items():
        lr = max(g["lr"] for g in state.optimizer.param_groups
                 if any(q is p for q in g["params"]))
        np.testing.assert_allclose(p.detach().numpy(), material_slice._tr(k, jnew[k]),
                                   rtol=0, atol=2 * lr + 1e-7, err_msg=k)
    return got


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_one_material_step_through_both_trainers(scene, monkeypatch):
    files, bindings = SCENES[scene]
    jt, jmodel, tt = _trainers(files, bindings, "material_light_from_scratch")
    variables = _variables(jmodel, 5)
    got = _step_parity(jt, jmodel, tt, variables, monkeypatch, STEP_LAUNCHES[scene])
    extra = ["material_ray_sampler", "material_smoothness", "light_sampling",
             "direct_indirect_consistency"]
    assert [k for k in got if k in extra] == extra
    assert got["light_sampling"] != 0 and got["material_smoothness"] != 0
    assert (got["material_ray_sampler"] != 0) == (scene != "ngp_yobo")
    if scene == "nerf_ngp_yobo_hotdog":
        # The hotdog's orientation loss, on the cache's primary rays and (with
        # the secondary sampler's unit multiplier) its secondary rays.
        assert got["cache_orientation"] > 0 and got["material_ray_sampler"] > 0


def test_one_material_step_at_trained_table_values(monkeypatch):
    """The spheres step with hash tables from U(-0.5, 0.5), where the grid
    shapes the forward as a trained one does, to the same tolerances."""
    files, bindings = SCENES["synthetic_spheres"]
    jt, jmodel, tt = _trainers(files, bindings, "material_light_from_scratch")
    variables = _variables(jmodel, 5, table_scale=1.0)
    got = _step_parity(jt, jmodel, tt, variables, monkeypatch, STEP_LAUNCHES["synthetic_spheres"])
    assert got["light_sampling"] != 0 and got["material_ray_sampler"] != 0


def _grad_errs(grads, ref):
    """{leaf: relative L2 error} of gradient leaves against `ref`."""
    return {k: float(np.linalg.norm(grads[k] - ref[k])) / max(float(np.linalg.norm(ref[k])), 1e-30)
            for k in ref}


def _nudged(rays, sign, nextafter, inf):
    """`rays` with every origin moved by one ulp up (sign 1) or down (-1)."""
    return rays.replace(origins=nextafter(rays.origins, sign * inf))


# (scene, draw seed): the hotdog at the draws where its final density MLP's
# gradient differs from JAX's by O(1); ngp_yobo at the step tests' draws.
NOISE_CASES = {"nerf_ngp_yobo_hotdog": 8, "ngp_yobo": 7}


@pytest.mark.parametrize("scene", sorted(NOISE_CASES))
def test_trained_table_gaps_are_float32_noise(scene):
    """At U(-0.5, 0.5) hash tables on the ngp_yobo family: the noise floor
    of each gradient leaf is the largest relative L2 change of JAX's and the
    port's gradient when the ray origins move one ulp up or down. Such a
    move fails the step tests' gradient tolerance in some leaf; the port's
    gap to JAX in each leaf is within 3 times the floor, plus 1e-3 where the
    floor is tiny. Prints the leaves whose gap exceeds 2e-3."""
    draws = NOISE_CASES[scene]
    files, bindings = SCENES[scene]
    jt, jmodel, tt = _trainers(files, bindings, "material_light_from_scratch")
    variables = _variables(jmodel, 5, table_scale=1.0)
    jbatch = jdatasets.load_dataset("train", None, jt.config).next_train()
    step = jax_step_loss(jmodel, jt.config, TRAIN_FRAC)
    jgrads = {}
    for sign in (0, 1, -1):
        rays = _nudged(jbatch.rays, sign, jnp.nextafter, jnp.float32(np.inf)) if sign \
            else jbatch.rays
        with material_slice.injected(draws), jhash.xla_encoder_scope():
            _, g = step(variables, jbatch.replace(rays=rays))
        jgrads[sign] = {k: material_slice._tr(k, v)
                        for k, v in material_slice._leaves(g["params"]).items()}
    tbatch = tt.dataset.next_train()
    state_dict = weights.state_dict_from_jax(variables, tt.model)
    tgrads = {}
    for sign in (0, 1, -1):
        rays = _nudged(tbatch.rays, sign, torch.nextafter, torch.tensor(np.inf)) if sign \
            else tbatch.rays
        tt.model.load_state_dict(state_dict)
        with material_slice.injected(draws):
            tt.train_step(tt.rng, tt.state, tbatch.replace(rays=rays), TRAIN_FRAC)
        tgrads[sign] = {k: p.grad.numpy().copy() for k, p in tt.model.named_parameters()}
    floor = {k: 0.0 for k in jgrads[0]}
    nudged_within_tolerance = []
    for grads, ref in ((jgrads[1], jgrads[0]), (jgrads[-1], jgrads[0]),
                       (tgrads[1], tgrads[0]), (tgrads[-1], tgrads[0])):
        for k, v in _grad_errs(grads, ref).items():
            floor[k] = max(floor[k], v)
        nudged_within_tolerance.append(all(
            np.all(np.abs(grads[k] - ref[k])
                   <= GRAD[0] * np.abs(ref[k]) + GRAD[1] * np.abs(ref[k]).max()) for k in ref))
    gap = _grad_errs(tgrads[0], jgrads[0])
    print(f"\n{scene}, draws {draws}, U(-0.5, 0.5) tables: leaf, port vs JAX, noise floor "
          "(relative L2)")
    for k in sorted(gap, key=lambda k: -gap[k]):
        if gap[k] > 2e-3:
            print(f"  {k}: {gap[k]:.3e} {floor[k]:.3e}")
    print(f"  max: {max(gap.values()):.3e} {max(floor.values()):.3e}")
    print(f"  a nudged step within the step tests' tolerance: {nudged_within_tolerance}")
    assert not all(nudged_within_tolerance)
    for k in gap:
        assert gap[k] <= 3 * floor[k] + 1e-3, (k, gap[k], floor[k])


# --- the losses on the same inputs -----------------------------------------------------


def _ns(**fields):
    """A stand-in for a rays dataclass: the losses read attributes only."""
    return types.SimpleNamespace(**fields)


def _pair(rng, shape, lo=-1.0, hi=1.0):
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x, requires_grad=True)


def _jgrad_close(jfn, jargs, tloss, targs, rtol):
    """The loss's gradient with respect to each input, in both packages, to
    `rtol` with an absolute `rtol` x the input's largest gradient entry."""
    jg = jax.grad(jfn, argnums=tuple(range(len(jargs))))(*jargs)
    tg = torch.autograd.grad(tloss, targs, allow_unused=True)
    for i, (a, b) in enumerate(zip(jg, tg)):
        b = np.zeros_like(np.asarray(a)) if b is None else b.numpy()
        material_slice._close(b, np.asarray(a), rtol, rtol, f"input {i}")


@pytest.mark.parametrize("linear_to_srgb", [True, False])
def test_vmf_loss_fn_matches_jax(linear_to_srgb):
    rng = np.random.RandomState(0)
    n, k, s = 12, 4, 6
    jm, tm = _pair(rng, (n, k, 3))
    jk, tk = _pair(rng, (n, k, 1), 0.5, 8.0)
    jl, tl = _pair(rng, (n, k, 1), -2.0, 2.0)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs = rng.randn(n, s, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pdf = rng.uniform(0.0, 0.5, (n, s, 1)).astype(np.float32)
    weight = rng.uniform(-1.0, 12.0, (n, s, 1)).astype(np.float32)
    fvals = rng.uniform(0.0, 3.0, (n, s)).astype(np.float32)
    fvals_nocorr = rng.uniform(0.0, 3.0, (n, s)).astype(np.float32)
    lossmult = rng.uniform(0.0, 1.0, (n, s)).astype(np.float32)

    def jfn(m, kap, lg):
        return jru.vmf_loss_fn((m, kap, lg), jnp.asarray(normals), jnp.asarray(dirs),
                               {"pdf": jnp.asarray(pdf), "weight": jnp.asarray(weight)},
                               jnp.asarray(fvals), jnp.asarray(fvals_nocorr),
                               jnp.asarray(lossmult), linear_to_srgb=linear_to_srgb)

    t = torch.as_tensor
    tloss = tru.vmf_loss_fn((tm, tk, tl), t(normals), t(dirs), {"pdf": t(pdf), "weight": t(weight)},
                            t(fvals), t(fvals_nocorr), t(lossmult), linear_to_srgb=linear_to_srgb)
    np.testing.assert_allclose(float(tloss), float(jfn(jm, jk, jl)), **VMF)
    _jgrad_close(jfn, (jm, jk, jl), tloss, (tm, tk, tl), VMF["rtol"])


@pytest.mark.parametrize("normalize,stopgrad", [(False, False), (True, False), (False, True)])
def test_orientation_loss_matches_jax(normalize, stopgrad):
    rng = np.random.RandomState(1)
    jw, tw = _pair(rng, (8, 5, 6), 0.0, 1.0)
    jn, tn = _pair(rng, (8, 5, 6, 3))
    jv, tv = _pair(rng, (8, 5, 3))
    lossmult = rng.uniform(0.5, 1.0, (8, 5, 1)).astype(np.float32)
    kw = dict(orientation_loss_mult=0.3, orientation_loss_target="normals_pred",
              orientation_loss_normalize=normalize, orientation_loss_stopgrad=stopgrad)
    jcfg, tcfg = jconfigs.Config(**kw), tconfigs.Config(**kw)

    def jfn(w, n, v):
        return jlosses.orientation_loss(
            _ns(viewdirs=v), {"weights": w, "lossmult": jnp.asarray(lossmult),
                                      "normals_pred": n}, jcfg)

    tloss = tlosses.orientation_loss(
        _ns(viewdirs=tv), {"weights": tw, "lossmult": torch.as_tensor(lossmult),
                                   "normals_pred": tn}, tcfg)
    np.testing.assert_allclose(float(tloss), float(jfn(jw, jn, jv)), **UNIT)
    _jgrad_close(jfn, (jw, jn, jv), tloss, (tw, tn, tv), UNIT["rtol"])
    assert tlosses.orientation_loss(_ns(viewdirs=tv), {"weights": tw}, tcfg) == 0.0


LS_LOBES = {"both": ("_indirect_diffuse", "_indirect_specular"),
            "diffuse only": ("_indirect_diffuse",)}


@pytest.mark.parametrize("lobes", sorted(LS_LOBES))
def test_light_sampling_loss_matches_jax(lobes):
    rng = np.random.RandomState(2)
    b, r, k, s = 6, 2, 4, 5
    p = b * r
    jls, tls = {}, {}
    for name, shape, lo, hi in (("vmf_means", (b, r, k, 3), -1, 1),
                                ("vmf_kappas", (b, r, k, 1), 0.5, 6),
                                ("vmf_logits", (b, r, k, 1), -1, 1),
                                ("vmf_normals", (b, r, 1, 3), -1, 1)):
        jls[name], tls[name] = _pair(rng, shape, lo, hi)
    lossmult = rng.uniform(0.5, 1.0, (b, 1)).astype(np.float32)
    shader_np = {}
    for suffix in LS_LOBES[lobes]:
        dirs = rng.randn(p, s, 3).astype(np.float32)
        shader_np[suffix] = dict(
            viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
            radiance_in=rng.uniform(0, 2, (p, s, 3)).astype(np.float32),
            pdf=rng.uniform(0, 0.5, (p, s, 1)).astype(np.float32),
            weight=rng.uniform(0, 2, (p, s, 1)).astype(np.float32),
            local_lightdirs=rng.randn(p, s, 3).astype(np.float32))
    kw = dict(light_sampling_linear_to_srgb=True)

    def shader(pkg, transient_bins=0):
        out = {}
        for suffix, d in shader_np.items():
            conv = jnp.asarray if pkg == "jax" else torch.as_tensor
            samples = {key: conv(v) for key, v in d.items() if key != "viewdirs"}
            if transient_bins:
                # The same radiance, spread over time bins that sum to it.
                split = np.full(d["radiance_in"].shape[:2] + (transient_bins, 3),
                                1.0 / transient_bins, np.float32)
                samples["radiance_in"] = conv(split * d["radiance_in"][:, :, None])
            out[f"ref_rays{suffix}"] = _ns(viewdirs=conv(d["viewdirs"]))
            out[f"ref_samples{suffix}"] = samples
        return out

    def jfn(ls):
        return jextra.light_sampling_loss(
            None, None, None, _ns(lossmult=jnp.asarray(lossmult)), jconfigs.Config(**kw),
            None, {"light_sampler": ls, "shader": shader("jax")}, None)

    trays = _ns(lossmult=torch.as_tensor(lossmult))
    want = float(jfn(jls))
    for cfg, bins in ((tconfigs.Config(**kw), 0),
                      (tconfigs.Config(use_transient=True, n_bins=4, **kw), 4)):
        tloss = textra.light_sampling_loss(None, None, trays, cfg, None,
                                           {"light_sampler": tls, "shader": shader("torch", bins)},
                                           None)
        np.testing.assert_allclose(float(tloss), want, err_msg=f"bins {bins}", **VMF)
    jg = jax.grad(jfn)(jls)
    tg = torch.autograd.grad(tloss, [tls[k] for k in sorted(tls)], allow_unused=True)
    for name, g in zip(sorted(tls), tg):
        g = np.zeros(tls[name].shape, np.float32) if g is None else g.numpy()
        material_slice._close(g, np.asarray(jg[name]), VMF["rtol"], VMF["rtol"], name)
    assert textra.light_sampling_loss(None, None, trays, tconfigs.Config(), None,
                                      {"light_sampler": None, "shader": {}}, None) == 0.0


MRS_MULTS = {
    "all terms": dict(material_ray_sampler_interlevel_loss_mult=0.5,
                      material_ray_sampler_normal_loss_mult=0.3,
                      material_ray_sampler_distortion_loss_mult=2.0,
                      material_ray_sampler_orientation_loss_mult=0.7,
                      distortion_loss_mult=0.01, orientation_loss_mult=0.1,
                      predicted_normal_loss_mult=0.2, predicted_normal_reverse_loss_mult=0.1,
                      predicted_normal_loss_stopgrad=False,
                      predicted_normal_loss_stopgrad_weight=0.1,
                      interlevel_loss_mults=(0.01, 0.02), interlevel_loss_blurs=(0.03, 0.003)),
    # ngp_yobo.gin's: every term multiplied by 0.
    "ngp_yobo": dict(predicted_normal_loss_mult=0.1, predicted_normal_reverse_loss_mult=0.1,
                     interlevel_loss_mults=(0.01, 0.01)),
    # The hotdog's: the orientation term alone.
    "hotdog": dict(distortion_loss_mult=0.01, orientation_loss_mult=0.01,
                   predicted_normal_loss_mult=0.05, predicted_normal_reverse_loss_mult=0.05,
                   interlevel_loss_mults=(0.01, 0.01)),
}


@pytest.mark.parametrize("mults", sorted(MRS_MULTS))
def test_material_ray_sampler_loss_matches_jax(mults):
    rng = np.random.RandomState(3)
    b, n, s = 4, 3, 6
    p = b * 2
    lossmult = rng.uniform(0.5, 1.0, (b, 1)).astype(np.float32)
    viewdirs = rng.randn(p, n, 3).astype(np.float32)
    viewdirs /= np.linalg.norm(viewdirs, axis=-1, keepdims=True)
    levels_np = []
    for _ in range(3):
        sdist = np.sort(rng.uniform(0, 1, (p, n, s + 1)).astype(np.float32), axis=-1)
        sdist[..., 0], sdist[..., -1] = 0.0, 1.0
        levels_np.append(dict(sdist=sdist, tdist=sdist * 4.0,
                              lossmult=rng.uniform(0.5, 1.0, (p, n, 1)).astype(np.float32)))
    jin, tin = {}, {}
    for i in range(3):
        jin[f"w{i}"], tin[f"w{i}"] = _pair(rng, (p, n, s), 0.0, 0.5)
    for name in ("normals", "normals_pred"):
        jin[name], tin[name] = _pair(rng, (p, n, s, 3))
    kw = MRS_MULTS[mults]

    def results(pkg, inputs):
        conv = jnp.asarray if pkg == "jax" else torch.as_tensor
        levels = [dict({k: conv(v) for k, v in lv.items()}, weights=inputs[f"w{i}"])
                  for i, lv in enumerate(levels_np)]
        levels[-1].update(normals=inputs["normals"], normals_pred=inputs["normals_pred"])
        return {"shader": {"ref_sampler_results_indirect_diffuse": levels,
                           "ref_rays_indirect_diffuse": _ns(viewdirs=conv(viewdirs))}}

    def jfn(inputs):
        return jextra.material_ray_sampler_loss(
            None, None, None, _ns(lossmult=jnp.asarray(lossmult)), jconfigs.Config(**kw),
            None, results("jax", inputs), None)

    tloss = textra.material_ray_sampler_loss(
        None, None, _ns(lossmult=torch.as_tensor(lossmult)), tconfigs.Config(**kw), None,
        results("torch", tin), None)
    want = float(jfn(jin))
    np.testing.assert_allclose(float(tloss), want, **UNIT)
    assert (want == 0.0) == (mults == "ngp_yobo")
    if mults != "ngp_yobo":
        jg = jax.grad(jfn)(jin)
        tg = torch.autograd.grad(tloss, [tin[k] for k in sorted(tin)], allow_unused=True)
        for name, g in zip(sorted(tin), tg):
            g = np.zeros(tin[name].shape, np.float32) if g is None else g.numpy()
            material_slice._close(g, np.asarray(jg[name]), VMF["rtol"], VMF["rtol"], name)


# --- the bypass passes and material smoothness on one forward's surface points ---------


@pytest.fixture(scope="module")
def spheres_forward():
    """The narrow spheres material model in both packages with the same
    weights, and the port's forward on the Trainer's first batch: its
    shader results at the resampled surface points feed both packages."""
    files, bindings = SCENES["synthetic_spheres"]
    jt, jmodel, tt = _trainers(files, bindings, "material_light_from_scratch")
    variables = _variables(jmodel, 5)
    tt.model.load_state_dict(weights.state_dict_from_jax(variables, tt.model))
    jbatch = jdatasets.load_dataset("train", None, jt.config).next_train()
    tbatch = tt.dataset.next_train()
    with material_slice.injected(3), torch.no_grad():
        tout = tt.model(torch.Generator(), tbatch.rays, train_frac=TRAIN_FRAC, train=True)

    def jax_gin():
        # A flax module builds its submodules, reading their gin bindings, when
        # it is applied: each test binds the stage again.
        trainer_test.synthesize("jax", files, bindings, "material_light_from_scratch")

    return dict(jcfg=jt.config, tcfg=tt.config, jmodel=jmodel, tmodel=tt.model,
                variables=variables, jbatch=jbatch, tbatch=tbatch, tout=tout, jax_gin=jax_gin)


def _tensors(d):
    return {k: v for k, v in d.items() if isinstance(v, torch.Tensor)}


def _flat_outputs(out, prefix=""):
    """{name: array} of a pass's tensor outputs (nested one level)."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat_outputs(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape") and not isinstance(v, (list, tuple)):
            flat[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return flat


@pytest.mark.parametrize("passes", [("geometry",), ("material_shader",),
                                    ("material_cache_shader",)])
def test_bypass_passes_match_jax(spheres_forward, passes):
    f = spheres_forward
    sampler_results = _tensors(f["tout"]["main"]["shader"])
    jsr = {k: jnp.asarray(v.numpy()) for k, v in sampler_results.items()}
    kw = dict(train_frac=TRAIN_FRAC, train=True, compute_extras=False, passes=passes)
    f["jax_gin"]()
    with material_slice.injected(4), jhash.xla_encoder_scope():
        jout = jax.jit(lambda v, sr, rays: f["jmodel"].apply(
            v, jax.random.PRNGKey(0), rays, sampler_results=sr, **kw))(
            f["variables"], jsr, f["jbatch"].rays)
    with material_slice.injected(4), torch.no_grad():
        tout = f["tmodel"](torch.Generator(), f["tbatch"].rays, sampler_results=sampler_results,
                           **kw)
    want, got = _flat_outputs(jout), _flat_outputs(tout)
    assert sorted(k for k in want if k in got) == sorted(k for k in got if k in want)
    compared = 0
    for k, v in want.items():
        if k not in got or v.dtype == bool or got[k].shape != v.shape:
            continue
        # The secondary rays' statistics carry the material's ~1e-6 through
        # their samples (see test_torch_material_slice's SEC).
        tol = material_slice.SEC if "indirect" in k or "irradiance" in k or "diffuse" in k \
            or "specular" in k or k.endswith("rgb") else material_slice.FWD
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
        compared += 1
    head = "material/material_albedo" if "material_cache_shader" in passes else "material_albedo"
    assert compared >= 5 and (passes == ("geometry",) or head in got)


def test_material_only_equals_the_full_pass(spheres_forward):
    """The heads the full material pass outputs, and their gradients, from
    the pass that traces no secondary ray."""
    f = spheres_forward
    model = f["tmodel"]
    sampler_results = _tensors(f["tout"]["main"]["shader"])
    outs = {}
    for heads_only in (False, True):
        model.zero_grad(set_to_none=True)
        with material_slice.injected(5):
            out = model(torch.Generator(), f["tbatch"].rays, passes=("material_shader",),
                        sampler_results=sampler_results, train_frac=TRAIN_FRAC,
                        material_only=heads_only)
        heads = {k: v for k, v in out.items() if k.startswith("material_")}
        sum(v.sum() for v in heads.values()).backward()
        outs[heads_only] = ({k: v.detach() for k, v in heads.items()},
                            {k: p.grad.clone() for k, p in model.named_parameters()
                             if p.grad is not None})
    (full, full_grad), (heads, heads_grad) = outs[False], outs[True]
    assert sorted(heads) == sorted(full) and "material_albedo" in heads
    for k in full:
        assert torch.equal(heads[k], full[k]), k
    assert sorted(heads_grad) == sorted(full_grad)
    for k in full_grad:
        torch.testing.assert_close(heads_grad[k], full_grad[k], rtol=1e-6, atol=1e-9)
    model.zero_grad(set_to_none=True)


SMOOTHNESS = {
    "l1 tensoir": dict(material_smoothness_l1_loss=True, material_smoothness_tensoir_albedo=True),
    "l2 irradiance": dict(material_smoothness_l1_loss=False,
                          material_smoothness_irradiance_weight=True,
                          material_smoothness_albedo_stopgrad=True),
    "tensoir stopgrad irradiance": dict(material_smoothness_tensoir_albedo=True,
                                        material_smoothness_albedo_stopgrad=True,
                                        material_smoothness_irradiance_weight=True),
}


@pytest.mark.parametrize("variant", sorted(SMOOTHNESS))
def test_material_smoothness_loss_matches_jax(spheres_forward, variant, monkeypatch):
    f = spheres_forward
    kw = dict(SMOOTHNESS[variant], material_smoothness_weight_albedo=0.5,
              material_smoothness_weight_other=0.25, material_smoothness_noise=0.02)
    jcfg = dataclasses.replace(f["jcfg"], **kw)
    tcfg = dataclasses.replace(f["tcfg"], **kw)
    tout = f["tout"]
    shader = _tensors(tout["main"]["shader"])
    cache_shader = _tensors(tout["cache_main"]["shader"])

    def jloss(v, sh, csh, rays):
        return jextra.material_smoothness_loss(
            f["jmodel"], v, jax.random.PRNGKey(0), rays, jcfg, None, {"shader": sh},
            {"cache_main": {"shader": csh}}, train_frac=TRAIN_FRAC)

    to_j = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    f["jax_gin"]()
    with material_slice.injected(6), jhash.xla_encoder_scope():
        want = float(jax.jit(jloss)(f["variables"], to_j(shader), to_j(cache_shader),
                                    f["jbatch"].rays))
    # The perturbed pass traces no secondary ray: the cache model itself is
    # never called (its final density MLP and shader are).
    cache_calls = []
    monkeypatch.setattr(type(f["tmodel"].cache), "forward",
                        lambda *a, **k: cache_calls.append(1))
    with material_slice.injected(6), torch.no_grad():
        got = float(textra.material_smoothness_loss(
            f["tmodel"], torch.Generator(), f["tbatch"].rays, tcfg, None,
            {"shader": dict(tout["main"]["shader"])}, {"cache_main": {"shader": cache_shader}},
            train_frac=TRAIN_FRAC))
    assert cache_calls == []
    assert want != 0.0
    np.testing.assert_allclose(got, want, **SMOOTHNESS_LOSS)


# --- the warm-started stage and the entry point ------------------------------------------


@pytest.fixture(scope="module")
def spheres_cache_checkpoint(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "spheres_cache")
    trainer_test._run(["Trainer.stage = 'cache'", f"Config.checkpoint_dir = '{ckpt}'",
                       "Config.early_exit_steps = 2"])
    tgin.clear_config()
    return ckpt


def test_warm_started_material_light_step_matches_optax(spheres_cache_checkpoint, monkeypatch):
    """material_light warm-started from a cache checkpoint: the cache comes
    from it, each parameter group's learning rate is optax's under the
    stage's `*_material` schedules, and one step (secondary-ray directions
    taking the material's gradient, stopgrad_material=False) matches JAX's."""
    files, bindings = SCENES["synthetic_spheres"]
    bindings = bindings + [f"Config.partial_checkpoint_dir = '{spheres_cache_checkpoint}'"]
    jt, jmodel, tt = _trainers(files, bindings, "material_light")
    tt._setup_checkpointing()
    source = tckpt.load_params(spheres_cache_checkpoint)
    for k, v in tt.model.state_dict().items():
        if k.startswith("cache."):
            assert torch.equal(v, source["model"][k]), k
    assert tt.config.is_material and not tt.model.shader.stopgrad_material
    variables = jax.tree_util.tree_map(np.asarray,
                                       weights.jax_tree_from_state_dict(tt.model.state_dict()))

    # Unit gradients: optax's update of every parameter is -lr of its group,
    # at each step of the stage's schedule (max_steps 8 here).
    jstate, _ = jtrain.create_optimizer(jt.config, variables)
    ones = jax.tree_util.tree_map(jnp.ones_like, variables)
    update = jax.jit(lambda s: jstate.tx.update(ones, s, variables))
    group_of = {id(p): i for i, g in enumerate(tt.state.optimizer.param_groups)
                for p in g["params"]}
    opt_state = jstate.opt_state
    for step in range(4):
        updates, opt_state = update(opt_state)
        want = material_slice._leaves(updates["params"])
        for key, p in tt.model.named_parameters():
            lr = tt.state.group_lr_fns[group_of[id(p)]](step)
            np.testing.assert_allclose(-np.asarray(want[key]).reshape(-1)[0], lr, rtol=1e-5,
                                       atol=1e-12, err_msg=f"{key} @ {step}")
    _step_parity(jt, jmodel, tt, variables, monkeypatch, STEP_LAUNCHES["synthetic_spheres"])


def test_the_entry_point_trains_the_readme_material_stage(spheres_cache_checkpoint, tmp_path):
    """train_with_trainer on the README's second stage (material from scratch
    with resampling, warm-started from the cache stage): the extra losses in
    the train log, a checkpoint, and a second run that resumes it."""
    ckpt = str(tmp_path / "spheres_material")
    args = ["Trainer.stage = 'material_light_from_scratch'", "Trainer.resample = True",
            f"Config.checkpoint_dir = '{ckpt}'", "Config.early_exit_steps = 2",
            "Config.print_every = 1"]
    trainer_test._run(args + [f"Config.partial_checkpoint_dir = '{spheres_cache_checkpoint}'"])
    tgin.clear_config()
    lines = open(f"{ckpt}/train_log.jsonl").read().splitlines()
    logged = [json.loads(line) for line in lines]
    assert [r["step"] for r in logged] == [1, 2]
    for name in ("light_sampling", "material_ray_sampler", "material_smoothness",
                 "direct_indirect_consistency", "data", "cache_data"):
        assert all(np.isfinite(r[f"loss/{name}"]) for r in logged), name
    assert tckpt.latest_checkpoint_step(ckpt) == 2
    # Without the warm start, the stage resumes its own checkpoint (as JAX's
    # trainer, a partial_checkpoint_dir takes precedence over resuming).
    trainer = trainer_test._run(args)
    assert trainer.state.step == 2
    assert open(f"{ckpt}/train_log.jsonl").read().splitlines() == lines


@pytest.mark.parametrize("loss", ["residual_albedo", "material_correlation", "emission"])
def test_unported_extra_losses_are_refused_by_name(loss):
    cfg = tconfigs.Config(extra_losses={"material_ray_sampler": {"main": {"mult": 1.0}},
                                        loss: {"main": {"mult": 1.0}}})
    with pytest.raises(NotImplementedError, match=rf"no runnable config reaches\): {loss}$"):
        ttrain.create_train_step(None, cfg)
    ported = {k: {"main": {"mult": 1.0}} for k in textra.EXTRA_LOSS_FUNCTIONS}
    assert textra.unported(tconfigs.Config(extra_losses=ported)) == []
