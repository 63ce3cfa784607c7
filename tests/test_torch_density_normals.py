"""The parts of the gin cache stage that the flagship builders never reached,
against the JAX package on the same numpy-seeded inputs and weights:

* a narrow DensityMLP with analytic density normals on a small hash grid:
  the density, the normals, and the gradients of a loss that reads both
  (the hash table, the MLP, the sample means), against JAX's one-VJP
  normals under its XLA encoder (models/geometry.py);
* the port's repair: the kernel-backed encoder refuses a second backward;
* the power ladder and its inverse (round trip and values);
* the proposal sampler with a tuple ``raydist_fn`` (the power-ladder ray
  warp of ngp_yobo.gin), fed the same draws;
* the opaque/empty mask loss.

Tolerances (float32): forward values 1e-5 relative (1e-6 absolute), the
same ops in the same order. The normals are a gradient of a ~20-op chain
(1e-4 relative). Gradients of the normal-reading loss are second-order sums
whose terms cancel, held like the other slices' gradients: rtol 2e-3 and an
absolute 2e-4 x the leaf's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_material_slice as material_slice
from neural_radiance_caching_tpu.engine import configs as jconfigs
from neural_radiance_caching_tpu.models import geometry as jgeometry
from neural_radiance_caching_tpu.models import sampler as jsampler
from neural_radiance_caching_tpu.ops import coord as jcoord
from neural_radiance_caching_tpu.ops import hashgrid as jhash
from neural_radiance_caching_tpu.ops import math as jmath
from neural_radiance_caching_tpu.parallel import losses as jlosses
from neural_radiance_caching_tpu.utils import pytrees as jpytrees
from neural_radiance_caching_tpu_torch.engine import configs as tconfigs
from neural_radiance_caching_tpu_torch.models import geometry as tgeometry
from neural_radiance_caching_tpu_torch.models import sampler as tsampler
from neural_radiance_caching_tpu_torch.ops import coord as tcoord
from neural_radiance_caching_tpu_torch.ops import hashgrid as thash
from neural_radiance_caching_tpu_torch.ops import math as tmath
from neural_radiance_caching_tpu_torch.parallel import losses as tlosses
from neural_radiance_caching_tpu_torch.utils import pytrees as tpytrees
from neural_radiance_caching_tpu_torch.utils import weights

FWD = dict(rtol=1e-5, atol=1e-6)
GRID = {"hash_map_size": 512, "max_grid_size": 32, "num_features": 2, "min_grid_size": 4}


def _random_variables(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)), variables)


def _density_pair(seed=0):
    kw = dict(net_depth=2, net_width=16, skip_layer=4, disable_density_normals=False,
              enable_pred_normals=True, max_deg_point=2)
    jmlp = jgeometry.DensityMLP(config=jconfigs.Config(), grid_params=GRID,
                                warp_fn=jcoord.contract_radius_2, **kw)
    tmlp = tgeometry.DensityMLP(config=tconfigs.Config(), grid_params=GRID,
                                warp_fn=tcoord.contract_radius_2, **kw)
    n, s = 5, 4
    jrays, trays = material_slice._unit_rays(n, seed)
    rng = np.random.RandomState(seed + 1)
    means = rng.uniform(-1.5, 1.5, (n, s, 3)).astype(np.float32)
    a = rng.randn(n, s, 3, 3).astype(np.float32) * 0.01
    covs = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    tdist = np.sort(rng.uniform(2, 6, (n, s + 1)), -1).astype(np.float32)
    init = jmlp.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jrays,
                     (jnp.asarray(means), jnp.asarray(covs)), jnp.asarray(tdist))
    variables = _random_variables(init, seed + 2)
    tmlp.load_state_dict(weights.state_dict_from_jax(variables, tmlp))
    return jmlp, tmlp, variables, jrays, trays, means, covs, tdist


def test_density_normals_and_their_gradients_match_jax():
    jmlp, tmlp, variables, jrays, trays, means, covs, tdist = _density_pair()
    rng = np.random.RandomState(9)
    wn = rng.randn(*means.shape).astype(np.float32)
    wd = rng.randn(*means.shape[:-1]).astype(np.float32)

    def jloss(variables, m):
        out = jmlp.apply(variables, jax.random.PRNGKey(1), jrays, (m, jnp.asarray(covs)),
                         jnp.asarray(tdist))
        return jnp.sum(out["normals"] * wn) + jnp.sum(out["density"] * wd), out

    with jhash.xla_encoder_scope():
        (jval, jout), (jgrad, jgrad_m) = jax.jit(
            jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(variables, jnp.asarray(means))

    m = torch.as_tensor(means).requires_grad_(True)
    tout = tmlp(None, trays, (m, torch.as_tensor(covs)), torch.as_tensor(tdist))
    tval = torch.sum(tout["normals"] * torch.as_tensor(wn)) + torch.sum(
        tout["density"] * torch.as_tensor(wd))
    tval.backward()

    np.testing.assert_allclose(tout["density"].detach().numpy(), np.asarray(jout["density"]),
                               **FWD)
    np.testing.assert_allclose(tout["normals"].detach().numpy(), np.asarray(jout["normals"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-4)
    material_slice._close(m.grad.numpy(), np.asarray(jgrad_m), 2e-3, 2e-4, "means")
    want = material_slice._leaves(jgrad["params"])
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in tmlp.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        material_slice._close(g.numpy(), material_slice._tr(k, want[k]), 2e-3, 2e-4, k)
    # The table gradient reaches the hash levels (the normals read them).
    assert float(tmlp.grid.hash_levels.grad.abs().max()) > 0


def test_density_normals_take_the_plain_encoder_and_no_scatter(monkeypatch):
    _, tmlp, _, _, trays, means, covs, tdist = _density_pair(seed=3)
    calls = []
    monkeypatch.setattr(thash._GridEncode, "apply",
                        lambda *a: calls.append(1) or (_ for _ in ()).throw(AssertionError))
    out = tmlp(None, trays, (torch.as_tensor(means), torch.as_tensor(covs)),
               torch.as_tensor(tdist))
    out["normals"].sum().backward()
    assert not calls
    # Without gradients (an eval render) nothing keeps a graph.
    with torch.no_grad():
        out = tmlp(None, trays, (torch.as_tensor(means), torch.as_tensor(covs)),
                   torch.as_tensor(tdist))
    assert not out["normals"].requires_grad and not out["density"].requires_grad


def test_kernel_encoder_refuses_a_second_backward():
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.uniform(0, 1, (6, 1, 3)).astype(np.float32), dtype=torch.float32)
    x.requires_grad_(True)
    table = torch.as_tensor(rng.randn(1, 64, 2).astype(np.float32)).requires_grad_(True)
    kw = dict(grid_sizes=(8,), table_size=64, dense_offsets=(), interpolation="trilinear")
    feats = thash.multires_grid_encode(x, table, None, **kw)
    (gx,) = torch.autograd.grad(feats.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|does not require grad"):
        torch.autograd.grad(gx.sum(), table)
    # The plain encoder is second-order.
    feats = thash.multires_grid_encode(x, table, None, plain=True, **kw)
    (gx,) = torch.autograd.grad((feats ** 2).sum(), x, create_graph=True)
    (gt,) = torch.autograd.grad(gx.sum(), table)
    assert float(gt.abs().max()) > 0


def test_power_ladder_round_trip_matches_jax():
    x = np.linspace(-8, 8, 41).astype(np.float32)
    for p in (-1.5, 0.5, 2.0):
        kw = dict(p=p, premult=2.0)
        y = tmath.power_ladder(torch.as_tensor(x), **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(jmath.power_ladder(jnp.asarray(x), **kw)),
                                   **FWD)
        back = tmath.inv_power_ladder(y, **kw)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jmath.inv_power_ladder(jnp.asarray(y.numpy()), **kw)), **FWD)
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tmath.power_ladder_max_output(-1.5)),
                               float(jmath.power_ladder_max_output(-1.5)), rtol=1e-6)


def test_sampler_with_tuple_raydist_matches_jax():
    mlp = {"use_grid": False, "max_deg_point": 2, "net_depth": 1, "net_width": 8,
           "disable_density_normals": True, "enable_pred_normals": True}
    kw = dict(sampling_strategy=((0, 0, 6), (1, 1, 4)), mlp_params_per_level=(mlp, mlp),
              anneal_clip=0.4, resample_padding=1e-5, dilation_bias=0.0,
              dilation_multiplier=0.0)
    ladder = {"p": -1.5, "premult": 2}
    jsam = jsampler.ProposalVolumeSampler(
        config=jconfigs.Config(), raydist_fn=(jmath.power_ladder, jmath.inv_power_ladder, ladder),
        **kw)
    tsam = tsampler.ProposalVolumeSampler(
        config=tconfigs.Config(), raydist_fn=(tmath.power_ladder, tmath.inv_power_ladder, ladder),
        **kw)
    jrays, trays = material_slice._unit_rays(6, 2)
    variables = _random_variables(
        jsam.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), jrays, train_frac=0.5), 4)
    tsam.load_state_dict(weights.state_dict_from_jax(variables, tsam))
    with material_slice.injected(5):
        jhist = jax.jit(lambda v: jsam.apply(v, jax.random.PRNGKey(1), jrays, train_frac=0.5))(
            variables)
        thist = tsam(torch.Generator(), trays, train_frac=0.5)
    assert len(jhist) == len(thist) == 2
    for jlevel, tlevel in zip(jhist, thist):
        for k in ("sdist", "tdist", "weights", "density"):
            np.testing.assert_allclose(tlevel[k].detach().numpy(), np.asarray(jlevel[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    # The warp is not the identity: metric distances bunch toward the near plane.
    s, t = thist[-1]["sdist"].detach().numpy(), thist[-1]["tdist"].detach().numpy()
    assert np.abs(t - (2.0 + 4.0 * s)).max() > 0.1


def test_mask_loss_matches_jax():
    rng = np.random.RandomState(3)
    n = 12
    acc = rng.uniform(0, 1, (n,)).astype(np.float32)
    masks = (rng.uniform(0, 1, (n, 1)) > 0.5).astype(np.float32)
    lossmult = rng.uniform(0.5, 1.0, (n, 1)).astype(np.float32)
    cfg = dict(opaque_loss_weight=0.1, empty_loss_weight=1.0, use_mask_weight_ease=True,
               mask_weight_ease_frac=0.5)
    jcfg, tcfg = jconfigs.Config(**cfg), tconfigs.Config(**cfg)
    jrays = jpytrees.dummy_rays(n).replace(lossmult=jnp.asarray(lossmult))
    trays = tpytrees.Rays(*([None] * 12), lossmult=torch.as_tensor(lossmult), near=None,
                          far=None, cam_idx=None, light_idx=None)
    for empty in (None, 0.3):
        want = jlosses.compute_mask_loss(
            jpytrees.Batch(rays=jrays, masks=jnp.asarray(masks)), {"acc": jnp.asarray(acc)},
            jrays, jcfg, train_frac=0.3, empty_loss_weight=empty)
        got = tlosses.compute_mask_loss(
            tpytrees.Batch(rays=trays, masks=torch.as_tensor(masks)),
            {"acc": torch.as_tensor(acc)}, trays, tcfg, train_frac=0.3, empty_loss_weight=empty)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
