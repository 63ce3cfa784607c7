"""Data-parallel training of the port on the CPU (``parallel/mesh.py``):
the mesh helpers, the sharded random draws, two gloo ranks against one
process, the sharded eval render, the failures, and ``dryrun_multichip``.

Two ranks are two processes (``mesh.spawn``) that meet over a FileStore
under the test's temporary directory and run one CPU thread each; every
spawn has a time limit and kills its ranks when it runs out, so a rank that
fails or a collective that the ranks call in different orders fails one
test. The models are the reference phases' narrow widths of
``chip_smoke.py`` (the flagship structure: 32-wide MLPs, 2^14-row grids) at
small global batches, the same global batch fed to one process and split
across the ranks.

Tolerances (float32). A rank computes each ray's forward and backward with
the same float32 operations as one process does on the global batch (its
random draws are its block of the global batch's, ``torchutil.ray_shard``);
what differs is the sums over rays: each rank sums its half and the
all-reduce adds the halves, a reassociation. So the loss (the mean of the
ranks' means) agrees to 1e-6 relative, and every gradient leaf to
GRAD_FLOOR in relative L2: the CPU float32 floor of that reassociation,
a few tens of ulps of a leaf's norm (the runs here read at most 1.2e-6). A
planted fault, one rank keeping its own gradient, reads O(1). The ranks
hold the same parameters bit for bit after 3 steps: the all-reduce hands
both the same sums, and the rest of the step is the same operations on
the same numbers. The eval render's rows are rendered by the same
operations in blocks of other sizes: 1e-5 relative, 1e-6 absolute.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from neural_radiance_caching_tpu_torch import flagship
from neural_radiance_caching_tpu_torch.data import datasets
from neural_radiance_caching_tpu_torch.engine import renderer
from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.parallel import train
from neural_radiance_caching_tpu_torch.utils import pytrees, torchutil

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
SPAWN_TIMEOUT_S = 240.0
GRAD_FLOOR = 1e-5
LOSS_RTOL = 1e-6
STEPS = 3
SEED = 0


def spawn(target, tmp_path, kwargs=None, **kw):
    return mesh_lib.spawn(f"{__name__}:{target}", kw.pop("world_size", WORLD), kwargs,
                          workdir=str(tmp_path), paths=[HERE],
                          timeout_s=kw.pop("timeout_s", SPAWN_TIMEOUT_S), **kw)


# --- the stages at reference widths --------------------------------------------------


def _cache_config():
    return flagship.cache_config(batch_size=64, lr_delay_steps=0)


def _material_config():
    return flagship.material_config(batch_size=16, lr_delay_steps=0)


def _transient_material_config():
    return dataclasses.replace(chip_smoke._transient_material_ref_config(), batch_size=8)


STAGES = {
    "cache": (_cache_config, lambda: chip_smoke._narrow(flagship.flagship_cache_params()),
              flagship.build_flagship_cache_model),
    "material": (_material_config, chip_smoke._narrow_material,
                 flagship.build_flagship_material_model),
    "transient_material": (_transient_material_config, chip_smoke._narrow_transient_material,
                           flagship.build_flagship_transient_material_model),
}


def _build(stage):
    config_fn, params_fn, build = STAGES[stage]
    config = config_fn()
    torch.manual_seed(SEED)
    model = build(config, params_fn(), device="cpu")
    state, _ = train.create_optimizer(config, model)
    return config, model, state


def global_batches(stage, n=STEPS):
    data = datasets.SyntheticSpheres("train", None, STAGES[stage][0](), num_images=4,
                                     resolution=16, device="cpu")
    return [data.next_train() for _ in range(n)]


def run_steps(stage, batches):
    """STEPS train steps of `stage` on `batches` (global; each rank takes its
    block): the first step's losses (averaged over the ranks) and gradients,
    and the parameters after the last."""
    config, model, state = _build(stage)
    mesh_lib.replicate(model, state.optimizer)
    step = train.create_train_step(model, config)
    rng = torch.Generator().manual_seed(SEED + 5)
    for i, batch in enumerate(batches):
        state, stats = step(rng, state, mesh_lib.shard_batch(batch), 0.5)
        if i == 0:
            names = sorted(stats["losses"])
            values = torch.stack([stats["loss"].detach().reshape(())] + [
                torch.as_tensor(stats["losses"][k]).detach().float().reshape(()) for k in names])
            values = mesh_lib.allreduce_mean(values)
            losses = dict(zip(["loss"] + names, values.tolist()))
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(losses=losses, grads=grads,
                params={k: v.clone() for k, v in model.state_dict().items()})


def _keeping_own_gradient_on_rank_1(allreduce):
    """The planted fault: rank 1 takes part in the all-reduce but keeps its
    own gradient."""

    def faulty(params):
        own = [p.grad.clone() for p in params]
        allreduce(params)
        if mesh_lib.process_index() == 1:
            for p, g in zip(params, own):
                p.grad.copy_(g)

    return faulty


def render_view(stage, chunk):
    """A 9 x 9 held-out view of `stage`'s model at render chunk `chunk` (81
    rays: the last chunk ragged), 2 repeats."""
    config, model, _ = _build(stage)
    config = dataclasses.replace(config, render_chunk_size=chunk)
    data = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=9,
                                     device="cpu")
    rays = data.generate_ray_batch(0).rays
    return renderer.render_image(train.create_render_fn(model), rays,
                                 torch.Generator().manual_seed(SEED + 3), config, height=9,
                                 width=9, render_repeats=2, device="cpu")


def steps_rank(mesh, batches, render_chunk):
    """A rank of `two_ranks`: every stage's steps, the planted fault's first
    step of the cache stage, and the material model's eval render."""
    out = {stage: run_steps(stage, stage_batches) for stage, stage_batches in batches.items()}
    real = mesh_lib.allreduce_gradients
    mesh_lib.allreduce_gradients = _keeping_own_gradient_on_rank_1(real)
    try:
        fault = run_steps("cache", batches["cache"][:1])
    finally:
        mesh_lib.allreduce_gradients = real
    out["fault"] = fault["grads"]
    out["render"] = render_view("material", render_chunk)
    out["rank"] = (mesh.rank, mesh.world_size, mesh.device, mesh.backend)
    return out


RENDER_CHUNK = 20


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    batches = {stage: global_batches(stage) for stage in STAGES}
    one = {stage: run_steps(stage, b) for stage, b in batches.items()}
    one["render"] = render_view("material", RENDER_CHUNK)
    ranks = spawn("steps_rank", tmp_path_factory.mktemp("ranks"),
                  dict(batches=batches, render_chunk=RENDER_CHUNK))
    return one, ranks


def _rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


# --- the mesh helpers ----------------------------------------------------------------


def _batch(n, kind):
    rng = np.random.RandomState(0)

    def arr(*shape, dtype=np.float32):
        x = rng.standard_normal((n,) + shape).astype(dtype)
        return torch.as_tensor(x) if kind == "torch" else x

    rays = pytrees.Rays(*[arr(3) for _ in range(12)], lossmult=arr(1), near=arr(1), far=arr(1),
                        cam_idx=arr(1), light_idx=arr(1),
                        impulse_response=np.arange(7, dtype=np.float32))
    return pytrees.Batch(rays=rays, rgb=arr(5, 3), impulse_response=np.ones(9, np.float32))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_gives_each_rank_its_rows(kind, world):
    batch = _batch(12, kind)
    blocks = [mesh_lib.shard_batch(batch, rank, world) for rank in range(world)]
    for name in ("origins", "far"):
        whole = getattr(batch.rays, name)
        parts = [getattr(b.rays, name) for b in blocks]
        assert all(p.shape[0] == 12 // world for p in parts)
        cat = torch.cat(parts) if kind == "torch" else np.concatenate(parts)
        assert (np.asarray(cat) == np.asarray(whole)).all()
    for rank, b in enumerate(blocks):
        assert (np.asarray(b.rgb) == np.asarray(batch.rgb)[rank * 12 // world:
                                                             (rank + 1) * 12 // world]).all()


def test_shard_batch_replicates_the_impulse_response():
    batch = _batch(8, "torch")
    for rank in range(WORLD):
        b = mesh_lib.shard_batch(batch, rank, WORLD)
        assert b.impulse_response is batch.impulse_response
        assert b.rays.impulse_response is batch.rays.impulse_response


def test_shard_batch_raises_on_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.shard_batch(_batch(9, "numpy"), 0, WORLD)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_pad_rays_to_devices(kind):
    batch = _batch(9, kind)
    padded, pad = mesh_lib.pad_rays_to_devices(batch, 4)
    assert pad == 3 and mesh_lib.leading_rows(padded) == 12
    origins = np.asarray(padded.rays.origins)
    assert (origins[:9] == np.asarray(batch.rays.origins)).all()
    assert (origins[9:] == np.asarray(batch.rays.origins)[-1]).all()
    assert padded.rays.impulse_response is batch.rays.impulse_response
    same, none = mesh_lib.pad_rays_to_devices(batch, 3)
    assert none == 0 and same is batch


def test_shard_index_is_the_padded_split():
    blocks = [mesh_lib.shard_index(5, rank, 4).tolist() for rank in range(4)]
    assert blocks == [[0, 1], [2, 3], [4, 4], [4, 4]]
    assert mesh_lib.shard_index(6, 1, 2).tolist() == [3, 4, 5]


@pytest.mark.parametrize("draw", ["uniform", "normal", "categorical"])
@pytest.mark.parametrize("per_ray", [1, 3])
def test_sharded_draws_are_the_global_draws_block(draw, per_ray):
    rows, world = 6, 2

    def sample(gen, n):
        if draw == "categorical":
            return torchutil.categorical(gen, torch.zeros(n * per_ray, 5), num=4)
        return getattr(torchutil, draw)(gen, (n * per_ray, 4), "cpu")

    whole = sample(torch.Generator().manual_seed(1), rows * world)
    for rank in range(world):
        index = torch.arange(rank * rows, (rank + 1) * rows)
        with torchutil.ray_shard(rows * world, index):
            part = sample(torch.Generator().manual_seed(1), rows)
        assert torch.equal(part, whole[rank * rows * per_ray:(rank + 1) * rows * per_ray])


def test_a_draw_without_a_ray_axis_is_the_same_on_every_rank():
    whole = torchutil.uniform(torch.Generator().manual_seed(2), (5, 4), "cpu")
    with torchutil.ray_shard(12, torch.arange(6, 12)):
        part = torchutil.uniform(torch.Generator().manual_seed(2), (5, 4), "cpu")
    assert torch.equal(part, whole)


def test_a_padded_shard_repeats_the_last_rows_draws():
    whole = torchutil.uniform(torch.Generator().manual_seed(3), (5, 2), "cpu")
    with torchutil.ray_shard(5, mesh_lib.shard_index(5, 1, 2)):
        part = torchutil.uniform(torch.Generator().manual_seed(3), (3, 2), "cpu")
    assert torch.equal(part, whole[[3, 4, 4]])


def test_a_world_of_one_creates_no_group():
    mesh = mesh_lib.create_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.device, mesh.backend) == (0, 1, "cpu", None)
    assert not dist.is_initialized()
    assert mesh_lib.process_count() == 1 and mesh_lib.process_index() == 0
    batch = _batch(9, "torch")
    assert mesh_lib.shard_batch(batch) is batch
    params = [torch.nn.Parameter(torch.ones(3))]
    params[0].grad = torch.full((3,), 2.0)
    mesh_lib.allreduce_gradients(params)
    mesh_lib.barrier()
    assert params[0].grad.tolist() == [2.0, 2.0, 2.0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_a_cuda_rank_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.create_mesh("cuda")


def test_a_rank_serves_its_block_of_the_batch(monkeypatch):
    config = flagship.cache_config(batch_size=64)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 2)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: 1)
    rank1 = datasets.SyntheticSpheres("train", None, config, num_images=3, resolution=16,
                                      device="cpu").next_train()
    monkeypatch.undo()
    alone = datasets.SyntheticSpheres(
        "train", None, dataclasses.replace(config, batch_size=32, np_rng_seed=config.np_rng_seed
                                           + 1), num_images=3, resolution=16,
        device="cpu").next_train()
    assert rank1.rgb.shape[0] == 32
    assert torch.equal(rank1.rgb, alone.rgb)
    assert torch.equal(rank1.rays.origins, alone.rays.origins)


def test_an_indivisible_global_batch_raises(monkeypatch):
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="not divisible"):
        datasets.SyntheticSpheres("train", None, flagship.cache_config(batch_size=63),
                                  num_images=2, resolution=8, device="cpu")


# --- failures ------------------------------------------------------------------------


def failing_rank(mesh):
    if mesh.rank == 1:
        raise ValueError("planted failure on rank 1")
    dist.barrier()


def mismatched_rank(mesh):
    """Rank 1 waits in an all-reduce that rank 0 never calls."""
    if mesh.rank == 1:
        dist.all_reduce(torch.ones(3))
    else:
        time.sleep(120)


def test_a_failed_rank_fails_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)failed.*planted failure on rank 1"):
        spawn("failing_rank", tmp_path)


def test_collectives_in_different_orders_fail_not_hang(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank\(s\) 1 failed"):
        spawn("mismatched_rank", tmp_path, group_timeout_s=5.0)
    assert time.monotonic() - t0 < 60


def test_an_nccl_setup_that_fails_raises_with_no_gloo_fallback(tmp_path):
    with pytest.raises(RuntimeError, match="(?i)nccl"):
        spawn("failing_rank", tmp_path, backend="nccl")


# --- two ranks against one process ---------------------------------------------------


def test_the_ranks_form_one_gloo_group(two_ranks):
    _, ranks = two_ranks
    assert [r["rank"] for r in ranks] == [(0, 2, "cpu", "gloo"), (1, 2, "cpu", "gloo")]


@pytest.mark.parametrize("stage", list(STAGES))
def test_two_rank_losses_match_one_process(two_ranks, stage):
    one, ranks = two_ranks
    want = one[stage]["losses"]
    for r in ranks:
        got = r[stage]["losses"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("stage", list(STAGES))
def test_two_rank_gradients_match_one_process(two_ranks, stage):
    one, ranks = two_ranks
    want = one[stage]["grads"]
    errs = {k: _rel_l2(ranks[0][stage]["grads"][k], g) for k, g in want.items()
            if float(g.norm()) > 0}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_FLOOR, (worst, errs[worst])
    zero = [k for k, g in want.items() if float(g.norm()) == 0]
    assert all(float(ranks[0][stage]["grads"][k].norm()) == 0 for k in zero)


@pytest.mark.parametrize("stage", list(STAGES))
def test_parameters_are_bitwise_equal_across_ranks(two_ranks, stage):
    _, ranks = two_ranks
    for k, v in ranks[0][stage]["params"].items():
        assert torch.equal(v, ranks[1][stage]["params"][k]), k


def test_a_rank_that_skips_the_all_reduce_is_caught(two_ranks):
    one, ranks = two_ranks
    want = one["cache"]["grads"]
    errs = [_rel_l2(ranks[1]["fault"][k], g) for k, g in want.items() if float(g.norm()) > 0]
    assert max(errs) > 1e3 * GRAD_FLOOR


def test_sharded_eval_render_matches_one_process(two_ranks):
    one, ranks = two_ranks
    want = one["render"]
    assert "rgb_variance" in want
    for r in ranks:  # every rank ends with the whole image
        assert sorted(r["render"]) == sorted(want)
        for k, v in want.items():
            assert r["render"][k].shape == v.shape, k
            np.testing.assert_allclose(r["render"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_dryrun_multichip_two_ranks(capsys):
    loss = mesh_lib.dryrun_multichip(2, timeout_s=SPAWN_TIMEOUT_S)
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): transient material stage sharded step OK" in (
        capsys.readouterr().out)
