"""Data-parallel training of the port on the CPU, against the JAX package
and through the entry point.

- The port's two-rank step (two gloo processes, ``mesh.spawn``) against the
  JAX package's ``create_train_step`` on a 2-device ``Mesh`` of the test
  run's virtual CPU devices (``tests/conftest.py``): the narrow cache
  model of ``test_torch_cache_slice.py``, its numpy-seeded weights carried
  across by ``utils/weights.state_dict_from_jax``, the same global batch and
  the same random numbers (one numpy stream, ``test_torch_material_slice.
  injected``; each rank takes its block of the global draws). Held to the
  tolerances of the one-device step parity test with random draws
  (``test_torch_material_slice.py``): loss terms 1e-4 relative; the global
  gradient norm 2e-3 (its gradient rtol); the parameters after the Adam
  step within 1e-6 where the gradient's sign is determined, every step at
  most lr. JAX's
  mesh on the CPU switches its encoder to the XLA one for the whole
  process; the fixture restores the switch.
- ``train_with_trainer --device cpu`` on ``configs/synthetic_spheres.gin``'s
  cache stage under two gloo ranks for 3 steps with an evaluation: each
  rank's batch is ``batch_size // 2`` rays from numpy seed ``np_rng_seed +
  rank``, only rank 0 writes checkpoints and the log, the ranks end with
  the same parameters bit for bit, and a one-process run on that
  checkpoint restores them.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from neural_radiance_caching_tpu_torch import flagship, train_with_trainer
from neural_radiance_caching_tpu_torch.data import datasets
from neural_radiance_caching_tpu_torch.engine import gin_config as tgin
from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib
from neural_radiance_caching_tpu_torch.parallel import train
from neural_radiance_caching_tpu_torch.utils import checkpoints, torchutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 2
SPAWN_TIMEOUT_S = 300.0
DRAWS_SEED = 11
TRAIN_FRAC = 0.5


def spawn(target, tmp_path, kwargs):
    return mesh_lib.spawn(f"{__name__}:{target}", WORLD, kwargs, workdir=str(tmp_path),
                          paths=[HERE], timeout_s=SPAWN_TIMEOUT_S)


# --- against JAX's step on a 2-device mesh -------------------------------------------


class Draws:
    """The numpy stream of ``test_torch_material_slice.Draws``, here without
    its module's JAX imports (a rank imports none)."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def uniform(self, shape):
        return self.rng.random_sample(tuple(shape)).astype(np.float32)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)


def jax_parity_rank(mesh, params, state_dict, batch, batch_size):
    """One port step of the narrow cache model on this rank's block of
    `batch`, every draw taken from the numpy stream at the global shape."""
    config = flagship.cache_config(batch_size=batch_size, lr_delay_steps=0)
    model = flagship.build_flagship_cache_model(config, params, device="cpu")
    model.load_state_dict(state_dict)
    state, _ = train.create_optimizer(config, model)
    mesh_lib.replicate(model, state.optimizer)
    draws = Draws(DRAWS_SEED)
    torchutil.uniform = lambda rng, shape, device, dtype=torch.float32: torchutil.shard_draw(
        lambda s: torch.as_tensor(draws.uniform(s)), shape).to(device, dtype)
    torchutil.normal = lambda rng, shape, device, dtype=torch.float32: torchutil.shard_draw(
        lambda s: torch.as_tensor(draws.normal(s)), shape).to(device, dtype)
    state, stats = train.create_train_step(model, config)(
        torch.Generator(), state, mesh_lib.shard_batch(batch), TRAIN_FRAC)
    names = sorted(stats["losses"])
    values = mesh_lib.allreduce_mean(torch.stack(
        [stats["loss"].reshape(())] + [torch.as_tensor(stats["losses"][k]).float().reshape(())
                                       for k in names]))
    return dict(losses=dict(zip(["loss"] + names, values.tolist())),
                grad_norm=float(stats["grad_norm"]),
                grads={k: p.grad.clone() for k, p in model.named_parameters()},
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                lr=float(state.lr_fn(0)))


@pytest.fixture(scope="module")
def jax_parity(tmp_path_factory):
    import jax

    import test_torch_cache_slice as cache_slice
    import test_torch_material_slice as material_slice
    from neural_radiance_caching_tpu.ops import hashgrid as jhash
    from neural_radiance_caching_tpu.parallel import mesh as jmesh
    from neural_radiance_caching_tpu.parallel import train as jtrain

    saved = jhash._FORCE_XLA_ENCODER
    try:
        jcfg, _, jmodel, tmodel, variables, jbatch, tbatch = cache_slice.build()
        mesh = jmesh.create_mesh(jax.devices("cpu")[:WORLD])
        jstate, _ = jtrain.create_optimizer(jcfg, variables)
        step = jtrain.create_train_step(jmodel, jcfg, mesh=mesh)
        with material_slice.injected(DRAWS_SEED):
            jnew, jstats = step(jax.random.PRNGKey(0), jmesh.replicate(jstate, mesh),
                                jmesh.shard_batch(jbatch, mesh), TRAIN_FRAC)
        jnew = cache_slice._leaves(jax.device_get(jnew.params)["params"])
        jstats = jax.device_get(jstats)
    finally:
        jhash._FORCE_XLA_ENCODER = saved
    before = {k: p.detach().clone() for k, p in tmodel.named_parameters()}
    ranks = spawn("jax_parity_rank", tmp_path_factory.mktemp("jax_parity"), dict(
        params=cache_slice.narrow(flagship.flagship_cache_params()),
        state_dict=tmodel.state_dict(), batch=tbatch, batch_size=cache_slice.BATCH))
    return dict(jnew=jnew, jstats=jstats, ranks=ranks, before=before)


def test_two_rank_losses_match_jax_two_device_mesh(jax_parity):
    jstats = jax_parity["jstats"]
    for r in jax_parity["ranks"]:
        losses = r["losses"]
        assert sorted(k for k in losses if k != "loss") == sorted(jstats["losses"])
        for k, v in jstats["losses"].items():
            np.testing.assert_allclose(losses[k], float(v), rtol=1e-4, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(losses["loss"], float(jstats["loss"]), rtol=1e-4)


def test_two_rank_gradient_norm_matches_jax_two_device_mesh(jax_parity):
    for r in jax_parity["ranks"]:
        np.testing.assert_allclose(r["grad_norm"], float(jax_parity["jstats"]["grad_norm"]),
                                   rtol=2e-3)


def test_two_rank_adam_step_matches_jax_two_device_mesh(jax_parity):
    rank0 = jax_parity["ranks"][0]
    lr = rank0["lr"]
    for key, p_new in jax_parity["jnew"].items():
        p_new = p_new.T if p_new.ndim == 2 and key.endswith(".weight") else p_new
        g = rank0["grads"][key].numpy()
        t_new = rank0["params"][key].numpy()
        determined = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t_new[determined], p_new[determined], rtol=0, atol=1e-6,
                                   err_msg=key)
        moved = np.abs(t_new - jax_parity["before"][key].numpy())
        assert np.all(moved <= lr * (1 + 1e-5) + 1e-7), key
        assert torch.equal(jax_parity["ranks"][1]["params"][key], rank0["params"][key]), key


# --- the entry point under two ranks -------------------------------------------------


BINDINGS = ["Config.num_dataset_images = 2", "Config.factor = 4",
            "Config.render_chunk_size = 100", "Trainer.stage = 'cache'",
            "Config.early_exit_steps = 3", "Config.train_render_every = 3"]


SPHERES = os.path.join(REPO, "configs", "synthetic_spheres.gin")


def _argv(ckpt):
    return (["--device", "cpu", f"--gin_configs={SPHERES}"]
            + [f"--gin_bindings={b}" for b in BINDINGS + [f"Config.checkpoint_dir = '{ckpt}'"]])


def trainer_rank(mesh, ckpt):
    """train_with_trainer on this rank; returns its first train batch, the
    checkpoints it wrote, its evaluation's metrics and its parameters."""
    first, saved = [], []
    next_train, save = datasets.Dataset.next_train, checkpoints.save_checkpoint

    def recording_next_train(self):
        batch = next_train(self)
        if self.split == "train" and not first:
            first.append(batch)
        return batch

    def recording_save(checkpoint_dir, state, step, **kw):
        saved.append(step)
        return save(checkpoint_dir, state, step, **kw)

    datasets.Dataset.next_train = recording_next_train
    checkpoints.save_checkpoint = recording_save
    metrics = []
    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib

    evaluate = trainer_lib.Trainer.log_test_set_evaluation

    def recording_evaluation(self, step, train_frac):
        metrics.append(evaluate(self, step, train_frac))
        return metrics[-1]

    trainer_lib.Trainer.log_test_set_evaluation = recording_evaluation
    trainer = train_with_trainer.main(_argv(ckpt))
    return dict(first=first[0], saved=saved, metrics=metrics, device=trainer.device,
                batch_size=trainer.dataset._batch_size, step=trainer.state.step,
                params={k: v.clone() for k, v in trainer.model.state_dict().items()})


@pytest.fixture(scope="module")
def two_rank_trainer(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("trainer") / "spheres_cache")
    ranks = spawn("trainer_rank", tmp_path_factory.mktemp("trainer_ranks"), dict(ckpt=ckpt))
    tgin.clear_config()
    try:
        restored = train_with_trainer.main(_argv(ckpt))
    finally:
        tgin.clear_config()
    return ckpt, ranks, restored


def test_each_rank_draws_its_half_batch_from_its_own_seed(two_rank_trainer):
    _, ranks, restored = two_rank_trainer
    config = restored.config
    for rank, r in enumerate(ranks):
        assert r["batch_size"] == config.batch_size // WORLD == r["first"].rgb.shape[0]
        alone = datasets.load_dataset(
            "train", config.data_dir, dataclasses.replace(
                config, batch_size=config.batch_size // WORLD,
                np_rng_seed=config.np_rng_seed + rank), device="cpu").next_train()
        assert torch.equal(r["first"].rgb, alone.rgb)
        assert torch.equal(r["first"].rays.origins, alone.rays.origins)
    assert not torch.equal(ranks[0]["first"].rgb, ranks[1]["first"].rgb)


def test_only_rank_0_writes(two_rank_trainer):
    ckpt, ranks, _ = two_rank_trainer
    assert ranks[0]["saved"] == [1, 3] and ranks[1]["saved"] == []
    assert checkpoints.latest_checkpoint_step(ckpt) == 3
    logged = [json.loads(line) for line in
              open(os.path.join(ckpt, "train_log.jsonl")).read().splitlines()]
    assert [r["step"] for r in logged] == [1, 2]  # print_every = 2, one writer
    assert ranks[0]["metrics"][0]["psnr"] > 0 and ranks[1]["metrics"] == [{}]
    assert os.listdir(os.path.join(ckpt, "save"))


def test_the_ranks_end_with_the_same_parameters(two_rank_trainer):
    _, ranks, _ = two_rank_trainer
    assert ranks[0]["step"] == ranks[1]["step"] == 3
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k


def test_one_process_restores_the_ranks_parameters(two_rank_trainer):
    _, ranks, restored = two_rank_trainer
    assert restored.state.step == 3 and restored.device == "cpu"
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, ranks[0]["params"][k]), k
