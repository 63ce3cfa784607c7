"""Training entry point of the port.

Usage:
    python -m neural_radiance_caching_tpu_torch.train_with_trainer \
        --gin_configs=configs/ngp_yobo.gin \
        --gin_bindings="Config.dataset_loader='synthetic_spheres'" \
        --gin_bindings="Config.near=0.2" \
        --gin_bindings="Trainer.stage='cache'" \
        --gin_bindings="Config.checkpoint_dir='/tmp/ckpt/spheres_cache'"

The trainer runs on the card; ``--device cpu`` runs it on the CPU. Without
a card and without ``--device cpu`` it raises: there is no fallback.
"""

from __future__ import annotations

import argparse

from neural_radiance_caching_tpu_torch.engine import configs


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gin_configs", action="append", default=[], help="gin config file(s)")
    parser.add_argument("--gin_bindings", action="append", default=[],
                        help="gin binding override(s)")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--logtostderr", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    """Parse the configs, build the Trainer on --device, set it up and train;
    returns the trainer."""
    args = parse_args(argv)
    bindings = [b.strip('"') for b in args.gin_bindings]
    configs.load_config(config_files=args.gin_configs, bindings=bindings)

    from neural_radiance_caching_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(device=args.device)
    trainer.setup()
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
