"""Launch one training stage of the port for a scene.

Maps scene name -> config file, derives checkpoint directories for the stage
and its warm-start stage, parses `_resample`/`_multi_illum` stage-name
suffixes into Trainer flags, then runs
``python -m neural_radiance_caching_tpu_torch.train_with_trainer`` (on the
card, or on the CPU with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

# Scene -> config mapping (the port's own copy; entries whose config file
# exists under configs/).
SCENE_CONFIG_MAPPING = {
    # nerf-synthetic / TensoIR
    "lego": "nerf_ngp_yobo_lego",
    "hotdog": "nerf_ngp_yobo_hotdog",
    "armadillo": "nerf_ngp_yobo_armadillo",
    "ficus": "nerf_ngp_yobo_ficus",
    "lego_pano": "blender_ngp_yobo_lego",
    "lego_box": "blender_ngp_yobo_lego_box3",
    # ORB
    "gnome": "orb_ngp_yobo_gnome",
    "pitcher": "orb_ngp_yobo_pitcher",
    "cactus": "orb_ngp_yobo_cactus",
    "teapot": "orb_ngp_yobo_teapot",
    # NeILF / real captures / FIPT
    "castel": "neilf_ngp_yobo_castel",
    "neilf_cat": "neilf_cat_yobo",
    "real_000": "real_ngp_yobo_000",
    "fipt_kitchen": "synthetic_ngp_yobo_kitchen",
    # OpenIllumination
    "obj_02_egg": "open_ngp_yobo_egg",
    "obj_04_stone": "open_ngp_yobo_stone",
    "obj_05_bird": "open_ngp_yobo_bird",
    "obj_17_box": "open_ngp_yobo_box",
    "obj_26_pumpkin": "open_ngp_yobo_pumpkin",
    "obj_29_hat": "open_ngp_yobo_hat",
    "obj_35_cup": "open_ngp_yobo_cup",
    "obj_36_sponge": "open_ngp_yobo_sponge",
    "obj_42_banana": "open_ngp_yobo_banana",
    "obj_48_bucket": "open_ngp_yobo_bucket",
    "obj_car": "open_ngp_yobo_car",
    # NeRO glossy
    "glossy_bunny": "glossy_bunny_yobo",
    "glossy_vase": "glossy_vase_yobo",
    "nero_angel": "nero_ngp_yobo_angel",
    "nero_tbell": "nero_ngp_yobo_tbell",
    "nero_bell": "nero_ngp_yobo_bell",
    "nero_cat": "nero_ngp_yobo_cat",
    "nero_horse": "nero_ngp_yobo_horse",
    "nero_luyu": "nero_ngp_yobo_luyu",
    "nero_potion": "nero_ngp_yobo_potion",
    "nero_teapot": "nero_ngp_yobo_teapot",
    # InvProp simulated transients
    "cornell": "transient_simulation_ngp_yobo_cornell",
    "pots": "transient_simulation_ngp_yobo_pots",
    "peppers": "transient_simulation_ngp_yobo_peppers",
    "kitchen": "transient_simulation_ngp_yobo_kitchen",
    "spheres": "transient_simulation_ngp_yobo_spheres",
    "globe": "transient_simulation_ngp_yobo_globe",
    "house": "transient_simulation_ngp_yobo_house",
    # InvProp captured (FWP) + baselines / sensor variants
    "statue": "transient_simulation_ngp_yobo_statue",
    "kettle": "transient_simulation_ngp_yobo_kettle",
    "statue_fwp": "transient_simulation_ngp_yobo_statue_fwp",
    "kettle_fwp": "transient_simulation_ngp_yobo_kettle_fwp",
    "globe_fwp": "transient_simulation_ngp_yobo_globe_fwp",
    "house_fwp": "transient_simulation_ngp_yobo_house_fwp",
    "spheres_fwp": "transient_simulation_ngp_yobo_spheres_fwp",
    "cornell_fwp": "transient_simulation_ngp_yobo_cornell_fwp",
    "cornell_fwp_dataset": "transient_simulation_ngp_yobo_cornell_fwp_dataset",
    "peppers_fwp": "transient_simulation_ngp_yobo_peppers_fwp",
    "pots_fwp": "transient_simulation_ngp_yobo_pots_fwp",
    "statue_tnerf": "transient_simulation_ngp_yobo_statue_tnerf",
    "kettle_tnerf": "transient_simulation_ngp_yobo_kettle_tnerf",
    "spheres_tnerf": "transient_simulation_ngp_yobo_spheres_tnerf",
    "globe_tnerf": "transient_simulation_ngp_yobo_globe_tnerf",
    "house_tnerf": "transient_simulation_ngp_yobo_house_tnerf",
    "cornell_tnerf": "transient_simulation_ngp_yobo_cornell_tnerf",
    "peppers_tnerf": "transient_simulation_ngp_yobo_peppers_tnerf",
    "pots_tnerf": "transient_simulation_ngp_yobo_pots_tnerf",
    "kitchen_tnerf": "transient_simulation_ngp_yobo_kitchen_tnerf",
    "kettle_views_removed": "transient_simulation_ngp_yobo_kettle_views_removed",
    "cornell_itof": "transient_simulation_ngp_yobo_cornell_itof",
    "kitchen_itof": "transient_simulation_ngp_yobo_kitchen_itof",
    "pots_itof": "transient_simulation_ngp_yobo_pots_itof",
    "peppers_itof": "transient_simulation_ngp_yobo_peppers_itof",
    "spheres_itof": "transient_simulation_ngp_yobo_spheres_itof",
    "house_itof": "transient_simulation_ngp_yobo_house_itof",
    "cornell_steady_state": "transient_simulation_ngp_yobo_cornell_steady_state",
    "kitchen_steady_state": "transient_simulation_ngp_yobo_kitchen_steady_state",
    "pots_steady_state": "transient_simulation_ngp_yobo_pots_steady_state",
    "peppers_steady_state": "transient_simulation_ngp_yobo_peppers_steady_state",
    "spheres_steady_state": "transient_simulation_ngp_yobo_spheres_steady_state",
    "globe_steady_state": "transient_simulation_ngp_yobo_globe_steady_state",
    "house_steady_state": "transient_simulation_ngp_yobo_house_steady_state",
    "peppers_steady": "transient_simulation_steady_ngp_yobo_peppers",
    "pots_kitchen": "transient_simulation_ngp_yobo_pots_kitchen",
    # procedural test scene
    "spheres_test": "synthetic_spheres",
}


# The repository root: the configs/ files are named relative to it.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get_config_file(scene: str) -> str:
    if scene in SCENE_CONFIG_MAPPING:
        return SCENE_CONFIG_MAPPING[scene]
    raise ValueError(f"Invalid scene: {scene}; known: {sorted(SCENE_CONFIG_MAPPING)}")


def get_checkpoint_path(args) -> str:
    suffix = args.suffix or ""
    return os.path.expanduser(
        f"{args.checkpoint_root}/{args.experiment}/{args.scene}_{args.stage}{suffix}"
    )


def get_partial_checkpoint_path(args):
    if not args.take_stage:
        return None
    return os.path.expanduser(
        f"{args.checkpoint_root}/{args.experiment}/{args.scene}_{args.take_stage}"
    )


def parse_stage_flags(args):
    """`<stage>_resample[_depth]` / `<stage>_multi_illum` suffix parsing."""
    flags = {}
    if "resample_depth" in args.stage:
        flags.update(resample=True, resample_render=True, resample_depth=True)
        args.stage = args.stage.replace("_resample_depth", "")
    elif "resample" in args.stage:
        flags.update(resample=True, resample_render=True)
        args.stage = args.stage.replace("_resample", "")
    if "rotate_illum" in args.stage:
        flags.update(multi_illum=True, rotate_illum=True)
        args.stage = args.stage.replace("_rotate_illum", "")
    elif "multi_illum" in args.stage:
        flags.update(multi_illum=True)
        args.stage = args.stage.replace("_multi_illum", "")
    return flags


def build_command(args, checkpoint_dir, partial_checkpoint_dir):
    cmd = [
        sys.executable, "-m", "neural_radiance_caching_tpu_torch.train_with_trainer",
        f"--device={args.device}",
        f"--gin_configs=configs/{args.config_file}.gin",
        f"--gin_bindings=Trainer.stage='{args.stage}'",
        f"--gin_bindings=Trainer.vis_only={args.vis_only}",
        f"--gin_bindings=Trainer.vis_secondary={args.vis_secondary}",
        f"--gin_bindings=Trainer.vis_light_sampler={args.vis_light_sampler}",
        f"--gin_bindings=Trainer.vis_surface_light_field={args.vis_surface_light_field}",
        f"--gin_bindings=Trainer.stopgrad={args.stopgrad}",
        f"--gin_bindings=Trainer.resample={args.resample}",
        f"--gin_bindings=Trainer.resample_depth={args.resample_depth}",
        f"--gin_bindings=Trainer.sample_factor={args.sample_factor}",
        f"--gin_bindings=Trainer.num_resample={args.num_resample}",
        f"--gin_bindings=Trainer.resample_render={args.resample_render}",
        f"--gin_bindings=Trainer.sample_render_factor={args.sample_render_factor}",
        f"--gin_bindings=Trainer.render_repeats={args.render_repeats}",
        f"--gin_bindings=Trainer.relight={args.relight}",
        f"--gin_bindings=Config.checkpoint_dir='{checkpoint_dir}'",
        f"--gin_bindings=Config.train_render_every={args.train_render_every}",
        f"--gin_bindings=Config.no_vis={args.no_vis}",
        f"--gin_bindings=Config.train_length_mult={args.train_length_mult}",
        f"--gin_bindings=Config.lr_factor_mult={args.lr_factor_mult}",
        f"--gin_bindings=Config.batch_size={args.batch_size}",
        f"--gin_bindings=Config.render_chunk_size={args.render_chunk_size}",
        f"--gin_bindings=Config.grad_accum_steps={args.grad_accum_steps}",
        f"--gin_bindings=Config.secondary_grad_accum_steps={args.secondary_grad_accum_steps}",
        f"--gin_bindings=Config.multi_illumination={args.multi_illum}",
        f"--gin_bindings=Config.vis_only={args.vis_only}",
        f"--gin_bindings=Config.sl_relight={args.sl_relight}",
        f"--gin_bindings=Config.eval_train={args.eval_train}",
        "--logtostderr",
    ]
    if args.relight and args.env_map_name:
        cmd.append(f"--gin_bindings=Config.env_map_name='{args.env_map_name}'")
    if partial_checkpoint_dir:
        cmd.append(
            f"--gin_bindings=Config.partial_checkpoint_dir='{partial_checkpoint_dir}'"
        )
    if args.early_exit_steps > 0:
        cmd.append(f"--gin_bindings=Config.early_exit_steps={args.early_exit_steps}")
    for b in args.gin_bindings or ():
        cmd.append(f"--gin_bindings={b}")
    return cmd


def make_parser():
    parser = argparse.ArgumentParser(description="Train one stage.")
    parser.add_argument("--suffix")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("-s", "--scene", default="hotdog")
    parser.add_argument("-t", "--stage", default="cache")
    parser.add_argument("-p", "--take_stage")
    parser.add_argument("-e", "--experiment", default="synthetic")
    parser.add_argument("-c", "--config_file")
    parser.add_argument("--checkpoint_root", default="./checkpoints/yobo_results")
    parser.add_argument("-l", "--vis_only", action="store_true")
    parser.add_argument("--no_vis", action="store_true")
    parser.add_argument("--vis_secondary", action="store_true")
    parser.add_argument("--vis_light_sampler", action="store_true")
    parser.add_argument("--vis_surface_light_field", action="store_true")
    parser.add_argument("--relight", action="store_true")
    parser.add_argument("--sl_relight", action="store_true")
    parser.add_argument("--eval_train", action="store_true")
    parser.add_argument("--env_map_name")
    parser.add_argument("--resample", action="store_true")
    parser.add_argument("--resample_render", action="store_true")
    parser.add_argument("--resample_depth", action="store_true")
    parser.add_argument("--num_resample", type=int, default=1)
    parser.add_argument("--sample_factor", type=int, default=2)
    parser.add_argument("--sample_render_factor", type=int, default=2)
    parser.add_argument("--render_repeats", type=int, default=1)
    parser.add_argument("--stopgrad", action="store_true")
    parser.add_argument("--multi_illum", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8192)
    parser.add_argument("--render_chunk_size", type=int, default=8192)
    parser.add_argument("--train_length_factor", "--train_length_mult",
                        dest="train_length_mult", type=int, default=1)
    parser.add_argument("--lr_factor", dest="lr_factor_mult", type=float, default=1.0)
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--secondary_grad_accum_steps", type=int, default=1)
    parser.add_argument("--early_exit_steps", type=int, default=0)
    parser.add_argument("--train_render_every", type=int, default=1000)
    parser.add_argument(
        "--gin_bindings", action="append", default=[],
        help="Extra gin bindings appended verbatim (repeatable).",
    )
    return parser


def stage_command(argv=None, checkpoint_dir=None, partial_checkpoint_dir=None):
    """The entry point's command for a train_one_stage command line, into
    `checkpoint_dir` and warm-started from `partial_checkpoint_dir` (by
    default the directories derived from the scene and the stages)."""
    args = make_parser().parse_args(argv)
    if not args.config_file:
        args.config_file = get_config_file(args.scene)
    for k, v in parse_stage_flags(args).items():
        setattr(args, k, v)
    checkpoint_dir = checkpoint_dir or get_checkpoint_path(args)
    partial_checkpoint_dir = partial_checkpoint_dir or get_partial_checkpoint_path(args)
    return build_command(args, checkpoint_dir, partial_checkpoint_dir)


def main():
    cmd = stage_command()
    print("Executing:", " ".join(shlex.quote(c) for c in cmd))
    raise SystemExit(subprocess.call(cmd, cwd=_REPO))


if __name__ == "__main__":
    main()
