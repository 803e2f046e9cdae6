"""The model flags (port of ``craft_tpu.cli``; reference train.py:311-404,
evaluate.py:1419-1513): the same flag surface, resolved onto the port's
``config.py``.  A combination the port does not run yet exits with a
message that names its item in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from craft_tpu_torch.config import (ModelConfig, f2_trans_config,
                                    inter_corr_config, intra_attn_config)

# ROADMAP.md queue items (section 2) that hold what the port lacks.
ROADMAP_SP = "ROADMAP.md section 2, item 8 (sequence parallelism under " \
    "lsinu and --f2radius, and across several cards)"
ROADMAP_ARCHS = "ROADMAP.md section 2, item 6 (the remaining archs)"


def not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to craft_tpu_torch yet: see "
                      f"{item}.")


# Converts the JAX package's orbax checkpoint directories into the port's
# .pth files; it needs JAX and orbax, which the port never imports.
JAX_CHECKPOINT_TOOL = "tools/jax_checkpoint_to_pth.py"


def refuse_jax_checkpoint(path, flag: str) -> None:
    """Exit when `path` is a directory: a checkpoint of the JAX package,
    which the port reads only once the tool has converted it."""
    if path and os.path.isdir(path):
        raise SystemExit(
            f"{flag} {path} is a directory, a checkpoint of the JAX "
            f"package (orbax), which craft_tpu_torch does not read. Convert "
            f"it where JAX and orbax are installed: python "
            f"{JAX_CHECKPOINT_TOOL} {path} OUT.pth <the training run's "
            f"model and schedule flags>, then pass OUT.pth.")


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--craft", action="store_true",
                   help="use CRAFT (cross-attentional correlation)")
    p.add_argument("--setrans", dest="use_setrans", action="store_true",
                   help="use SETrans intra-frame attention (vs GMA)")
    p.add_argument("--raft", action="store_true", help="RAFT baseline")
    p.add_argument("--nogma", action="store_true", help="CRAFT without GMA")
    p.add_argument("--radius", dest="corr_radius", type=int, default=4)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--mixed_precision", action="store_true", default=False)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--num_heads", default=1, type=int)
    p.add_argument("--position_only", default=False, action="store_true")
    p.add_argument("--position_and_content", default=False,
                   action="store_true")
    p.add_argument("--posr", dest="pos_bias_radius", type=int, default=7)
    p.add_argument("--f1", dest="f1trans", type=str,
                   choices=["none", "shared", "private"], default="none")
    p.add_argument("--f2", dest="f2trans", type=str,
                   choices=["none", "full", "half"], default="full")
    p.add_argument("--f2posw", dest="f2_pos_code_weight", type=float,
                   default=0.5)
    p.add_argument("--f2radius", dest="f2_attn_mask_radius", type=int,
                   default=-1)
    p.add_argument("--intermodes", dest="inter_num_modes", type=int, default=4)
    p.add_argument("--intramodes", dest="intra_num_modes", type=int, default=4)
    p.add_argument("--f2modes", dest="f2_num_modes", type=int, default=4)
    p.add_argument("--interqknobias", dest="inter_qk_have_bias",
                   action="store_false")
    p.add_argument("--interpos", dest="inter_pos_code_type", type=str,
                   choices=["lsinu", "bias"], default="bias")
    p.add_argument("--interposw", dest="inter_pos_code_weight", type=float,
                   default=0.5)
    p.add_argument("--intrapos", dest="intra_pos_code_type", type=str,
                   choices=["lsinu", "bias"], default="bias")
    p.add_argument("--intraposw", dest="intra_pos_code_weight", type=float,
                   default=1.0)
    p.add_argument("--upsample_mode", type=str,
                   choices=["all", "packed", "final"], default="all",
                   help="convex-upsample output layout (value-identical)")


def _check_ported(args) -> None:
    """Exit, naming the ROADMAP.md item, on what the port does not run."""
    if args.f2trans == "half":
        # As the JAX package: in the reference --f2 half is a no-op
        # (do_half_attn is set at craft_nogma.py:64 and never read).
        raise SystemExit(
            "--f2 half is not supported: in the reference it is a no-op "
            "(do_half_attn is set at craft_nogma.py:64 but never read by "
            "setrans.py). Use --f2 full or --f2 none.")
    gma = not args.raft and not args.nogma and not args.use_setrans
    checks = [
        ("--raft", args.raft, ROADMAP_ARCHS),
        ("--nogma", args.nogma, ROADMAP_ARCHS),
        ("GMA attention (no --setrans)", gma, ROADMAP_ARCHS),
        ("--position_only / --position_and_content (GMA)",
         args.position_only or args.position_and_content, ROADMAP_ARCHS),
        ("--f1 shared / private", args.f1trans != "none", ROADMAP_ARCHS),
        ("--f2 none", args.f2trans == "none", ROADMAP_ARCHS),
        ("--upsample_mode packed", args.upsample_mode == "packed",
         ROADMAP_ARCHS),
        ("mode counts other than 4 (--intermodes, --intramodes, --f2modes)",
         (args.inter_num_modes, args.intra_num_modes,
          args.f2_num_modes) != (4, 4, 4), ROADMAP_ARCHS)]
    for what, on, item in checks:
        if on:
            raise not_ported(what, item)


def model_config_from_args(args) -> ModelConfig:
    """The full-CRAFT config the flags name (arch 'craft' with the f2
    transformer, SETrans intra attention and TransCorr), or SystemExit."""
    _check_ported(args)
    inter = inter_corr_config(
        num_modes=args.inter_num_modes, qk_have_bias=args.inter_qk_have_bias,
        pos_code_type=args.inter_pos_code_type,
        pos_code_weight=args.inter_pos_code_weight,
        pos_bias_radius=args.pos_bias_radius)
    # The f2 site takes the intra site's positional code, as the reference
    # (craft_tpu/cli.py:82-88).
    f2 = f2_trans_config(num_modes=args.f2_num_modes,
                         pos_code_type=args.intra_pos_code_type,
                         pos_code_weight=args.f2_pos_code_weight,
                         pos_bias_radius=args.pos_bias_radius,
                         attn_mask_radius=args.f2_attn_mask_radius)
    intra = intra_attn_config(num_modes=args.intra_num_modes,
                              pos_code_type=args.intra_pos_code_type,
                              pos_code_weight=args.intra_pos_code_weight,
                              pos_bias_radius=args.pos_bias_radius)
    if args.mixed_precision:
        # int8 fixed-point intra probs ride with mixed precision (the
        # serving config), as config.craft_config.
        intra = dataclasses.replace(intra, quantize_probs=True)
    return ModelConfig(
        arch="craft", craft=True, f2trans=args.f2trans, f1trans="none",
        use_setrans=True, corr_radius=args.corr_radius, iters=args.iters,
        num_heads=args.num_heads, inter=inter, f2=f2, intra=intra,
        dropout=args.dropout, mixed_precision=args.mixed_precision,
        upsample_mode=args.upsample_mode)
