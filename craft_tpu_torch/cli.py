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

# The ROADMAP.md queue item (section 2) that holds what the CLIs refuse.
ROADMAP_ARCHS = "ROADMAP.md section 2, item 6 (mode counts that leave a " \
    "mode dim below 16)"
# The shortest mode dim the port's kernels take in bf16 (their tiles' k
# step); a site's mode count must also divide its width.
MIN_MODE_DIM = 16


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


def _refuse_half(args) -> None:
    if args.f2trans == "half":
        # As the JAX package: in the reference --f2 half is a no-op
        # (do_half_attn is set at craft_nogma.py:64 and never read).
        raise SystemExit(
            "--f2 half is not supported: in the reference it is a no-op "
            "(do_half_attn is set at craft_nogma.py:64 but never read by "
            "setrans.py). Use --f2 full or --f2 none.")


def _check_ported(cfg: ModelConfig) -> None:
    """Exit, naming the ROADMAP.md item, on what the port does not run: a
    SETrans site of the family whose mode count does not divide its width
    or leaves a mode dim below 16 (the 256-wide inter, f2 and f1 sites take
    1, 2, 4, 8 and 16 modes, the 128-wide intra site 1, 2, 4 and 8)."""
    sites = [("--intermodes", cfg.inter, cfg.craft),
             ("--f2modes (--intramodes under --nogma)", cfg.f2,
              cfg.f2trans != "none" and cfg.arch != "raft"),
             ("--intramodes", cfg.intra,
              cfg.arch == "craft" and cfg.use_setrans)]
    for flag, site, built in sites:
        modes, width = site.num_modes, site.in_feat_dim
        if built and not (0 < modes <= width and width % modes == 0
                          and width // modes >= MIN_MODE_DIM):
            raise not_ported(
                f"{modes} modes at a {width}-wide site ({flag} {modes}: a "
                f"mode dim below {MIN_MODE_DIM}, or a count that does not "
                f"divide the width)", ROADMAP_ARCHS)


def model_config_from_args(args) -> ModelConfig:
    """The config the flags name, built as the JAX CLI builds it
    (``craft_tpu/cli.py:58-110``): --raft gives RAFT; --nogma craft_nogma,
    whose f2 site takes --intramodes; otherwise arch 'craft' with
    TransCorr (--craft is parsed but never read, in both packages), SETrans
    intra attention with --setrans and GMA attention without it.  Exits on
    what the port does not run."""
    _refuse_half(args)
    if args.raft:
        arch, craft, f2trans, use_setrans = "raft", False, "none", False
    elif args.nogma:
        arch, craft = "craft_nogma", True
        f2trans, use_setrans = args.f2trans, False
    else:
        arch, craft = "craft", True
        f2trans, use_setrans = args.f2trans, args.use_setrans
        if args.f1trans != "none" and f2trans == "none":
            raise SystemExit(
                f"--f1 {args.f1trans} correlates the f1 and f2 transformers' "
                f"outputs both ways: it needs --f2 full.")
    inter = inter_corr_config(
        num_modes=args.inter_num_modes, qk_have_bias=args.inter_qk_have_bias,
        pos_code_type=args.inter_pos_code_type,
        pos_code_weight=args.inter_pos_code_weight,
        pos_bias_radius=args.pos_bias_radius)
    # The f2 site takes the intra site's positional code, as the reference
    # (craft_tpu/cli.py:82-88); craft_nogma's its mode count too
    # (craft_nogma.py:77).
    f2 = f2_trans_config(
        num_modes=(args.intra_num_modes if arch == "craft_nogma"
                   else args.f2_num_modes),
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
    cfg = ModelConfig(
        arch=arch, craft=craft, f2trans=f2trans, f1trans=args.f1trans,
        use_setrans=use_setrans, corr_radius=args.corr_radius,
        iters=args.iters, num_heads=args.num_heads,
        position_only=args.position_only,
        position_and_content=args.position_and_content, inter=inter, f2=f2,
        intra=intra, dropout=args.dropout,
        mixed_precision=args.mixed_precision,
        upsample_mode=args.upsample_mode)
    _check_ported(cfg)
    return cfg
