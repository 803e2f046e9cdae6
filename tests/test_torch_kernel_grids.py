"""The scratch the wrappers size against the grids the kernels launch, and
the shared memory of the sweep that B3, B9, B6 and B6 dense share.

B1's partial maxima, the fp64 partial sums of B3's and B9's stats sweep and
of B6 backward's agg_w gradient are one per block, B4's (max, sum) pairs
one per row of a block, and B7's row terms one per row of its row tiles,
so the wrapper's count must equal the kernel's grid: a
smaller buffer is written past, a larger one leaves partials that the
second pass reads unset.  The kernels refuse a count other than their own
on the card; here, without a compiler, the tile constants are read from the
CUDA sources and the grids they give (the launchers' formulas, written out
below) are held against the wrapper's counts at the shapes the paths run.
The same constants give each instantiation of the sweep's body its shared
memory, which must fit the 232,448 bytes a block may have on an H100.

B10's backward sizes its weight-gradient partials by its row splits
(wgrad_splits, refused otherwise), both its directions carve one scratch
buffer by a rule the wrapper repeats (another size is refused), and its
bf16 tile bodies' rings, forward and backward, must fit a block; B5's
backward cuts each level into items of whole 16-byte units, which must
cover every unit once and touch no more queries than an item's static
shared memory holds.
"""

import re
from pathlib import Path

import pytest

from craft_tpu_torch.ops.kernels import corr_vjp as cv
from craft_tpu_torch.ops.kernels import mode_attention as ma
from craft_tpu_torch.ops.kernels import probs_vjp as pv
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg

CSRC = Path(ma.__file__).resolve().parents[2] / "csrc"


def _defines(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^#define\s+(\w+)\s+(\d+)\b", text, re.MULTILINE)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _source_partials():
    """(B1 partials, B3 partial doubles, B4 pairs) as the sources'
    launchers count them: scores_max.cu max_partials, agg_modes.cuh
    sweep_grid, softmax_probs.cu probs_partials."""
    common, agg = _defines("common.cuh"), _defines("agg_modes.cuh")
    b1, b3 = _defines("scores_max.cu"), agg
    b4 = _defines("softmax_probs.cu")

    def b1_partials(BM, U1, U2, bf16):
        if not bf16:
            return BM * _cdiv(U1, common["TILE"])
        return (BM * _cdiv(U1, b1["B1_ROWS"])
                * _cdiv(_cdiv(U2, b1["B1_KEYS"]), b1["B1_KCHUNK"]))

    def b3_partials(B, U1, U2, bf16):
        if bf16:
            blocks = (_cdiv(U1, b3["B3_ROWS"])
                      * _cdiv(_cdiv(U2, b3["B3_KEYS"]), b3["B3_KGROUP"]))
        else:
            blocks = (_cdiv(U1, common["TILE"])
                      * _cdiv(_cdiv(U2, common["TILE"]), agg["KGROUP"]))
        return 2 * B * blocks

    def b4_pairs(BM, U1, U2, bf16):
        if not bf16:
            return 0
        return (BM * _cdiv(U1, b4["B4_ROWS"])
                * _cdiv(_cdiv(U2, b4["B4_KEYS"]), b4["B4_KCHUNK"])
                * b4["B4_ROWS"])
    return b1_partials, b3_partials, b4_pairs


def test_the_launchers_count_from_these_constants():
    """The formulas above are the launchers': each names its constants."""
    b1 = (CSRC / "scores_max.cu").read_text()
    body = b1[b1.index("static int max_partials"):]
    body = body[:body.index("\n}\n")]
    for name in ("TILE", "B1_ROWS", "B1_KEYS", "B1_KCHUNK"):
        assert name in body, name
    b3 = (CSRC / "agg_modes.cuh").read_text()
    body = b3[b3.index("static dim3 sweep_grid"):]
    body = body[:body.index("\n}\n")]
    for name in ("TILE", "KGROUP", "B3_ROWS", "B3_KEYS", "B3_KGROUP"):
        assert name in body, name
    b4 = (CSRC / "softmax_probs.cu").read_text()
    body = b4[b4.index("static int probs_partials"):]
    body = body[:body.index("\n}\n")]
    for name in ("B4_ROWS", "B4_KEYS", "B4_KCHUNK"):
        assert name in body, name


# Where each kind of kernel chooses its body: the per-mode launchers (B1,
# B4/B4 dense, B7), B2/B8 (wgmma for bf16 at every mode dim they take) and
# the aggregating ones (B3/B9, B6, B6 dense, B6 backward).
BODY_CHOICE = {"mma_body": ("scores_max.cu", "softmax_probs.cu",
                            "probs_bwd.cu"),
               "flash_mma_body": ("flash_attn.cu",),
               "agg_mma_body": ("corr_norm.cu", "agg_corr.cu")}
DEFINED_IN = {"mma_body": "common.cuh", "flash_mma_body": "common.cuh",
              "agg_mma_body": "agg_modes.cuh"}


def test_the_body_choice_is_defined_once_and_mirrored():
    """Each kind's wgmma-or-FMA choice is one constexpr predicate
    (common.cuh mma_body and flash_mma_body, agg_modes.cuh agg_mma_body)
    that every launcher of that kind calls and no source restates; the
    wrappers' mirrors, which size the scratch, give the same answer at
    every count and dim."""
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cu*")}
    for pred, users in BODY_CHOICE.items():
        defined = [n for n, t in sources.items()
                   if re.search(rf"constexpr bool {pred}\(", t)]
        assert defined == [DEFINED_IN[pred]], defined
        for name in users:
            assert re.search(rf"\b{pred}\(", sources[name]), (pred, name)
    # B2/B8 take their own predicate, not the per-mode kernels'.
    assert not re.search(r"\bmma_body\(", sources["flash_attn.cu"])
    for limit, pred in (("MAXMD", "mma_body"),
                        ("MAXMD_FMA", "flash_mma_body")):
        restated = [n for n, t in sources.items()
                    if re.search(rf"bf16 &&[^;]*md <= {limit}\b", t)]
        assert restated == ["common.cuh"], (pred, restated)
    common, agg = _defines("common.cuh"), _defines("agg_modes.cuh")
    for bf16 in (0, 1):
        for md in (8, 16, 32, 64, 128, 256):
            mma = bool(bf16) and md <= common["MAXMD"]
            assert ma.mma_body(bf16, md) == mma
            assert ma.flash_mma_body(bf16, md) == (
                bool(bf16) and md <= common["MAXMD_FMA"])
            for F in ma.FLASH_FEAT:
                assert ma.flash_pipe_body(bf16, md, F) == (
                    bool(bf16) and (F == 128 or md > common["MAXMD"]))
            for M in ma.AGG_MODES:
                assert ma.agg_mma_body(bf16, M, md) == (
                    mma and M == agg["NMODES"])


# (label, batch, query rows U1, keys U2): serving 440x1024, chairs 368x496
# (batch 8), KITTI 376x1248, and the serving grid's row shards at 2 and 4
# ranks (28/27 and 14/13 rows of 128 tokens).
SHAPES = [("serving", 1, 7040, 7040), ("chairs", 8, 2852, 2852),
          ("kitti", 1, 7332, 7332), ("shard 2 of 2", 1, 27 * 128, 7040),
          ("shard 1 of 2", 1, 28 * 128, 7040),
          ("shard 4 of 4", 1, 13 * 128, 7040)]


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,batch,u1,u2", SHAPES)
def test_b1_partials_follow_the_grid(label, batch, u1, u2, bf16):
    b1_partials, _, _ = _source_partials()
    assert ma.scores_max_partials(batch * 4, u1, u2, bf16) == \
        b1_partials(batch * 4, u1, u2, bf16)


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,batch,u1,u2", SHAPES)
def test_b3_b9_partials_follow_the_grid(label, batch, u1, u2, bf16):
    _, b3_partials, _ = _source_partials()
    assert ma.corr_partials(batch, u1, u2, bf16) == \
        b3_partials(batch, u1, u2, bf16)


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,batch,u1,u2", SHAPES)
def test_b4_pairs_follow_the_grid(label, batch, u1, u2, bf16):
    _, _, b4_pairs = _source_partials()
    assert ma.probs_partials(batch * 4, u1, u2, bf16) == \
        b4_pairs(batch * 4, u1, u2, bf16)


def _training_scratch():
    """(B6 backward partials, B7 row terms) as the sources' launchers count
    them: agg_corr.cu bwd_grid (agg_grid for fp32), probs_bwd.cu
    probs_rowterm_size."""
    common, agg = _defines("common.cuh"), _defines("agg_modes.cuh")
    b6, b7 = _defines("agg_corr.cu"), _defines("probs_bwd.cu")

    def b6_partials(B, U, bf16):
        if bf16:
            return (B * _cdiv(U, b6["B6B_ROWS"])
                    * _cdiv(_cdiv(U, b6["B6B_KEYS"]), b6["B6B_KGROUP"]))
        nq = _cdiv(U, common["TILE"])
        return B * nq * _cdiv(nq, agg["KGROUP"])

    def b7_rows(BM, U, bf16):
        return BM * _cdiv(U, b7["B7_ROWS"]) * b7["B7_ROWS"] if bf16 else 0
    return b6_partials, b7_rows


def test_the_training_launchers_count_from_these_constants():
    b6 = (CSRC / "agg_corr.cu").read_text()
    for fn, names in (("static dim3 bwd_grid", ("agg_grid", "B6B_ROWS",
                                                "B6B_KEYS", "B6B_KGROUP")),
                      ("static dim3 agg_grid", ("TILE", "KGROUP"))):
        body = b6[b6.index(fn):]
        body = body[:body.index("\n}\n")]
        for name in names:
            assert name in body, (fn, name)
    b7 = (CSRC / "probs_bwd.cu").read_text()
    body = b7[b7.index("static long long probs_rowterm_size"):]
    body = body[:body.index("\n}\n")]
    assert "B7_ROWS" in body


# (label, batch, U) of B6 backward and B7: chairs 368x496 (batch 8), the
# serving and KITTI grids, and the card tests' 20 x 62 grid (batch 2).
TRAIN_SHAPES = [("chairs", 8, 2852), ("serving", 1, 7040),
                ("kitti", 1, 7332), ("card test", 2, 1240)]


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,batch,u", TRAIN_SHAPES)
def test_b6_backward_partials_follow_the_grid(label, batch, u, bf16):
    b6_partials, _ = _training_scratch()
    assert cv.bwd_partials(batch, u, bf16) == b6_partials(batch, u, bf16)


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,batch,u", TRAIN_SHAPES)
def test_b7_row_terms_follow_the_grid(label, batch, u, bf16):
    _, b7_rows = _training_scratch()
    assert pv.probs_rowterm_size(batch * 4, u, bf16) == \
        b7_rows(batch * 4, u, bf16)


def test_the_chairs_training_grids():
    """The block counts the sources' notes state at chairs (U = 2852,
    batch 8): B6 backward 45 x 5 x 8 = 1800 blocks; B7's row terms 32 x
    45 x 64."""
    assert cv.bwd_partials(8, 2852, 1) == 1800
    assert pv.probs_rowterm_size(32, 2852, 1) == 32 * 45 * 64


def test_the_serving_grids():
    """The block counts the sources' notes state: B1 55 x 4 x 7 = 1540,
    B3 55 x 14 = 770 a sample, B4 4 x 7 x 55 = 1540 blocks of 128 rows."""
    assert ma.scores_max_partials(4, 7040, 7040, 1) == 1540
    assert ma.corr_partials(1, 7040, 7040, 1) == 2 * 770
    assert ma.probs_partials(4, 7040, 7040, 1) == 1540 * 128


# ------------------------------------------- the sweep's shared memory

SMEM_PER_BLOCK = 232448  # an H100 block's most, static and dynamic
MDPS = (16, 32, 64)
BIASES = ("window", "none", "table")


def _bias_bytes(bias: str) -> tuple:
    """(bytes a ring stage takes beside the k tiles, bytes after the ring)
    of the sweep's bias sources (wgmma.cuh CorrWindow = MmaWindowT,
    MmaNoBias, CorrTable = MmaTableT at agg_modes.cuh's tile)."""
    agg, common = _defines("agg_modes.cuh"), _defines("common.cuh")
    if bias == "window":
        return 0, (common["MAXWIN"] * 4 + 15) // 16 * 16
    if bias == "table":
        return agg["B3_ROWS"] * agg["B3_KEYS"] * 4, 0
    return 0, 0


# The body's static shared memory: its fp64 sums red[2][B3_THREADS / 32]
# (256 bytes), which ptxas reports as 1024 bytes for the stats sweep (the
# dynamic tiles' 1024-byte alignment).
STATIC_SMEM = 1024


def _sweep_smem(mdp: int, bias: str) -> int:
    """agg_modes.cuh sweep_smem<MDP, Bias>() and the static bytes."""
    agg = _defines("agg_modes.cuh")
    stage, after = _bias_bytes(bias)
    stages = agg["B3_TABLE_STAGES"] if stage else agg["B3_STAGES"]
    dynamic = (agg["NMODES"] * agg["B3_ROWS"] * mdp * 2
               + stages * (agg["NMODES"] * agg["B3_KEYS"] * mdp * 2 + stage
                           + 16) + after + 1024)
    assert 2 * agg["B3_THREADS"] // 32 * 8 <= STATIC_SMEM
    return dynamic + STATIC_SMEM


def test_the_sweep_smem_follows_these_constants():
    """The formulas above are the sources': sweep_smem and sweep_stages
    name their constants, the bias sources state their bytes, and every
    launcher of the body sizes it with sweep_smem."""
    agg = (CSRC / "agg_modes.cuh").read_text()
    for fn, names in (("constexpr size_t sweep_smem", (
            "NMODES", "B3_ROWS", "B3_KEYS", "Bias::STAGE", "Bias::SMEM",
            "sweep_stages", "1024")),
            ("constexpr int sweep_stages", ("B3_TABLE_STAGES",
                                            "B3_STAGES"))):
        body = agg[agg.index(fn):]
        body = body[:body.index("\n}\n")]
        for name in names:
            assert name in body, (fn, name)
    assert "__shared__ double red[2][B3_THREADS / 32];" in agg
    assert "typedef MmaWindowT<B3_ROWS, B3_KEYS, B3_THREADS> CorrWindow;" \
        in agg
    assert "typedef MmaTableT<B3_ROWS, B3_KEYS, B3_THREADS> CorrTable;" in agg
    mma = (CSRC / "wgmma.cuh").read_text()
    for struct, decl in (
            ("struct MmaWindowT", "STAGE = 0, SMEM = (MAXWIN * 4 + 15) / 16 "
                                  "* 16;"),
            ("struct MmaNoBias", "STAGE = 0, SMEM = 0;"),
            ("struct MmaTableT", "STAGE = ROWS * KEYS * 4, SMEM = 0;")):
        body = mma[mma.index(struct):]
        assert decl in body[:body.index("\n};\n")], struct
    for src, calls in (("corr_norm.cu", ("sweep_smem<MDP, CorrWindow>()",)),
                       ("agg_corr.cu", ("sweep_smem<MDP, Bias>()",))):
        text = (CSRC / src).read_text()
        for call in calls:
            assert call in text, (src, call)
    text = (CSRC / "agg_corr.cu").read_text()
    for bias in ("CorrWindow", "MmaNoBias", "CorrTable"):
        assert f"launch_fwd<{bias}," in text, bias
    # B6's bf16 forward launches B3's sweep grid, so its blocks are those
    # the B3 partials above count.
    body = text[text.index("static int launch_fwd_md"):]
    assert "sweep_grid(B, ba.U1, ba.U2, 1)" in body[:body.index("\n}\n")]


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("mdp", MDPS)
def test_every_sweep_fits_a_block(mdp, bias):
    assert _sweep_smem(mdp, bias) <= SMEM_PER_BLOCK


def test_the_sweeps_shared_memory_at_md_64():
    """The bytes the sources' notes state: B3's sweep 194 KB (q 64 KB, a
    4-stage ring of 32 KB), B6 dense's with a table 194 KB too (a 2-stage
    ring of 64 KB)."""
    assert _sweep_smem(64, "window") // 1024 == 194
    assert _sweep_smem(64, "table") // 1024 == 194


def test_the_chairs_forward_grid():
    """B6's bf16 forward at chairs (U = 2852, batch 8): 23 x 6 x 8 = 1104
    blocks, as agg_corr.cu's note states."""
    _, b3_partials, _ = _source_partials()
    assert b3_partials(8, 2852, 2852, 1) == 2 * 1104


# ------------------------------------------------- B10's backward

def _gru_defines() -> dict:
    return _defines("sep_conv_gru.cu")


def _gru_splits(rows: int, bf16: int) -> int:
    """sep_conv_gru.cu wgrad_splits, from its constants."""
    d = _gru_defines()
    most, least = ((d["GW_SPLITS"], d["GW_SPLIT_ROWS"]) if bf16
                   else (d["FW_SPLITS"], d["FW_SPLIT_ROWS"]))
    return max(1, min(most, rows // least))


def test_the_gru_launcher_counts_from_these_constants():
    """wgrad_splits names the constants above, the launcher refuses another
    count, and the bf16 weight-gradient grid is (channel tiles x column
    tiles, 15, splits) of Tiles' rows."""
    text = (CSRC / "sep_conv_gru.cu").read_text()
    body = text[text.index("int wgrad_splits(int rows, int io_bf16)"):]
    body = body[:body.index("\n}\n")]
    for name in ("GW_SPLITS", "FW_SPLITS", "GW_SPLIT_ROWS", "FW_SPLIT_ROWS"):
        assert name in body, name
    assert "if (nsplit != wgrad_splits(geo.rows, in_bf16))" in text
    assert ("wgrad_k<<<dim3(cdiv(Cin, WT::ROWS) * nh, 3 * TAPS, nsplit)"
            in text)
    assert "static constexpr int THREADS = 128 * GB_WG, ROWS = 64 * GB_WG;" \
        in text


# (label, rows): chairs (8 x 46 x 62), serving (55 x 128), the checks'
# ragged grid (2 x 37 x 61) and the card tests' small ones.
GRU_ROWS = [("chairs", 22816), ("serving", 7040), ("ragged", 4514),
            ("card test", 280), ("tiny", 90)]


@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,rows", GRU_ROWS)
def test_b10_backward_splits_follow_the_grid(label, rows, bf16):
    assert sg.wgrad_splits(rows, bool(bf16)) == _gru_splits(rows, bf16)


def test_the_chairs_gru_backward_grid():
    """At chairs (22,816 rows, Ch 128, Cx 384) the bf16 weight gradients
    run 2 channel tiles x 15 (gate, tap) x 4 splits = 120 blocks, one wave
    of one block an SM, over 15.7 MB of partials (the fp32 body's 16 splits
    wrote 62.9 MB)."""
    d = _gru_defines()
    splits = _gru_splits(22816, 1)
    blocks = _cdiv(512, 64 * d["GB_WG"]) * _cdiv(128, d["GB_COLS"]) * 15 \
        * splits
    assert (splits, blocks) == (4, 120)
    per_split = 15 * 512 * 128 + 3 * 128
    assert splits * per_split * 4 < 16e6 < _gru_splits(22816, 0) \
        * per_split * 4


def _gru_tiles_smem(stages: int) -> int:
    """sep_conv_gru.cu Tiles<ST>::SMEM."""
    d = _gru_defines()
    a = 64 * d["GB_WG"] * d["GB_DEPTH"] * 2
    b = d["GB_COLS"] * d["GB_DEPTH"] * 2
    return stages * (a + b) + 2 * stages * 8 + 1024


def test_the_gru_tiles_smem_follows_these_constants():
    text = (CSRC / "sep_conv_gru.cu").read_text()
    body = text[text.index("struct Tiles {"):]
    body = body[:body.index("\n};\n")]
    for decl in ("A = ROWS * GB_DEPTH * 2;", "B = GB_COLS * GB_DEPTH * 2;",
                 "STAGE = A + B;", "SMEM = ST * STAGE + 2 * ST * 8 + 1024;"):
        assert decl in body, decl
    for inst in ("using TT = Tiles<GB_TSTAGES>;",
                 "using WT = Tiles<GB_WSTAGES>;"):
        assert inst in text, inst


@pytest.mark.parametrize("stages", ["GB_TSTAGES", "GB_WSTAGES"])
def test_every_gru_backward_body_fits_a_block(stages):
    assert _gru_tiles_smem(_gru_defines()[stages]) <= SMEM_PER_BLOCK


# ------------------------------------------------- B10's forward

# An H100 SM's shared memory, of which each resident block also takes 1 KB.
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
SMS = 132


def _gru_fwd_smem(gates: int, stages: int) -> int:
    """sep_conv_gru.cu FTiles<NG, ST>::SMEM."""
    d = _gru_defines()
    a = d["GF_ROWS"] * d["GB_DEPTH"] * 2
    return stages * (a + gates * d["GF_TILE"]) + 2 * stages * 8 + 1024


def test_the_gru_forward_follows_these_constants():
    """FTiles' shared memory, the two launches' bodies and their grid are
    the formulas here, and a gate's stage of weights is GF_TILE bytes."""
    text = (CSRC / "sep_conv_gru.cu").read_text()
    body = text[text.index("struct FTiles {"):]
    body = body[:body.index("\n};\n")]
    for decl in ("ROWS = GF_ROWS, THREADS = 128 * NG;",
                 "A = ROWS * GB_DEPTH * 2;", "STAGE = A + NG * GF_TILE;",
                 "SMEM = ST * STAGE + 2 * ST * 8 + 1024;"):
        assert decl in body, decl
    for inst in ("using ZT = FTiles<2, GF_ZSTAGES>;",
                 "using QT = FTiles<1, GF_QSTAGES>;",
                 "const dim3 grid(cdiv(g.rows, ZT::ROWS), nct);",
                 "__launch_bounds__(ZR ? 256 : 128, ZR ? 1 : 3)",
                 "zr_k<<<grid, ZT::THREADS, ZT::SMEM, st>>>",
                 "q_k<<<grid, QT::THREADS, QT::SMEM, st>>>",
                 "GB_COLS * GB_DEPTH * 2 == GF_TILE"):
        assert inst in text, inst
    d = _gru_defines()
    assert d["GF_TILE"] == sg.GF_TILE


@pytest.mark.parametrize("gates,stages", [(2, "GF_ZSTAGES"),
                                          (1, "GF_QSTAGES")])
def test_every_gru_forward_body_fits_a_block(gates, stages):
    assert _gru_fwd_smem(gates, _gru_defines()[stages]) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("label,rows,blocks,waves", [
    ("serving", 7040, 110, (0.83, 0.28)),
    ("chairs", 22816, 357, (2.70, 0.90))])
def test_the_gru_forward_grids(label, rows, blocks, waves):
    """PERF.md's block counts of the bf16 forward at Ch 128: each launch
    110 blocks at serving and 357 at chairs; the z | r launch one block an
    SM and the q launch three, by their shared memory (and its launch
    bounds), so waves of 0.83 and 0.28 at serving, 2.70 and 0.90 at
    chairs."""
    d = _gru_defines()
    assert _cdiv(rows, d["GF_ROWS"]) * _cdiv(128, d["GB_COLS"]) == blocks
    per_sm = [SMEM_PER_SM // (_gru_fwd_smem(gates, d[st]) + SMEM_RESERVED)
              for gates, st in ((2, "GF_ZSTAGES"), (1, "GF_QSTAGES"))]
    assert per_sm == [1, 3]
    assert tuple(round(blocks / (n * SMS), 2) for n in per_sm) == waves


def _gru_scratch(rows: int, Ch: int, Cx: int, bf16: int) -> tuple:
    """(forward, backward) scratch bytes as sep_conv_gru.cu's
    fwd_scratch_bytes and bwd_scratch_bytes count them."""
    d = _gru_defines()

    def up(n):
        return _cdiv(n, d["SCRATCH_ALIGN"]) * d["SCRATCH_ALIGN"]
    n, io = rows * Ch, 2 if bf16 else 4
    images = (3 * 5 * (_cdiv(Ch, d["GB_DEPTH"]) + _cdiv(Cx, d["GB_DEPTH"]))
              * _cdiv(Ch, d["GB_COLS"]) * d["GF_TILE"]) if bf16 else 0
    per_split = 15 * (Ch + Cx) * Ch + 3 * Ch
    return (up(4 * n) + up(io * n) + images,
            4 * up(io * n) + up(4 * n)
            + up(4 * _gru_splits(rows, bf16) * per_split))


def test_the_gru_scratch_rules_name_their_pieces():
    """Each launcher refuses another scratch size and carves the pieces
    that its rule counts, in that order."""
    text = (CSRC / "sep_conv_gru.cu").read_text()
    for piece in (
            "return align_up(4 * n) + align_up((io_bf16 ? 2 : 4) * n) + "
            "images;",
            "ep.zf = sc.take<float>(4 * n);\n  ep.rh = sc.take<bf16>(2 * n);"
            "\n  uint4* images = reinterpret_cast<uint4*>(sc.p);",
            "float* zf = sc.take<float>(4 * n);\n"
            "  float* rh = sc.take<float>(4 * n);",
            "if (scratch_bytes != fwd_scratch_bytes(g.rows, Ch, Cx, in_bf16))",
            "return 4 * align_up((io_bf16 ? 2 : 4) * n) + align_up(4 * n) +\n"
            "         align_up(4 * nsplit * per_split);",
            "if (scratch_bytes != bwd_scratch_bytes(geo.rows, Ch, Cx, nsplit, "
            "in_bf16))"):
        assert piece in text, piece


@pytest.mark.parametrize("Ch,Cx", [(128, 384), (16, 24)])
@pytest.mark.parametrize("bf16", [1, 0])
@pytest.mark.parametrize("label,rows", GRU_ROWS)
def test_b10_scratch_follows_the_rule(label, rows, bf16, Ch, Cx):
    assert (sg.fwd_scratch_bytes(rows, Ch, Cx, bool(bf16)),
            sg.bwd_scratch_bytes(rows, Ch, Cx, bool(bf16))) == \
        _gru_scratch(rows, Ch, Cx, bf16)


def test_the_bf16_forward_images_are_the_taps():
    """At Ch 128, Cx 384 the stage images hold the bf16 taps exactly: 3
    gates x 5 taps x 512 x 128 x 2 bytes, no padding."""
    assert sg.fwd_scratch_bytes(0, 128, 384, True) == 3 * 5 * 512 * 128 * 2


# ------------------------------------------------- B5's backward

def _lookup_defines() -> dict:
    return _defines("corr_lookup.cu")


def _qmax(r: int) -> int:
    d = _lookup_defines()
    return min(d["B5B_CBUF"] // (2 * r + 2) ** 2, d["B5B_QMAX"])


def _lookup_plan(shapes, Q, r, esz):
    """corr_lookup.cu plan_items: per level (its first item, its items,
    units an item, the level's units), the smallest level's items first."""
    d = _lookup_defines()
    ue, items, plan = 16 // esz, 0, {}
    for lvl in range(len(shapes) - 1, -1, -1):
        hw = shapes[lvl][0] * shapes[lvl][1]
        units = (Q * hw * esz + 15) // 16
        ub = max(1, min(d["B5B_RUN"], (_qmax(r) - 1) * hw // ue)) if hw \
            else 1
        n = _cdiv(units, ub)
        plan[lvl] = (items, n, ub, units)
        items += n
    return plan, items


def test_the_lookup_plan_follows_these_constants():
    text = (CSRC / "corr_lookup.cu").read_text()
    for fn, names in (("static inline int item_units", ("B5B_RUN",)),
                      ("__host__ __device__ constexpr int qmax",
                       ("B5B_CBUF", "B5B_QMAX")),
                      ("static int plan_items", ("item_units", "qmax(r)",
                                                 "l = L - 1; l >= 0; --l"))):
        body = text[text.index(fn):]
        body = body[:body.index("\n}\n")]
        for name in names:
            assert name in body, (fn, name)


# (label, batch, H8, W8, level type): chairs, serving, the oracle and the
# checks' odd-slab grid (11 x 15: 165, 35, 6 and 1 values a query).
LOOKUP_GRIDS = [("chairs", 8, 46, 62, 2), ("serving", 1, 55, 128, 2),
                ("oracle", 1, 16, 16, 4), ("odd slabs", 3, 11, 15, 2),
                ("odd slabs fp32", 3, 11, 15, 4)]


@pytest.mark.parametrize("radius", [0, 1, 4, 7])
@pytest.mark.parametrize("label,batch,h8,w8,esz", LOOKUP_GRIDS)
def test_b5_backward_units_cover_each_level_once(label, batch, h8, w8, esz,
                                                 radius):
    """The items of a launch tile [0, items) level by level, and each
    level's items cover its units once; no item touches more queries than
    its shared memory holds."""
    Q = batch * h8 * w8
    shapes = [(h8 >> lvl, w8 >> lvl) for lvl in range(4)]
    plan, items = _lookup_plan(shapes, Q, radius, esz)
    ue = 16 // esz
    owner = [None] * items
    for lvl, (first, n, ub, units) in plan.items():
        for i in range(first, first + n):
            assert owner[i] is None
            owner[i] = lvl
        assert (n - 1) * ub < units <= n * ub or units == n == 0
        hw = shapes[lvl][0] * shapes[lvl][1]
        nel = Q * hw
        for i in range(n):
            e0 = i * ub * ue
            e1 = min(e0 + ub * ue, nel)
            assert (e1 - 1) // hw - e0 // hw + 1 <= _qmax(radius)
    assert None not in owner


STATIC_SMEM_PER_BLOCK = 49152  # static shared memory a block may declare


@pytest.mark.parametrize("radius", range(8))
def test_every_lookup_backward_fits_its_static_smem(radius):
    """gc, org, frac and touched of lookup_bwd_kernel<T, radius>."""
    d = _lookup_defines()
    qm, mm = _qmax(radius), (2 * radius + 2) ** 2
    assert qm * mm <= d["B5B_CBUF"] and qm >= 2
    smem = 4 * qm * mm + 8 * qm + 8 * qm + 4 * (d["B5B_RUN"] // 32)
    assert smem <= STATIC_SMEM_PER_BLOCK
    text = (CSRC / "corr_lookup.cu").read_text()
    for decl in ("__shared__ float gc[QM * MM];",
                 "__shared__ int org[QM][2];",
                 "__shared__ float frac[QM][2];",
                 "__shared__ unsigned touched[B5B_RUN / 32];"):
        assert decl in text, decl


# ------------------------------------------- the aggregating FMA bodies

def test_the_fma_mode_counts_are_mirrored_and_fit_a_block():
    """The aggregating kernels' FMA mode counts (agg_modes.cuh fma_modes)
    are the wrapper's AGG_MODES; 1 to 16 are a template each and every
    count past 16 takes the one NM_WIDE instance (WITH_MODES' default); and
    each instance's block (agg_smem: the q tiles' 256 columns, the staged k
    tiles, the largest bias source's floats) fits an H100 block."""
    text = (CSRC / "agg_modes.cuh").read_text()
    body = text[text.index("constexpr bool fma_modes(int NM)"):]
    body = body[:body.index("\n}\n")]
    assert tuple(int(m) for m in re.findall(r"NM == (\d+)", body)) == \
        ma.AGG_MODES
    switch = text[text.index("#define WITH_MODES"):]
    switch = switch[:switch.index("\n\n")]
    templates = tuple(int(m) for m in re.findall(r"case (\d+): LAUNCH",
                                                 switch))
    assert templates == tuple(m for m in ma.AGG_MODES if m <= 16)
    assert "default: LAUNCH(NM_WIDE)" in switch
    common = _defines("common.cuh")
    spad, fma = common["TILE"] + 1, common["MAXMD_FMA"]
    table = common["TILE"] * spad  # common.cuh TableBias::SMEM, the largest
    for nm in templates + ("wide",):
        kcols = fma if nm == "wide" else fma // nm
        assert ((fma + kcols) * spad + table) * 4 <= SMEM_PER_BLOCK, nm


# ------------------------------------- B2 and B8's pipelined body (flash)

# Its instances: F 128 at every padded mode dim up to 128 (the intra
# site's width), F 256 past md 64; each with the window, no bias and the
# table read from global memory.
PIPE_INSTANCES = [(mdp, 128) for mdp in (16, 32, 64, 128)] + \
    [(mdp, 256) for mdp in (128, 256)]


def _pipe_smem(mdp: int, F: int, bias: str) -> tuple:
    """(stages, bytes) of flash_attn.cu pipe_stages / pipe_smem: q past md
    64 (PROWS rows), as many k | v stages of pipe_keys keys as fit PSMEM
    beside it and the bias source (+ 16 bytes of mbarriers a stage), at
    most PMAX_STAGES, + 1024 for the ring's alignment."""
    d, common = _defines("flash_attn.cu"), _defines("common.cuh")
    keys = ma.flash_keys(mdp, F)
    q = d["PROWS"] * mdp * 2 if mdp > common["MAXMD"] else 0
    after = (common["MAXWIN"] * 4 + 15) // 16 * 16 if bias == "window" \
        else 0
    stage = keys * (mdp + F) * 2
    stages = min(d["PMAX_STAGES"],
                 (d["PSMEM"] - 1024 - q - after) // (stage + 16))
    return stages, 1024 + q + stages * (stage + 16) + after


def test_the_pipelined_body_follows_these_constants():
    """The wrapper's tile constants are flash_attn.cu's, and its keys a
    tile, stages and shared memory are the formulas above: each names its
    constants, the table source takes no shared memory (it reads global
    memory), and the launcher sizes the block with pipe_smem."""
    d = _defines("flash_attn.cu")
    assert (ma._P_ROWS, ma._P_MAX_SPLITS) == (d["PROWS"], d["PMAX_SPLITS"])
    assert d["PSMEM"] == SMEM_PER_BLOCK
    text = (CSRC / "flash_attn.cu").read_text()
    for fn, names in (
            ("constexpr int pipe_keys",
             ("F == 128 ? 128 : 64",)),
            ("constexpr int pipe_q_bytes", ("MDP > MAXMD ? PROWS * MDP * 2",)),
            ("constexpr int pipe_stage_bytes",
             ("pipe_keys<MDP, F>() * (MDP + F) * 2",)),
            ("constexpr int pipe_stages", ("PSMEM - 1024", "Bias::SMEM",
                                           "+ 16", "PMAX_STAGES")),
            ("constexpr size_t pipe_smem", ("1024 + pipe_q_bytes",
                                            "Bias::SMEM")),
            ("static inline long long pipe_partials",
             ("nsplit > 1 ? (long long)nsplit * BM * U1 * (F + 2) : 0",))):
        body = text[text.index(fn):]
        body = body[:body.index("\n}\n")]
        for name in names:
            assert name in body, (fn, name)
    assert "STAGE = 0, SMEM = 0;" in text[text.index("struct MmaTableDirect"):]
    assert "pipe_smem<MDP, F, BiasT<NK>>()" in text
    # A producer warpgroup beside the consumers, one block an SM: its and
    # the consumers' registers under setmaxnreg (multiples of 8 in 24..256)
    # fit the SM's 65536, and the launch gives every thread at most the
    # registers that 384 threads leave (168), which setmaxnreg then moves.
    assert d["PPRODUCER"] == 128 and d["PTHREADS"] == 2 * 128
    for regs in (d["PREG_PRODUCER"], d["PREG_CONSUMER"]):
        assert regs % 8 == 0 and 24 <= regs <= 256
    assert d["PTHREADS"] * d["PREG_CONSUMER"] + \
        d["PPRODUCER"] * d["PREG_PRODUCER"] <= 65536
    assert "__launch_bounds__(PTHREADS + PPRODUCER, 1)" in text
    assert "kernel<<<grid, PTHREADS + PPRODUCER, smem, s>>>(" in text
    assert "mbar_init(empty0 + 8 * i, PTHREADS);" in text  # consumers only
    # The launcher takes F 128 up to md 128 and instantiates no wider one.
    launcher = text[text.index("static int launch_pipe("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert "md > (F == 128 ? 128 : MAXMD_FMA)" in launcher
    f128 = launcher[launcher.index("if constexpr (F == 128) {"):
                    launcher.index("} else {")]
    assert re.findall(r"PIPE\((\d+)\)", f128) == ["16", "32", "64", "128"]
    # BM x q tiles x splits blocks, q tiles fastest.
    assert "const int nq = (U1 + PROWS - 1) / PROWS;" in text
    assert "const dim3 grid(nq, BM, nsplit);" in text
    assert "const int qt = blockIdx.x, bm = blockIdx.y, BM = gridDim.y;" \
        in text


@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("mdp,F", PIPE_INSTANCES)
def test_every_pipelined_instance_fits_a_block(mdp, F, bias):
    stages, smem = _pipe_smem(mdp, F, bias)
    assert stages >= 2 and smem <= SMEM_PER_BLOCK


def test_the_pipelined_rings_the_source_states():
    """2 stages at md 256 and F 256 (q 64 KB, 64 KB a stage), 3 at F 128
    and md 128, 4 below: with the table too, which takes no stage."""
    for bias in BIASES:
        assert [_pipe_smem(mdp, F, bias)[0] for mdp, F in PIPE_INSTANCES] \
            == [4, 4, 4, 3, 4, 2]


SMS = 132
# (label, B * M, U1, U2, md, F, splits, blocks): the f2 site at one and two
# modes (md 256, 128) on the serving grid and on a ragged one (37 x 61),
# the lazy intra aggregator at HD1K and at a Sintel batch of 11 (F 128, md
# 32), modes256's (F 128, md 1 padded to 16), and the F = 256 body up to md
# 64, which takes no split.
FLASH_GRIDS = [
    ("serving md 256", 1, 7040, 7040, 256, 256, 2, 110),
    ("serving md 128", 2, 7040, 7040, 128, 256, 1, 110),
    ("ragged md 256", 1, 2257, 2257, 256, 256, 4, 72),
    ("ragged md 128", 2, 2257, 2257, 128, 256, 3, 108),
    ("HD1K F 128", 4, 43520, 43520, 32, 128, 1, 1360),
    ("Sintel batch 11 F 128", 44, 7040, 7040, 32, 128, 1, 2420),
    ("modes256 F 128", 128, 7040, 7040, 16, 128, 1, 7040),
    ("serving md 64", 4, 7040, 7040, 64, 256, 1, 220)]


@pytest.mark.parametrize("label,BM,u1,u2,md,F,splits,blocks", FLASH_GRIDS)
def test_the_flash_grids(label, BM, u1, u2, md, F, splits, blocks):
    """Key splits fill the card where the q tiles would not: the blocks
    (BM x q tiles x splits) stay within a wave of 132 SMs; at most
    PMAX_SPLITS, one key tile a split; the scratch holds each split's o and
    (max, sum) rows, none for one split."""
    assert ma.flash_splits(BM, u1, u2, md, F, 1, SMS) == splits
    assert ma.flash_splits(BM, u1, u2, md, F, 0, SMS) == 1  # fp32: FMA
    got = BM * _cdiv(u1, ma._P_ROWS if ma.flash_pipe_body(1, md, F)
                     else 128) * splits
    assert got == blocks
    if splits > 1:
        assert blocks <= SMS
    assert ma.flash_partials(BM, u1, F, splits) == (
        splits * BM * u1 * (F + 2) if splits > 1 else 0)
