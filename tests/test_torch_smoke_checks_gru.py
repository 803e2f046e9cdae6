"""The fused GRU pass B10's checks of chip_smoke.py (its phase 2), run on
the CPU at a tiny grid (moved whole from ``tests/test_torch_smoke_checks.py``
so that the two files run on two workers).  On CPU tensors each wrapper
takes its plain version, so the checks pass as they are; with a fault
planted in a wrapper (the row mask dropped, q over h, the blend reversed,
r h read as zero across the forward's row tiles, halo rows counted twice in
the weight gradients or dh without its drh r term, or a backward whose two
runs differ) they must fail.
"""

import pytest
import torch

import chip_smoke
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the plain versions: under pytest-xdist the
    workers share the cores, and every extra spinning thread slows them
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- B10, the fused GRU pass

GRU_GRIDS = (("tiny", 2, 5, 9),)  # 45 rows an image: no 64-row tile fits


def _run_gru():
    report = {"gru_pass_fwd": {}, "gru_pass_bwd": {}}
    chip_smoke.check_gru(CPU, report, grids=GRU_GRIDS)
    return report


def test_gru_checks_pass_the_plain_versions():
    report = _run_gru()
    assert report["gru_pass_fwd"]["max_abs_err"] == 0.0
    assert report["gru_pass_bwd"]["max_abs_err"] == 0.0


def _gru_fault(fault):
    if fault in chip_smoke.B10_FWD_FAULTS:
        return "gru_pass_fwd", lambda *a: chip_smoke._gru_fwd_fault(
            list(a[:11]), a[11], a[12], fault)
    return "gru_pass_bwd", lambda *a: chip_smoke._gru_bwd_fault(
        a[:12], a[12], a[13], fault)


@pytest.mark.parametrize("fault", chip_smoke.B10_FAULTS)
def test_gru_checks_catch_a_planted_kernel_fault(monkeypatch, fault):
    wrapper, faulty = _gru_fault(fault)
    monkeypatch.setattr(sg, wrapper, faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        _run_gru()


def test_the_tile_edge_fault_is_at_the_forward_tile():
    """'r h halo dropped' cuts q's taps at the bf16 forward's row tiles
    (csrc/sep_conv_gru.cu GF_ROWS)."""
    import re
    from pathlib import Path
    src = Path(sg.__file__).resolve().parents[2] / "csrc" / "sep_conv_gru.cu"
    rows = re.search(r"^#define\s+GF_ROWS\s+(\d+)\b", src.read_text(),
                     re.MULTILINE)
    assert int(rows.group(1)) == chip_smoke.B10_FWD_TILE
    assert "r h halo dropped" in chip_smoke.B10_FWD_FAULTS


def test_gru_checks_catch_a_backward_that_is_not_repeatable(monkeypatch):
    calls = []

    def drifting(*a):
        out = list(sg.gru_pass_bwd_plain(*a))
        calls.append(1)
        out[2] = out[2] + len(calls) * 1e-7
        return tuple(out)
    monkeypatch.setattr(sg, "gru_pass_bwd", drifting)
    with pytest.raises(AssertionError, match="two backwards differ"):
        _run_gru()


def test_the_ragged_gru_grid_is_ragged():
    """chip_smoke's ragged GRU grid: its rows are a multiple neither of the
    bf16 backward's row tiles nor of its weight-gradient steps, and they
    fall into two or more row splits, the last one short."""
    import re
    from pathlib import Path
    src = Path(sg.__file__).resolve().parents[2] / "csrc" / "sep_conv_gru.cu"
    d = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^#define\s+(\w+)\s+(\d+)\b", src.read_text(), re.MULTILINE)}
    label, batch, h8, w8 = chip_smoke.GRU_CHECK_GRIDS[-1]
    rows = batch * h8 * w8
    assert label == "ragged" and rows % (64 * d["GB_WG"]) and \
        rows % d["GB_DEPTH"]
    n = sg.wgrad_splits(rows, True)
    chunk = -(-(-(-rows // n)) // d["GB_DEPTH"]) * d["GB_DEPTH"]
    assert n >= 2 and 0 < rows - (n - 1) * chunk < chunk
