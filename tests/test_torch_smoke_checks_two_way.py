"""chip_smoke.py's checks of B5 at D = 2 (two-way correlation), run on the
CPU at small grids: on CPU tensors the wrappers take their plain versions,
so the checks pass as they are; with a fault planted in a wrapper (the two
planes of a level swapped, every plane scaled as a level of its own, the
channels in (level, i, j, d) order, a plane's backward written into the
other) they must fail.  Also the weights chip_smoke builds for the two-way
and ablation configs load strictly into their models.
"""

import pytest
import torch

import chip_smoke
from craft_tpu_torch.models.flow_model import FlowModel
from craft_tpu_torch.ops.kernels import corr_lookup as lk
from test_torch_smoke_checks import LOOKUP_SHAPES, _one_thread  # noqa: F401

CPU = torch.device("cpu")
FWD_FAULTS = chip_smoke.B5_PLANE_FAULTS[:3]


def _run():
    report = {"corr_lookup_d2": {}, "corr_lookup_bwd_d2": {}}
    chip_smoke.check_lookup_planes(CPU, report, shapes=LOOKUP_SHAPES)
    return report


def test_plane_checks_pass_the_plain_versions():
    report = _run()
    assert report["corr_lookup_d2"]["max_abs_err"] == 0.0
    # bf16 plane gradients against fp32 ones: one rounding of values < 8.
    assert 0.0 < report["corr_lookup_bwd_d2"]["max_abs_err"] < 2.0 ** -5


def _fault(wrapper, fault):
    if wrapper == "corr_lookup":
        return lambda planes, coords, r, dim=1: chip_smoke._b5_plane_fault(
            planes, coords, r, fault)

    def faulty(coords, g, shapes, dtype, r, dim=1):
        return tuple(d.to(dtype) for d in chip_smoke._b5_plane_bwd_fault(
            coords, g, shapes, r, fault))
    return faulty


@pytest.mark.parametrize("wrapper,fault", [
    *(("corr_lookup", f) for f in FWD_FAULTS),
    *(("corr_lookup_bwd", f) for f in chip_smoke.B5_PLANE_FAULTS)])
def test_plane_checks_catch_a_planted_kernel_fault(monkeypatch, wrapper,
                                                   fault):
    monkeypatch.setattr(lk, wrapper, _fault(wrapper, fault))
    with pytest.raises(AssertionError, match="disagrees"):
        _run()


@pytest.mark.parametrize("variant", list(chip_smoke.TWO_WAY))
def test_two_way_weights_load(variant):
    cfg, sd = chip_smoke.variant_weights(variant, False)
    model = FlowModel(cfg)
    model.load_state_dict(sd, strict=True)
    f1 = {k: v for k, v in sd.items() if k.startswith("f1_trans.")}
    f2 = {k: sd["f2_trans." + k[len("f1_trans."):]] for k in f1}
    same = all(torch.equal(a, f2[k]) for k, a in f1.items())
    assert same == (variant == "f1_shared")
    assert sd["update_block.encoder.convc1.weight"].shape[1] == 648


@pytest.mark.parametrize("variant", chip_smoke.ABLATIONS)
def test_ablation_weights_load(variant):
    sd = chip_smoke.ablation_state_dict(variant, (16, 16))
    model = FlowModel(chip_smoke.ablation_config(variant, False))
    model.load_state_dict(sd, strict=True)
    if variant == "rand":
        assert model.f2_trans.vispos_encoder.pos_coder.pos_embed.shape == \
            (256, 256)
