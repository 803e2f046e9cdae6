"""The port's slice as a whole, on the CPU: full-width CRAFT with the oracle
weights at 128x128, 12 iterations, against the reference's fp32 flow.

Bounds are the JAX package's own (tools/verify_tpu.py:36-37): fp32 within
1e-3 px; the main-path config (bf16 compute, int8 intra probs) within
0.15 px.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from craft_tpu_torch.config import craft_config
from craft_tpu_torch.models.flow_model import create_model
from craft_tpu_torch.utils.weights import load_oracle_npz, state_dict_from_flax

ORACLE = Path(__file__).resolve().parent / "data" / "oracle_craft_128.npz"


@pytest.mark.parametrize("mixed_precision,bound", [(False, 1e-3),
                                                   (True, 0.15)])
def test_oracle_flow(mixed_precision, bound):
    img1, img2, want, tree = load_oracle_npz(ORACLE)
    model = create_model(craft_config(mixed_precision=mixed_precision),
                         device="cpu")
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    with torch.inference_mode():
        lowres, flows = model(torch.from_numpy(img1),
                              torch.from_numpy(img2), iters=12)
    assert lowres.shape == (1, 16, 16, 2)
    assert flows.shape == (12, 1, 128, 128, 2)
    got = flows[-1].numpy()
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"mixed_precision={mixed_precision}: max |flow diff| {err:.3e} px")
    assert err < bound, f"max |flow diff| {err} px"


def test_final_upsample_mode_matches_all():
    img1, img2, _, tree = load_oracle_npz(ORACLE)
    model = create_model(craft_config(mixed_precision=False), device="cpu")
    model.load_state_dict(state_dict_from_flax(tree), strict=True)
    args = (torch.from_numpy(img1[:, :64, :64]),
            torch.from_numpy(img2[:, :64, :64]))
    with torch.inference_mode():
        low_a, all_flows = model(*args, iters=3)
        low_f, final = model(*args, iters=3, upsample_mode="final")
    assert final.shape == (1, 1, 64, 64, 2)
    torch.testing.assert_close(low_f, low_a, rtol=0, atol=0)
    torch.testing.assert_close(final[0], all_flows[-1], rtol=0, atol=1e-5)


def test_create_model_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(craft_config())
