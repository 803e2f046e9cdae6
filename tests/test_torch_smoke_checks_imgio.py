"""chip_smoke.py's check of the image fixtures (``check_image_fixtures``:
each file of tests/data/formats decoded by the port to the JAX package's
recorded array, as it runs on the card's machine, which has no PIL), run
on the CPU: it passes as the decoder is, and fails with "disagrees" with
each of these faults planted in the port's decoder: a progressive AC
refinement's correction bits dropped (``jpeg_progressive.
_apply_corrections``), the EOB run kept across a restart marker
(``jpeg_progressive.decode_scan`` given the AC scans' segments as one), Adam7's last pass read at the wrong
stride (``imgio._ADAM7``), tRNS ignored (``imgio._trns_alpha``) and YCCK
left unconverted (``imgio._ycck_to_cmyk``).
"""

import numpy as np
import pytest

import chip_smoke
from craft_tpu_torch.data import imgio
from craft_tpu_torch.data import jpeg_progressive as jp


def _keep_eobrun(monkeypatch):
    """Each AC-first scan decoded as one segment with no restarts, so that
    an EOB run goes on past the marker that should end it."""
    real = jp.decode_scan

    def joined(segs, scomps, order, coef, dc_luts, ac_luts, ss, se, ah, al,
               restart):
        if ss and not ah:
            segs, restart = [np.concatenate(segs)], 0
        real(segs, scomps, order, coef, dc_luts, ac_luts, ss, se, ah, al,
             restart)

    monkeypatch.setattr(jp, "decode_scan", joined)


def _drop_corrections(monkeypatch):
    monkeypatch.setattr(jp, "_apply_corrections", lambda *a: None)


def _adam7_stride(monkeypatch):
    monkeypatch.setattr(imgio, "_ADAM7", imgio._ADAM7[:6] + ((0, 1, 2, 2),))


def _ignore_trns(monkeypatch):
    monkeypatch.setattr(imgio, "_trns_alpha",
                        lambda pix, color, depth, trns: pix)


def _ycck_unconverted(monkeypatch):
    monkeypatch.setattr(imgio, "_ycck_to_cmyk", lambda y, cb, cr, k: np.stack(
        [y, cb, cr, k], -1).astype(np.uint8))


FAULTS = {"refinement correction bits dropped": (
              _drop_corrections, "jpeg_prog_420.jpg"),
          "EOB run kept across a restart": (
              _keep_eobrun, "jpeg_prog_eob_past_restart.jpg"),
          "an Adam7 pass at the wrong stride": (
              _adam7_stride, "png_adam7_rgb8.png"),
          "tRNS ignored": (_ignore_trns, "png_rgb8_trns.png"),
          "YCCK unconverted": (_ycck_unconverted, "jpeg_ycck.jpg")}


def test_image_check_passes_the_decoder(capsys):
    names = [n for _, n in FAULTS.values()] + ["jpeg_lossless_jfif.jpg"]
    chip_smoke.check_image_fixtures(names=names)
    out = capsys.readouterr().out
    for name in names:
        assert f"image {name}:" in out, name


@pytest.mark.parametrize("fault", FAULTS)
def test_image_check_fails_each_planted_fault(monkeypatch, fault):
    plant, name = FAULTS[fault]
    plant(monkeypatch)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_image_fixtures(names=[name])
