"""The inter SETrans site at mode dims below 16, port against the JAX
package's XLA path on the CPU, fp32, dropout rates 0, seeded weights
(tests/test_torch_modes_sites.py's cases at other counts; the intra site in
tests/test_torch_modes_small_intra.py, the f2 site in
test_torch_modes_small_f2.py and _f2_wide.py, each file under a minute
alone).

The 256-wide sites (f2, inter) take 32, 64, 128 and 256 modes (md 8, 4, 2,
1), the 128-wide intra site 16, 32, 64 and 128 (the same md).  In eval mode
the port's sites take their kernels' plain versions (B2 at the f2 site, B4
float at the intra site, B3 at the inter site, held against the JAX raw
volume normed per sample); in train mode each site's output and
``jax.vjp``'s gradients (every parameter, the inputs) from a seeded
cotangent; the plain path (stock autograd over the materialised scores)
at 32 inter modes and 16 intra modes.  A count's eval and gradient cases
share one file, and so JAX's compiled primitives.  The clamp fires, at
tests/test_torch_modes_sites.py's 0.5 but for the f2 site at 64 modes:
there one score (md 4, scale 1/2) lies 2 ulp (1.2e-7) below 0.5, where the
two frameworks' fp32 sums put it on either side of the clip and so pass or
stop its gradient; at 0.45 the nearest score is 4.6e-5 away (every other
case's nearest lies 7e-7 to 6e-5 from 0.5).  Bounds: outputs
within atol 5e-5, rtol 1e-4; gradients within rtol 1e-4 and atol 5e-5 of
the site's largest gradient.
"""

import pytest

from test_torch_modes_sites import (
    CLAMP_CLIP, test_plain_site_matches_jax_vjp as _plain_vjp,
    test_site_eval_matches_jax as _eval,
    test_site_gradients_match_jax_vjp as _vjp)
from test_torch_train_dense import _one_thread  # noqa: F401

CLIP = {("f2", 64): 0.45}  # else 0.5 (CLAMP_CLIP), below every case's max
MODES = {"f2": (32, 64, 128, 256), "inter": (32, 64, 128, 256),
         "intra": (16, 32, 64, 128)}


def clip(site, modes):
    return CLIP.get((site, modes), CLAMP_CLIP)


@pytest.mark.parametrize("modes", MODES["inter"])
def test_site_eval_matches_jax_below_md16(modes):
    _eval("inter", modes, clip("inter", modes))


@pytest.mark.parametrize("modes", MODES["inter"])
def test_site_gradients_match_jax_vjp_below_md16(modes):
    _vjp("inter", modes, clip("inter", modes))


def test_plain_site_matches_jax_vjp_below_md16():
    _plain_vjp("inter", 32, clip("inter", 32))
