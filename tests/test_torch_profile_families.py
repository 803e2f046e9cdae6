"""Every hand kernel of the port falls in its own family of the profile tool.

tools/profile_torch_main_path.py sums the traced kernels' device time by
family, matching substrings of each kernel's name; a kernel whose name no
family names falls into 'elementwise/other' and drops out of its kernel's
per-layer time.  Here each `__global__` function of craft_tpu_torch/csrc is
read from the sources and held to the family of the kernel it serves.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "craft_tpu_torch" / "csrc"

# The families each source's kernels may fall in.
SOURCE_FAMILIES = {
    "agg_corr.cu": ("B6 agg_corr_bwd", "B6 / B6 dense agg_corr"),
    "agg_modes.cuh": ("B6 agg_corr_bwd",),  # sum_partials_kernel
    "corr_lookup.cu": ("B5 lookup", "B5 lookup_bwd"),
    "corr_norm.cu": ("B3 corr_norm",),
    "flash_attn.cu": ("B2 / B8 flash_attn",),
    "probs_bwd.cu": ("B7 probs_bwd",),
    "scores_max.cu": ("B1 scores_max",),
    "sep_conv_gru.cu": ("B10 gru_pass", "B10 gru_pass_bwd"),
    "softmax_probs.cu": ("B4 / B4 dense probs",),
}


def _kernels(text: str) -> list:
    """The names of the `__global__` functions of a CUDA source."""
    names = []
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        if text.startswith("__launch_bounds__", i):
            i, depth = text.index("(", i), 0
            while True:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
                if depth == 0:
                    break
        names.append(re.match(r"\s*(\w+)", text[i:]).group(1))
    return names


def _all_kernels() -> list:
    return [(path.name, name)
            for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
            for name in _kernels(path.read_text())]


def _family():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_main_path", ROOT / "tools" / "profile_torch_main_path.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.family


def test_every_source_with_kernels_has_its_families():
    sources = {source for source, _ in _all_kernels()}
    assert sources == set(SOURCE_FAMILIES)


@pytest.mark.parametrize("source,kernel", _all_kernels())
def test_each_kernel_is_in_its_family(source, kernel):
    family = _family()
    assert family(kernel) in SOURCE_FAMILIES[source], (source, kernel)
    # As the profiler names it: demangled, with its template arguments.
    assert family(f"void {kernel}<32, 128, PipeWindow>(bf16 const*, int)") \
        == family(kernel)
