"""Device times of textual variants of B10's bf16 forward
(csrc/sep_conv_gru.cu: gru_pack_taps_kernel, then gru_fwd_wgmma_kernel's
z | r and q launches) at the serving and chairs grids (B=1, 55x128 and
B=8, 46x62 rows; Ch 128, Cx 384; the horizontal pass), so that what each
piece of the body costs shows in one call on one card:

    python tools/time_gru_fwd_variants.py

Each variant is the source with some lines replaced (VARIANTS below: the
body as it is, each step's products waited for before the ring is
refilled, without the rows' cp.async copies, without the weights' bulk
copies, without either, without the products, other ring depths).  Each
is compiled with the flags of craft_tpu_torch/ops/kernels/build.py into
build/variants/, one nvcc per variant, all started together, and called
through the wrapper (sep_conv_gru.gru_pass_fwd) on seeded inputs (h in
(-1, 1) bf16, x ~ N(0, 1) fp32, taps ~ N(0, 1 / 2560)).  A variant whose
lines no longer match the source is reported and left out.  Times: each
launch's device time per call (torch.profiler over 20 calls), the
wrapper's casts apart; variants that drop work give wrong outputs by
design, and each line gives the largest |error| over the largest |value|
of h', z, r, q against the plain version.  Prints the card (nvidia-smi
name, power limit), each variant's registers and spills, and one line per
variant and case.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from craft_tpu_torch.ops.kernels import build  # noqa: E402
from craft_tpu_torch.ops.kernels import sep_conv_gru as sg  # noqa: E402

OUT = ROOT / "build" / "variants"
GRIDS = (("serving", 1, 55, 128), ("chairs", 8, 46, 62))
CH, CX = 128, 384

WAIT = "    wgmma_commit();\n    wgmma_wait1();\n"
ROWS = ("      cp_async16(sa + swz128(r, c), ok ? a + (size_t)src * ka + k "
        ": a, ok);\n")
TAPS = ("      mbar_arrive_expect_tx(full0 + 8 * s, NG * GF_TILE);\n"
        "      bulk_copy(sa + TL::A, wimg + (size_t)ks * NG * GF_TILE, "
        "NG * GF_TILE,\n                full0 + 8 * s);\n")
MMA = ("      wgmma_ss128<0, 1>(\n"
       "          acc, kmajor_desc(st + 32 * kk),\n"
       "          mnmajor_desc(st + TL::A + gate * GF_TILE + kk * 16 * 128,\n"
       "                       GB_DEPTH * 128),\n"
       "          1);\n")
NO_ROWS = (ROWS, "      (void)ok;\n      (void)src;\n")
NO_TAPS = (TAPS, "      mbar_arrive(full0 + 8 * s);\n")
ZS, QS = "#define GF_ZSTAGES 4 ", "#define GF_QSTAGES 3 "
# name: [(lines, their replacement), ...]
VARIANTS = {
    "as built": [],
    "products waited for each step": [
        (WAIT, "    wgmma_commit();\n    wgmma_wait0();\n")],
    "without the rows' copies": [NO_ROWS],
    "without the weights' copies": [NO_TAPS],
    "without copies": [NO_ROWS, NO_TAPS],
    "without products": [(MMA, "      (void)kk;\n")],
    "z | r ring of 2": [(ZS, "#define GF_ZSTAGES 2 ")],
    "z | r ring of 3": [(ZS, "#define GF_ZSTAGES 3 ")],
    "q ring of 2": [(QS, "#define GF_QSTAGES 2 ")],
}


def build_variants() -> dict:
    """{name: loaded library} of the variants that apply and compile."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    src = (build.CSRC / "sep_conv_gru.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        if any(src.count(old) != 1 for old, _ in subs):
            print(f"{name}: left out, its lines no longer match the source")
            continue
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        cu, so = OUT / f"gru{i}.cu", OUT / f"gru{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{out[-2000:]}")
            continue
        lines = out.splitlines()
        for j, line in enumerate(lines):
            if "Compiling entry" in line and "gru_fwd_wgmma_kernel" in line:
                launch = "z | r" if "ILb1E" in line else "q"
                report = [x.split(":")[-1].strip() for x in lines[j + 1:j + 4]
                          if "registers" in x or "spill" in x]
                print(f"{name}, {launch}: {'; '.join(report)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def launch_ms(fn, reps: int = 20) -> dict:
    """{launch: device ms per call} of B10's kernels under fn."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("pack" if "gru_pack_taps" in e.key else
               "z | r" if "gru_fwd_wgmma_kernel<true" in e.key else
               "q" if "gru_fwd_wgmma_kernel<false" in e.key else "casts")
        ms = next(getattr(e, a) for a in ("self_device_time_total",
                                          "self_cuda_time_total")
                  if hasattr(e, a)) / 1e3 / reps
        out[key] = out.get(key, 0.0) + ms
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_gru_fwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    std = (5 * (CH + CX)) ** -0.5
    for label, batch, h8, w8 in GRIDS:
        rows = h8 * w8

        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen) * s).to(dev)
        h = randn(batch, rows, CH).tanh().bfloat16()
        x = randn(batch, rows, CX)
        ws = [randn(5, c, CH, s=std) for _ in range(3) for c in (CH, CX)]
        bs = [randn(CH, s=0.1) for _ in range(3)]
        args = (h, x, *ws, *bs, 1, w8)
        want = sg.gru_pass_fwd_plain(*args)
        for name, lib in libs.items():
            build._LIBS["sep_conv_gru"] = lib
            got = sg.gru_pass_fwd(*args)
            err = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                      for a, b in zip(got, want))
            ms = launch_ms(lambda: sg.gru_pass_fwd(*args))
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
            print(f"{name}, {label}: kernels "
                  f"{sum(v for k, v in ms.items() if k != 'casts'):.4f} ms "
                  f"({parts}); error {err:.3g}")
    build._LIBS.pop("sep_conv_gru", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
