"""Device times of textual variants of the bf16 bodies of B7
(csrc/probs_bwd.cu) and B6's backward (csrc/agg_corr.cu) at the chairs
shapes (B=8, M=4, 368x496 -> U=2852, W8=62; B7 at md 64 and 32, B6's
backward at md 64), so that what each piece of a body costs shows in one
call on one card:

    python tools/time_bwd_variants.py

Each variant is the source with some lines replaced (VARIANTS below: the
body as it is, without its dc stores, without the loads of its streamed
inputs, with dc stored from the accumulator fragments instead of through
the staging tile, B7 without its row pass).  Each is compiled with the
flags of craft_tpu_torch/ops/kernels/build.py into build/variants/, one
nvcc per variant, all started together, and its C entry point is called
through ctypes on seeded inputs (q, k ~ N(0, 1.5^2) bf16, the clamp
off).  A variant whose lines no longer match the source is reported and
left out.  Times: CUDA events around 10 calls, the median of 3 rounds;
variants that drop work give wrong outputs by design.  Prints the card
(nvidia-smi name, power limit), each variant's registers and spills, and
one line per variant and case.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from craft_tpu_torch.ops.kernels import build  # noqa: E402
from craft_tpu_torch.ops.kernels import corr_vjp as cv  # noqa: E402
from craft_tpu_torch.ops.kernels import mode_attention as ma  # noqa: E402
from craft_tpu_torch.ops.kernels import probs_vjp as pv  # noqa: E402

OUT = ROOT / "build" / "variants"
CHAIRS, BATCH = (46, 62), 8
NEVER = "if (u < 0) "  # a guard the stores never pass (u >= 0)

B7_STORE = ("      put_row_unit(dcb + a, sb + r * B7_PROW, (int)(a & 15), "
            "2 * ncols, u);")
B7_STAGE = ("          *reinterpret_cast<uint32_t*>(ds_row + 2 * cl) =\n"
            "              pack_bf16(d[0], d[1]);")
B7_LOADS = ("                   ok ? src + a0 : src,\n"
            "                   ok ? (int)min((size_t)16, pbytes - a0) : 0);")
B6_STORE = ("        put_row_unit(dc8 + a, sb + r * B6B_GROW, (int)(a & 15), "
            "4 * nkeys, u);")
B6_STAGE = ("        float* d = reinterpret_cast<float*>(sb + r * B6B_GROW +\n"
            "                                            (int)(a & 15)) + "
            "wkey + 2 * t;")
B6_LOADS = ("                   ok ? src + a0 : src,\n"
            "                   ok ? (int)min((size_t)16, gbytes - a0) : 0);")
# name: (source, [(lines, their replacement), ...])
VARIANTS = {
    "b7": ("probs_bwd.cu", []),
    "b7 without dc stores": ("probs_bwd.cu",
                             [(B7_STORE, B7_STORE.replace("put", NEVER +
                                                          "put", 1))]),
    "b7 without p, g loads": ("probs_bwd.cu",
                              [(B7_LOADS, "                   src, 0);")]),
    "b7 without its row pass": ("probs_bwd.cu",
                                [("  probs_row_kernel<<<",
                                  "  if (0) probs_row_kernel<<<")]),
    "b7 dc from the fragments": ("probs_bwd.cu", [
        (B7_STORE, B7_STORE.replace("put", NEVER + "put", 1)),
        (B7_STAGE, "          if (row_ok[i] && wc + cl + 1 < ncols)\n"
                   "            *reinterpret_cast<uint32_t*>(dc + e0 + wc + "
                   "cl) = pack_bf16(d[0], d[1]);")]),
    "b6": ("agg_corr.cu", []),
    "b6 without dc stores": ("agg_corr.cu",
                             [(B6_STORE, B6_STORE.replace("put", NEVER +
                                                          "put", 1))]),
    "b6 without g, vol loads": ("agg_corr.cu",
                                [(B6_LOADS, "                   src, 0);")]),
    "b6 dc from the fragments": ("agg_corr.cu", [
        (B6_STORE, B6_STORE.replace("put", NEVER + "put", 1)),
        (B6_STAGE, "        float* d = dc + (pl + row0 + r) * U + key0 + "
                   "wkey + 2 * t;\n"
                   "        if (row0 + r >= U || key0 + wkey + 16 > U) "
                   "continue;")]),
}


def build_variants() -> dict:
    """{name: loaded library} of the variants that apply and compile."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    procs = {}
    for i, (name, (src, subs)) in enumerate(VARIANTS.items()):
        text = (build.CSRC / src).read_text()
        missing = [old for old, _ in subs if old not in text]
        if missing:
            print(f"{name}: left out, its lines no longer match {src}")
            continue
        for old, new in subs:
            text = text.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
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
            if "Compiling entry" in line and "wgmma_kernelILi64" in line:
                report = [x.split(":")[-1].strip() for x in lines[j + 1:j + 4]
                          if "registers" in x or "spill" in x]
                print(f"{name}, md 64 body: {'; '.join(report)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / reps)
    return statistics.median(rounds)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_variants()
    dev = torch.device("cuda")
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    ptr = lambda t: P(t.data_ptr())  # noqa: E731
    stream = P(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator().manual_seed(0)
    U = CHAIRS[0] * CHAIRS[1]
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    clip = torch.tensor([1e30], device=dev)

    def qk(md):
        return [(torch.randn(BATCH, 4, U, md, generator=gen) * 1.5).to(
            dev, torch.bfloat16) for _ in range(2)]
    for md in (64, 32):
        q, k = qk(md)
        p = ma.mode_softmax_probs(q, k, biases, CHAIRS, clip[0], 0.5)
        g = torch.randn(p.shape, generator=gen).to(dev, torch.bfloat16)
        dc, dlsum = torch.empty_like(p), torch.empty(U, U, device=dev)
        n_row = pv.probs_rowterm_size(BATCH * 4, U, 1)
        rowt = torch.empty(n_row, device=dev)
        for name, lib in libs.items():
            if not name.startswith("b7"):
                continue
            fn = lib.probs_bwd_launch
            fn.argtypes = [P] * 8 + [L, I, I, I, F, I, P]
            fn.restype = I
            args = (ptr(q), ptr(k), ptr(p), ptr(g), ptr(clip), ptr(dc),
                    ptr(dlsum), ptr(rowt), n_row, BATCH * 4, U, md,
                    md ** -0.5, 1, stream)
            build.check(fn(*args), name)
            print(f"{name}, md {md}: {time_ms(lambda: fn(*args)):.3f} ms")
        del p, g, dc
        torch.cuda.empty_cache()
    q, k = qk(64)
    agg_w = torch.tensor(1.3, device=dev)
    vol = cv.fused_agg_corr(q, k, biases, CHAIRS, clip[0], 0.5, agg_w,
                            torch.tensor(0.1, device=dev))
    g = torch.randn(BATCH, U, U, generator=gen).to(dev)
    dc = torch.empty(BATCH, 4, U, U, device=dev)
    n_part = cv.bwd_partials(BATCH, U, 1)
    part = torch.empty(n_part, dtype=torch.float64, device=dev)
    da = torch.empty(1, device=dev)
    win = biases.reshape(-1).contiguous()
    scal = torch.tensor([1e30, 0.5, 1.3, 0.0], device=dev)
    for name, lib in libs.items():
        if not name.startswith("b6"):
            continue
        fn = lib.agg_corr_bwd_launch
        fn.argtypes = [P] * 8 + [I, P, I, I, I, I, I, I, F, I, P]
        fn.restype = I
        args = (ptr(q), ptr(k), ptr(g), ptr(vol), ptr(win), ptr(scal),
                ptr(dc), ptr(part), n_part, ptr(da), BATCH, 4, U, 64,
                CHAIRS[1], 7, 0.125, 1, stream)
        build.check(fn(*args), name)
        print(f"{name}, md 64: {time_ms(lambda: fn(*args)):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
