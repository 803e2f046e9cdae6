"""Device times of textual variants of B2's and B8's pipelined body
(csrc/flash_attn.cu flash_pipe_kernel), so that what each design choice
of the body is worth shows in one call on one card:

    python tools/time_flash_variants.py [--reps 5] [--rounds 5] [--only ..]

Each variant is the source with some lines replaced (VARIANTS below): the
body as it is (a producer warpgroup copying every tile as its stage
frees, with `setmaxnreg`: 24 registers for it, 240 for each consumer);
64-key tiles at F 128 in place of 128; the grid with modes fastest in
place of q tiles fastest; S and p v waited for together, so that a
warpgroup's softmax no longer runs under its own p v; no producer, the
consumers' thread 0 refilling the stage of the tile before last; a
producer warp (32 threads) without `setmaxnreg`; two blocks an SM at F
128 (64-key tiles, half the shared memory, at most 128
registers a thread); the pipelined body at F 256 up to md 64 too, in place
of the F = 256 body (flash_wgmma_kernel); an eighth or a quarter of the
exponentials by polynomial on the FMA pipes (exp2_fma, relative error
2.0e-4), the rest on the SFUs; and, wrong outputs by design, no
exponentials, no p v products, no softmax: what each piece of the work
costs.  A variant whose lines are not in the source stops the run.
Each is compiled with the flags of craft_tpu_torch/ops/kernels/build.py
into build/variants/, one nvcc per variant, all started together, and
called through the wrappers (mode_attention.flash_mode_attention, and
flash_mode_attention_dense for B8) on seeded inputs (q, k ~ N(0, 1.5^2),
v ~ N(0, 1), bf16; the window ~ N(0, 0.5^2), a table ~ N(0, 1) fp32; the
clamp off).  The cases (CASES): B2 at F 128, md 32 where the lazy intra
path runs it (HD1K, B = 1, M = 4, 136 x 320; a Sintel batch of 11 at 55 x
128), at modes256's md 1 (padded to 16, M = 128, 55 x 128), B8 with no
table at HD1K (the window's share), B2 at F 256, md 256 (one mode, two
key splits) and md 128 (two modes), B8 with the table at md 256 (one
mode) and md 128 (a batch of 2 at two modes: 220 blocks, where the grid's
order can matter), and B2 at F 256, md 64 (four modes, the main path's
shape, which only the variant that moves it onto the pipelined body
changes).  Each case is timed over CUDA events in `rounds` rounds of
`reps` calls, the variants interleaved within a round; the median round
per call is printed beside each variant's largest |difference| from the
body as it is (a changed tile or order moves the output by bf16 rounding,
a broken one by far more).  Prints the card (nvidia-smi name, power
limit) and each variant's registers and spills.  Needs CUDA; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from craft_tpu_torch.ops.kernels import build  # noqa: E402
from craft_tpu_torch.ops.kernels import mode_attention as ma  # noqa: E402

OUT = ROOT / "build" / "variants"

# 2^x on the FMA pipes (x > -126): 2^round(x) through the exponent bits
# (1.5 * 2^23 added leaves round(x) in the low mantissa bits; no
# conversion, which would take the SFUs' pipe) times a degree-3
# polynomial of the rest, in [-0.5, 0.5] (relative error 2.0e-4, below
# bf16's rounding of p), for a share of the exponentials.
ANCHOR = ("// The bias sources of the pipelined body: the window at its key "
          "tile, none,")
EXP2_FMA = """__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f, f = x - (t - 12582912.f);
  const float p = fmaf(f, fmaf(f, fmaf(f, 0.05313124f, 0.24252071f),
                               0.6937807f), 1.f);
  return __int_as_float(__float_as_int(p) +
                        ((__float_as_int(t) - 0x4B400000) << 23));
}

"""
P1 = ("        const float p1 = exp2_approx(fmaf(sc[j][2 * i + 1], c2, "
      "-ml[i]));")
P1_FMA = ("        const float x1 = fmaf(sc[j][2 * i + 1], c2, -ml[i]);\n"
          "        const float p1 = {cond} ? exp2_fma(x1) : exp2_approx(x1);")

# The producer warpgroup's lines: the consumers' thread 0 copying in its
# place (THREAD0: the stage of the tile before last refilled once both
# consumer warpgroups are done with it, the first tiles before the loop),
# or a producer warp of 32 threads without setmaxnreg (WARP).
PRODUCER = """  if (tid >= PTHREADS) {  // the producer
    setmaxnreg_dec<PREG_PRODUCER>();
    if (tid == PTHREADS)
      for (int i = 0; i < n; ++i) {
        const int s = i % NST;
        if (i >= NST) mbar_wait(empty0 + 8 * s, ((i - NST) / NST) & 1);
        load_stage(kt0 + i, s);
      }
    return;
  }
  setmaxnreg_inc<PREG_CONSUMER>();
"""
PRELOAD = """  constexpr int PRE = NST == 2 ? 2 : NST - 1;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < PRE; ++i)
      if (i < n) load_stage(kt0 + i, i);
  }
"""
ARRIVE = "    mbar_arrive(empty0 + 8 * sp);  // done with tile i - 1\n"
REFILL = """    const int tl = i + PRE - 1;
    if (tid == 0 && tl < n) {
      const int sl = tl % NST;
      if (tl >= NST) mbar_wait(empty0 + 8 * sl, ((tl - NST) / NST) & 1);
      load_stage(kt0 + tl, sl);
    }
"""
THREAD0 = [
    ("__launch_bounds__(PTHREADS + PPRODUCER, 1)",
     "__launch_bounds__(PTHREADS, 1)"),
    ("kernel<<<grid, PTHREADS + PPRODUCER, smem, s>>>(",
     "kernel<<<grid, PTHREADS, smem, s>>>("),
    (PRODUCER, PRELOAD),
    ("bar_sync<PTHREADS>(1);  // the consumers alone", "__syncthreads();"),
    (ARRIVE, ARRIVE + REFILL)]
WARP = [("#define PPRODUCER 128", "#define PPRODUCER 32"),
        ("    setmaxnreg_dec<PREG_PRODUCER>();\n", ""),
        ("  setmaxnreg_inc<PREG_CONSUMER>();\n", "")]


STAGES_SMEM = "(PSMEM - 1024 - pipe_q_bytes<MDP>() - Bias::SMEM)"
# name: [(lines, their replacement), ...], applied in order; every
# occurrence is replaced.
VARIANTS = {
    "as built": [],
    "64-key tiles at F 128": [
        ("return F == 128 ? 128 : 64;", "return 64;")],
    "modes fastest": [
        ("const int qt = blockIdx.x, bm = blockIdx.y, BM = gridDim.y;",
         "const int qt = blockIdx.y, bm = blockIdx.x, BM = gridDim.x;"),
        ("const dim3 grid(nq, BM, nsplit);",
         "const dim3 grid(BM, nq, nsplit);")],
    "S and p v waited for together": [
        ("    wgmma_wait1();  // S(i); p v still running",
         "    wgmma_wait0();")],
    "the consumers' thread 0 copying, no producer": THREAD0,
    "a producer warp without setmaxnreg": WARP,
    # Without the producer: two blocks could not both take setmaxnreg's
    # registers, and the second's consumers would wait for them for ever.
    "two blocks an SM at F 128 (64-key tiles, no producer)": THREAD0 + [
        ("return F == 128 ? 128 : 64;", "return 64;"),
        ("__launch_bounds__(PTHREADS, 1)",
         "__launch_bounds__(PTHREADS, F == 128 ? 2 : 1)"),
        (STAGES_SMEM, "((F == 128 ? PSMEM / 2 - 1024 : PSMEM) - 1024 - "
                      "pipe_q_bytes<MDP>() - Bias::SMEM)")],
    "the pipelined body at F 256 up to md 64": [
        ("  if (F == 256 && md <= MAXMD) {", "  if (false) {"),
        ("(align & 15) != 0 || (F == 256 && md <= MAXMD))",
         "(align & 15) != 0)"),
        ("    if (md <= 128) PIPE(128);\n    PIPE(256);",
         "    if (md <= 16) PIPE(16);\n    if (md <= 32) PIPE(32);\n"
         "    if (md <= 64) PIPE(64);\n"
         "    if (md <= 128) PIPE(128);\n    PIPE(256);")],
    "an eighth of the exponentials on the FMA pipes": [
        (ANCHOR, EXP2_FMA + ANCHOR), (P1, P1_FMA.format(cond="j % 4 == 3"))],
    "a quarter of the exponentials on the FMA pipes": [
        (ANCHOR, EXP2_FMA + ANCHOR), (P1, P1_FMA.format(cond="j % 2 == 1"))],
    # Diagnostics, wrong outputs by design: what each piece costs.
    "without exponentials": [
        ("exp2_approx(fmaf(sc[j][2 * i], c2, -ml[i]))",
         "fmaf(sc[j][2 * i], c2, -ml[i])"),
        ("exp2_approx(fmaf(sc[j][2 * i + 1], c2, -ml[i]))",
         "fmaf(sc[j][2 * i + 1], c2, -ml[i])")],
    "without p v products": [
        ("      wgmma_o<F>(o, pa[kk], gmma_desc(vs + kk * 16 * 128, VBLK, "
         "1024, 1), 1);", "      (void)vs;")],
    "without the softmax": [
        ("    softmax(kt0 + i, ring + s * STAGE);\n", "")],
}
# (label, wrapper: b2, b8 (no table) or b8t (a table), batch, modes, grid,
# md, F)
CASES = (("B2 F 128 HD1K", "b2", 1, 4, (136, 320), 32, 128),
         ("B2 F 128 Sintel batch 11", "b2", 11, 4, (55, 128), 32, 128),
         ("B2 F 128 modes256 (md 16)", "b2", 1, 128, (55, 128), 16, 128),
         ("B8 no table F 128 HD1K", "b8", 1, 4, (136, 320), 32, 128),
         ("B2 F 256 md 256", "b2", 1, 1, (55, 128), 256, 256),
         ("B2 F 256 md 128", "b2", 1, 2, (55, 128), 128, 256),
         ("B8 table F 256 md 256", "b8t", 1, 1, (55, 128), 256, 256),
         ("B8 table F 256 md 128 batch 2", "b8t", 2, 2, (55, 128), 128, 256),
         ("B2 F 256 md 64", "b2", 1, 4, (55, 128), 64, 256))


def build_variants(only=None) -> dict:
    """{name: loaded library} of the variants that apply and compile (of
    those whose names contain one of `only`, and the body as built)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    src = (build.CSRC / "flash_attn.cu").read_text()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        if only and name != "as built" and not any(o in name for o in only):
            continue
        text = src
        for old, new in subs:  # in order, each on the text the last left
            if old not in text:
                raise SystemExit(f"{name}: these lines are not in the "
                                 f"source: {old!r}")
            text = text.replace(old, new)
        cu, so = OUT / f"flash{i}.cu", OUT / f"flash{i}.so"
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
            if "Compiling entry" in line and "flash_pipe_kernel" in line:
                report = [x.split(":")[-1].strip() for x in lines[j + 1:j + 4]
                          if "registers" in x or "spill" in x]
                inst = line.split("flash_pipe_kernelI")[1].split("Ev")[0]
                print(f"{name}, {inst}: {'; '.join(report)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", nargs="*", help="the variants to build (names "
                    "or parts of names; 'as built' always)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_variants(args.only)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    biases = (torch.randn(15, 15, generator=gen) * 0.5).to(dev)
    clip = torch.tensor(1e30, device=dev)
    for label, kind, batch, modes, grid, md, F in CASES:
        u = grid[0] * grid[1]

        def randn(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen) * s).to(
                dev, torch.bfloat16)
        q, k = (randn(batch, modes, u, md, s=1.5) for _ in range(2))
        v = randn(batch, modes, u, F)
        table = (torch.randn(u, u, generator=gen).to(dev)
                 if kind == "b8t" else None)
        if kind == "b2":
            def call():
                return ma.flash_mode_attention(q, k, v, biases, grid, clip,
                                               0.5)
        else:
            def call():
                return ma.flash_mode_attention_dense(q, k, v, table, clip,
                                                     0.5)
        outs = {}
        for name, lib in libs.items():
            build._LIBS["flash_attn"] = lib
            outs[name] = call()
        torch.cuda.synchronize()
        ref = outs.get("as built")
        times = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name, lib in libs.items():
                build._LIBS["flash_attn"] = lib
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / args.reps)
        for name in libs:
            diff = (float((outs[name].float() - ref.float()).abs().max())
                    if ref is not None else float("nan"))
            print(f"{label}, {name}: {statistics.median(times[name]):.4f} ms"
                  f" (rounds {', '.join(f'{t:.4f}' for t in times[name])});"
                  f" max |diff| from as built {diff:.3g}")
        del q, k, v, table, outs
        torch.cuda.empty_cache()
    build._LIBS.pop("flash_attn", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
