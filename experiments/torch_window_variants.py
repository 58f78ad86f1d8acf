"""What holds kernels 8-10 (csrc/window_attention.cu) back: variants of the
source built beside the package's own and timed on the same inputs.  Needs
one NVIDIA GPU:

    python3 experiments/torch_window_variants.py [OUT.json]

Each variant is the source with a few lines replaced (VARIANTS below),
compiled with the package's nvcc flags into a library of its own under
facialmmt_tpu_torch/_build/variants/ and launched through the package's
wrapper (ops/kernels/window_attention.py::_launch) with that library in
place.  'padded' is the other shared-memory layout that was tried: rows
hd + 8 wide (no swizzle), one bulk copy a row spread over the lanes of the
slot's first warp.  Two variants are probes and compute nothing useful: 'no
compute' (copies, waits and barriers only: the memory side's floor) and 'no
copy' (the arithmetic on the zeroed ring: the compute side's floor).  Per
variant it prints ptxas's registers and spills, the instruction mix of the
SASS of the bf16 1-window, hd 32, N 49 kernel, the device time (torch.profiler) at the
7 stage shapes of a 64-face pack for 1 window a block and for v2's group,
and whether its bits equal the package's kernel.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

from torch_window_plan import FACES, HD, N, STAGES, device_ms  # noqa: E402

OCC6 = ("kConc == 1 ? 4 : (kConc == 2 ? 2 : 1)",
        "kConc == 1 ? 6 : (kConc == 2 ? 3 : 1)")
TWO_STAGES = ("kMaxStages = 3;", "kMaxStages = 2;")
# the exponentials by the precise expf in place of ex2.approx
EXPF = [("ex2(fmaf(sc[j][e], kLog2e, -ml0))", "expf(sc[j][e] - m0)"),
        ("ex2(fmaf(sc[j][2 + e], kLog2e, -ml1))", "expf(sc[j][2 + e] - m1)"),
        ("const float ml0 = row0 < N ? m0 * kLog2e : 0.f;",
         "if (row0 >= N) m0 = 0.f;"),
        ("const float ml1 = row1 < N ? m1 * kLog2e : 0.f;",
         "if (row1 >= N) m1 = 0.f;")]
NO_COMPUTE = [("    if (r0 < N) {\n      // 3. scores",
               "    if (r0 < N && N < 0) {\n      // 3. scores")]
NO_COPY = [("  for (int i = 0; i < min(stages, units); ++i) issue(i, i);", ""),
           ("    fmmt::mbar_wait(&full[s], phase);", ""),
           ("    if (i + stages < units) issue(i + stages, s);", "")]
PADDED = [
    ("  return elem * hd;\n", "  return elem * (hd + 8);\n"),
    ("      return r * rb + (((r / (128 / rb)) & (rb / 16 - 1)) << 4);",
     "      return r * rb;"),
    ("  const uint32_t unit_bytes = 3u * N * rb;",
     "  const uint32_t unit_bytes = 3u * N * kHd * sizeof(TT);"),
    ("    return off ^ (p << 4);", "    return off + (p << 4);"),
    ("window_attention_kernel(__grid_constant__ const Maps maps,\n",
     "window_attention_kernel(__grid_constant__ const Maps maps,\n"
     "                        const __nv_bfloat16* __restrict__ q,\n"
     "                        const __nv_bfloat16* __restrict__ k,\n"
     "                        const __nv_bfloat16* __restrict__ v,\n"),
    ("      maps, static_cast<const __nv_bfloat16*>(bias),",
     "      maps, static_cast<const __nv_bfloat16*>(q),\n"
     "      static_cast<const __nv_bfloat16*>(k),\n"
     "      static_cast<const __nv_bfloat16*>(v),\n"
     "      static_cast<const __nv_bfloat16*>(bias),"),
    ("""    if (tid == 0) {
      fmmt::mbar_arrive_expect_tx(&full[s], unit_bytes);
      fmmt::tensor_load_3d(dst, &maps.q, 0, 0, unit, &full[s]);
      fmmt::tensor_load_3d(dst + tile, &maps.k, 0, 0, unit, &full[s]);
      fmmt::tensor_load_3d(dst + 2 * tile, &maps.v, 0, 0, unit, &full[s]);
    }""", """    if (warp == 0) {
      if (lane == 0) fmmt::mbar_arrive_expect_tx(&full[s], unit_bytes);
      __syncwarp();
      const size_t base = (size_t)unit * N * kHd;
      for (int r = lane; r < 3 * N; r += 32) {
        const int op = r / N, rr = r % N;
        const __nv_bfloat16* src = (op == 0 ? q : op == 1 ? k : v) + base;
        fmmt::bulk_load(dst + op * tile + rr * rb, src + rr * kHd,
                        kHd * sizeof(TT), &full[s]);
      }
    }"""),
]
# the mangled template arguments of the instantiation reported: bf16 tiles,
# one window slot, hd 32, N 49
BF16_ENTRY = "I13__nv_bfloat16Li1ELi32ELi49E"
VARIANTS = {
    "as is": [],
    "padded": PADDED,
    "6 blocks a SM, 2 stages": [OCC6, TWO_STAGES],
    "expf": EXPF,
    "no compute (probe)": NO_COMPUTE,
    "no copy (probe)": NO_COPY,
}


def build(name, edits):
    from facialmmt_tpu_torch.ops import kernels

    src = (kernels.SRC_DIR / "window_attention.cu").read_text()
    for old, new in edits:
        assert old in src, (name, old)
        src = src.replace(old, new)
    out = kernels.BUILD_DIR / "variants" / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    (out / "window_attention.cu").write_text(src)
    lib = out / "libvariant.so"
    nvcc = kernels._nvcc()
    proc = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-I", str(kernels.SRC_DIR),
                           "-shared", "-o", str(lib),
                           str(out / "window_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    log = proc.stdout + proc.stderr
    report = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and BF16_ENTRY in line:
            report += [x.strip() for x in lines[i + 1:i + 4]
                       if "Used" in x or "spill" in x]
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    mix, inside = Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = BF16_ENTRY in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         line)
            if m:
                mix[m.group(1).split(".")[0]] += 1
    return str(lib), report, mix


def main(out_path=""):
    from facialmmt_tpu_torch.ops import kernels
    from facialmmt_tpu_torch.ops.kernels import window_attention as wa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    own = kernels.library()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv),
                                            VARIANTS.items())))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf = lambda a: torch.tensor(a).to(dev, torch.bfloat16).contiguous()
    shapes = []
    for res, heads in STAGES:
        side = res // 7
        w = FACES * side * side
        for nw in ((side * side, 1) if side > 1 else (1,)):
            shapes.append((w, heads, nw, [bf(rng.normal(size=(w, heads, N, HD))
                                             * s) for s in
                                          (HD ** -0.5, 1.0, 1.0)]
                           + [bf(rng.normal(size=(nw, heads, N, N)))]))
    rows = []
    for name, (path, report, mix) in built.items():
        lib = ctypes.CDLL(path)
        for fn in ("fmmt_window_attention", "fmmt_window_attention_smem"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                kernels._SIGNATURES[fn]
        total = sum(mix.values())
        print(f"variant {name}: {'; '.join(report)}; SASS {total} "
              f"instructions: " + ", ".join(f"{k} {v}" for k, v in
                                            mix.most_common(14)))
        sums = {}
        for w, heads, nw, args in shapes:
            for entry, conc in (("fused", 1),
                                ("v2", wa._group_size(w, nw, 4))):
                kernels.library = lambda: own
                want = wa._launch(wa.fused_window_attention_cuda, *args, conc)
                kernels.library = lambda: lib
                run = lambda: wa._launch(wa.fused_window_attention_cuda,
                                         *args, conc)
                same = torch.equal(run(), want)
                ms = device_ms(run)
                sums[entry] = sums.get(entry, 0.0) + (ms or float("nan"))
                rows.append({"variant": name, "W": w, "heads": heads,
                             "nW": nw, "entry": entry, "device_ms": ms,
                             "bits_as_the_package": same})
                print(f"  W={w} h={heads} nW={nw} {entry}: {ms} ms, bits "
                      f"{'same' if same else 'differ'}")
        print(f"  sum over 7 shapes: " + ", ".join(
            f"{e} {v:.4f} ms" for e, v in sums.items()))
    kernels.library = lambda: own
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": rows,
                       "variants": {k: {"ptxas": v[1], "sass": dict(v[2])}
                                    for k, v in built.items()}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
