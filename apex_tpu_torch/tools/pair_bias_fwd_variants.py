"""Build designs the pair-bias forward kernel was chosen over, and
diagnostics that take one piece of its work out, side by side with the
source as it is, and time them in turns on the card.

    python3 apex_tpu_torch/tools/pair_bias_fwd_variants.py [--dry]

Each variant is ``csrc/pair_bias_attention_fwd.cu`` with a few lines
replaced (``VARIANTS`` below):

- ``final``: the source as it is (a block of one R row by 128 queries, two
  warpgroups, two blocks an SM, a ring of 3 stages);
- ``one_block``: the source's block held to one block an SM;
- ``two_stages`` and ``four_stages``: a ring of 2 or 4 stages;
- diagnostics that compute another function: ``no_exponentials`` (p
  without its exp2), ``no_pv`` (o without its product), ``no_bias_reads``
  (the bias tile streamed but not read: its term 0), ``no_bias_tiles``
  (the bias tile neither streamed nor read).

Each builds with ``nvcc -Xptxas -v`` into ``build/pair_bias_fwd_variants/``
(one process each, all together) and then runs in a process of its own, in
turns (every variant, then every variant in reverse), at OpenFold's main
shape (R 128, h 8, s 1024, d 32, bf16, q/k/v strided views of [R, s, h,
d], a bf16 bias [1, 8, 1024, 1024], 10% of the keys masked).  Prints one
JSON object: per variant, the device ms (a CUDA graph of 20 calls, two
readings a turn), whether its o and lse match the final source's bit for
bit, and ptxas's registers and spill bytes of the bf16 d = 32 kernel and
the kernels whose wgmma ptxas serialized.  ``--dry`` only checks that every
replacement applies.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "pair_bias_attention_fwd.cu"

_READ_BIAS = """    if (p.staged)
      bias_words_smem(bw, gbase + L.bias(s) + c * col_boxes * kBiasBox, f32_bias, warp, g, tig);"""
_NO_BIAS_READ = """    if (p.staged)
#pragma unroll
      for (int i = 0; i < 32; ++i) bw[i] = 0;"""
_STAGED = ("  const FwdSmem<D> L{p.staged ? 2 * (esize == 4 ? 2 : 1) : 0};",
           "  const FwdSmem<D> L{0};")
# four stages fit at the timed shape (d 32), not at d 128 with an fp32 bias
_FITS = ('static_assert(FwdSmem<128>{4}.bytes() <= kSmemMax, "the ring does not fit");', "")

VARIANTS = {
    "final": [],
    "one_block": [("D <= 32 ? 2 : 1)", "1)")],
    "two_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "four_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;"), _FITS],
    "no_exponentials": [
        ("sc[i] = fast_exp2(sc[i] - (lo ? base_a : base_b));",
         "sc[i] = sc[i] - (lo ? base_a : base_b);")],
    "no_pv": [
        ("      wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(base + L.v(prev), kKeys, kc));",
         "      o[kc] += __uint_as_float(a[kc][0] ^ a[kc][3]);")],
    "no_bias_reads": [(_READ_BIAS, _NO_BIAS_READ)],
    "no_bias_tiles": [(_READ_BIAS, _NO_BIAS_READ), _STAGED],
}
SHAPE = dict(R=128, h=8, s=1024, d=32, mask_rate=0.1)


def _variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: a replacement does not apply once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _time_one(lib: str) -> dict:
    """Device ms of the forward in the library at ``lib`` at the main
    shape, and a digest of its output (a fresh process)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import pair_bias_attention as pb
    from apex_tpu_torch.tools.flash_bwd_compare import _device_ms

    _build._LIBS[SRC] = ctypes.CDLL(lib)
    dev = torch.device("cuda", 0)
    R, h, s, d = SHAPE["R"], SHAPE["h"], SHAPE["s"], SHAPE["d"]
    g = torch.Generator(device=dev).manual_seed(16)
    with torch.inference_mode():
        q, k, v = (torch.randn(R, s, h, d, generator=g, device=dev)
                   .mul(0.5).to(torch.bfloat16).transpose(1, 2) for _ in range(3))
        bias = (torch.randn(1, h, s, s, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        mask = torch.rand(R, s, generator=g, device=dev) >= SHAPE["mask_rate"]
        fn = lambda: pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask)
        o, lse = fn()
        out = {"ms": [_device_ms(fn) for _ in range(2)],
               "digest": [float(o.float().abs().sum()), float(lse.sum())]}
    return out


def _ptxas(log: str) -> dict:
    """Registers, spills and serialized wgmma of the bf16 d = 32 kernel."""
    out, cur = {"serialized": []}, False
    for line in log.splitlines():
        m = re.search(r"function '([^']+)'", line) if "serialized" in line else None
        if m:
            out["serialized"].append(re.sub(r".*(pair_bias_\w+?)I(\w+?)Li(\d+)E.*",
                                            r"\1 \2 d\3", m.group(1)))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = "pair_bias_fwd_wgmmaI13__nv_bfloat16Li32E" in m.group(1)
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    out["serialized"] = sorted(set(out["serialized"]))
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--time":
        print(json.dumps(_time_one(argv[2])), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    from apex_tpu_torch.ops import _build

    text = (_build.CSRC / SRC).read_text()
    sources = {name: _variant_source(text, name) for name in VARIANTS}
    if argv[1:] == ["--dry"]:
        print(json.dumps({name: len(src) for name, src in sources.items()}))
        return 0
    work = ROOT / "build" / "pair_bias_fwd_variants"
    jobs = {}
    for name, src in sources.items():
        d = work / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / SRC).write_text(src)
        lib = d / "lib.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(d / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"nvidia_smi": smi}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        report[name] = dict(_ptxas(log), ms=[])
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--time", str(jobs[name][0])],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: timing failed\n{proc.stdout[-1000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        report[name]["ms"] += got["ms"]
        report[name]["digest"] = got["digest"]
    final = report["final"]["digest"]
    for name in VARIANTS:
        report[name]["same_output_as_final"] = report[name].pop("digest") == final
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
