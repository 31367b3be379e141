"""Build designs the flash backward kernels were chosen over, side by side
with the source as it is, and time them in turns on the card.

    python3 apex_tpu_torch/tools/flash_bwd_variants.py [--dry]

Each variant is ``csrc/flash_attention_bwd.cu`` with a few lines replaced
(``VARIANTS`` below):

- ``final``: the source as it is;
- ``dropout_branch_in_loop``: dq's ``if (p.dropout)`` inside the unrolled
  element loop, where the compiler if-converts it and hashes every element;
- ``producer_warpgroup_setmaxnreg``: a producer warpgroup (384 threads) that
  gives up registers (setmaxnreg 24) for consumers that ask for 240;
- ``dkv_products_overlap_next_tile``: dk/dv's products run on while the next
  tile's s^T and dp^T are issued.

Each builds with ``nvcc -Xptxas -v`` into ``build/flash_bwd_variants/``
(one process each, all together) and then runs in a process of its own,
in turns (every variant, then every variant in reverse), at Llama-1B's
shape (b 4, 32 heads over 8 kv heads, s 2048, d 64, causal, bf16, the
model's layout).  Prints one JSON object: per variant, dq's and dk/dv's
device ms (a CUDA graph of 20 launches, two readings a turn), ptxas's
registers and spill bytes of the bf16 d = 64 kernels, and the kernels whose
wgmma ptxas serialized (its C7512 note).  ``--dry`` only checks that every
replacement applies.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "flash_attention_bwd.cu"

_DQ_DS = """      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool lo = (i & 2) == 0;
          const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
          const bool keep = keep_bit(p.seed, (uint32_t)(lo ? row_a : row_b), (uint32_t)col,
                                     (uint32_t)bh, p.threshold);
          sc[i] *= (keep ? dp[i] * p.keep_scale : 0.f) - (lo ? delta_a : delta_b);   // ds
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - ((i & 2) == 0 ? delta_a : delta_b);
      }
"""
_DQ_DS_IN_LOOP = """#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool lo = (i & 2) == 0;
        float dpv = dp[i];
        if (p.dropout) {
          const int col = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
          dpv = keep_bit(p.seed, (uint32_t)(lo ? row_a : row_b), (uint32_t)col, (uint32_t)bh,
                         p.threshold)
                    ? dpv * p.keep_scale
                    : 0.f;
        }
        sc[i] *= dpv - (lo ? delta_a : delta_b);   // ds
      }
"""


def _producer(guard):
    return (f"  if (wg == kConsumers) {{\n    const int lane = threadIdx.x % 32;\n"
            f"    if ({guard} == 0) return;",
            f"  if (wg == kConsumers) {{\n"
            f"    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n"
            f"    const int lane = threadIdx.x % 128;\n"
            f"    if (lane >= 32 || {guard} == 0) return;")


def _consumer(what):
    return (f"  const int c = wg;                                // {what}",
            f"  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
            f"  const int c = wg;  // {what}")


VARIANTS = {
    "final": [],
    "dropout_branch_in_loop": [(_DQ_DS, _DQ_DS_IN_LOOP)],
    "producer_warpgroup_setmaxnreg": [
        ("constexpr int kThreads = kConsumers * 128 + 32;   // and one producer warp",
         "constexpr int kThreads = kConsumers * 128 + 128;"),
        _producer("n_tiles"), _producer("total"), _consumer("rows"), _consumer("keys")],
    "dkv_products_overlap_next_tile": [
        ("  int s = 0;\n  uint32_t phase = 0;\n  for (int it = 0; it < total; ++it) {",
         "  int s = 0, held = -1;\n  uint32_t phase = 0;\n  for (int it = 0; it < total; ++it) {"),
        ("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(sc);\n      fence_regs(dp);\n"
         "\n      const bool need_mask = has_seg || q0 + kTileRows > p.sq ||",
         "      wgmma_commit();\n      wgmma_wait<2>();\n"
         "      if (held >= 0 && t == 0) mbar_arrive(ring.empty(held));\n      held = -1;\n"
         "      wgmma_wait<0>();\n      fence_regs(sc);\n      fence_regs(dp);\n"
         "\n      const bool need_mask = has_seg || q0 + kTileRows > p.sq ||"),
        ("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(dv);\n      fence_regs(dk);\n"
         "    }\n    // (a warpgroup none of whose keys the tile's queries see skips it)\n"
         "    if (t == 0) mbar_arrive(ring.empty(s));",
         "      wgmma_commit();\n      held = s;\n    } else {\n      if (held >= 0) {\n"
         "        wgmma_wait<0>();\n        if (t == 0) mbar_arrive(ring.empty(held));\n"
         "        held = -1;\n      }\n      if (t == 0) mbar_arrive(ring.empty(s));\n    }"),
        ("  T* dkb = static_cast<T*>(p.dk)",
         "  wgmma_wait<0>();\n  fence_regs(dv);\n  fence_regs(dk);\n"
         "  if (held >= 0 && t == 0) mbar_arrive(ring.empty(held));\n"
         "  T* dkb = static_cast<T*>(p.dk)")],
}
SHAPE = (4, 32, 8, 2048, 64)    # b, h, hk, s, d


def _variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: a replacement does not apply once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _time_one(lib: str) -> dict:
    """dq and dk/dv device ms of the library at ``lib`` (a fresh process)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.tools.flash_bwd_compare import _device_ms

    _build.build_all(["flash_attention_fwd.cu"])
    _build._LIBS[SRC] = ctypes.CDLL(lib)
    dev = torch.device("cuda", 0)
    b, h, hk, s, d = SHAPE
    g = torch.Generator(device=dev).manual_seed(25)
    q, k, v, do = (torch.randn(s, b, n, d, generator=g, device=dev)
                   .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk, h))
    out = {}
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        call = fa._BwdLaunch(q, k, v, o, lse, do, None, None, True, d ** -0.5, 0.0, None)
        call.launch(fa.FLASH_ATTENTION_DQ)
        for kn, kern in (("dq", fa.FLASH_ATTENTION_DQ), ("dkv", fa.FLASH_ATTENTION_DKV)):
            out[kn] = [_device_ms(lambda kern=kern: call.launch(kern)) for _ in range(2)]
    return out


def _ptxas(log: str) -> dict:
    """Registers, spills and serialized wgmma of the bf16 d = 64 kernels."""
    out, cur = {"serialized": []}, None
    for line in log.splitlines():
        m = re.search(r"function '([^']+)'", line) if "serialized" in line else None
        if m:
            out["serialized"].append(m.group(1))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = None
            name = m.group(1)
            if "13__nv_bfloat16Li64E" in name:
                cur = "dq" if "flash_dq_wgmma" in name else "dkv" if "flash_dkv_wgmma" in name else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur + "_spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur + "_registers"] = int(m.group(1))
    out["serialized"] = sorted({re.sub(r".*(flash_\w+?)I(\w+?)Li(\d+)E.*", r"\1 \2 d\3", s)
                                for s in out["serialized"]})
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
    work = ROOT / "build" / "flash_bwd_variants"
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
    report = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        report[name] = dict(_ptxas(log), dq_ms=[], dkv_ms=[])
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--time", str(jobs[name][0])],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: timing failed\n{proc.stdout[-1000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        report[name]["dq_ms"] += got["dq"]
        report[name]["dkv_ms"] += got["dkv"]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
