"""Build designs the flash forward kernel was chosen over, side by side with
the source as it is, and time them in turns on the card.

    python3 apex_tpu_torch/tools/flash_fwd_variants.py [--dry]

Each variant is ``csrc/flash_attention_fwd.cu`` with a few lines replaced
(``VARIANTS`` below):

- ``final``: the source as it is;
- ``producer_warp``: a block of two consumer warpgroups and one producer
  warp that issues every load (288 threads, one block an SM), the flash
  backward's layout;
- ``one_block``: the source's block (the loads issued by the first warp)
  held to one block an SM;
- ``pipelined``: tile j's s = q k^T issued with tile j - 1's o += p v, the
  softmax run while p v is in flight;
- ``three_stages``: a ring of 3 stages instead of 4;
- ``no_exponentials`` and ``no_pv`` (diagnostics that compute another
  function): p without its exponentials, and o without its product.

Each builds with ``nvcc -Xptxas -v`` into ``build/flash_fwd_variants/``
(one process each, all together) and then runs in a process of its own,
in turns (every variant, then every variant in reverse), at Llama-1B's
shape (b 4, 32 heads over 8 kv heads, s 2048, d 64) and GPT-2-large's (b
8, 20 heads, s 1024, d 64), causal, bf16, in the model's layout.  Prints
one JSON object: per variant, the device ms at each shape (a CUDA graph of
20 calls, two readings a turn), whether its main-shape o and lse match the
final source's bit for bit, and ptxas's registers and spill bytes of the
bf16 d = 64 kernel and the kernels whose wgmma ptxas serialized (its C7512
note).  ``--dry`` only checks that every replacement applies.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "flash_attention_fwd.cu"

_PRODUCER_WARP = """  if (c == kConsumers) {
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(ring.once(), L::kQ);
      tma_load_tile<D>(q_s, &map_q, q0, hi, bi, kBlockRows, ring.once());
    }
    int s = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      if (j >= kStages) mbar_wait(ring.empty(s), phase ^ 1);
      produce(j, s);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const int my_tiles ="""

_LAST_PV = """      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(v_s(s), kTileRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    // (a warpgroup whose rows see none of the tile's keys skips it)
    if (t == 0) mbar_arrive(ring.empty(s));
"""

_LAST_PV_PIPELINED = """      prev = s;
      if (j == my_tiles - 1) {
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(v_s(s), kTileRows, kc));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if (t == 0) mbar_arrive(ring.empty(s));
      }
    } else if (t == 0) {
      mbar_arrive(ring.empty(s));
    }
"""

_ONE_BLOCK = ("__launch_bounds__(kThreads, D <= 64 ? 2 : 1)", "__launch_bounds__(kThreads, 1)")

VARIANTS = {
    "final": [],
    "producer_warp": [
        ("constexpr int kThreads = kConsumers * 128;",
         "constexpr int kThreads = kConsumers * 128 + 32;"),
        _ONE_BLOCK,
        ("  const bool producer = threadIdx.x < 32;", "  const bool producer = false;"),
        ("  const int my_tiles =", _PRODUCER_WARP)],
    "one_block": [_ONE_BLOCK],
    "pipelined": [
        ("  int s = 0;\n  uint32_t phase = 0;\n  for (int j = 0; j < n_tiles; ++j) {",
         "  uint32_t a[4][4];\n  int s = 0, prev = 0;\n  uint32_t phase = 0;\n"
         "  for (int j = 0; j < n_tiles; ++j) {"),
        ("      float sc[32];\n      wgmma_fence();",
         "      float sc[32];\n      fence_regs(o);\n      wgmma_fence();"),
        ("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_regs(sc);",
         "      wgmma_commit();\n      if (j > 0) {\n#pragma unroll\n"
         "        for (int kc = 0; kc < 4; ++kc)\n"
         "          wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(v_s(prev), kTileRows, kc));\n"
         "        wgmma_commit();\n        wgmma_wait<1>();\n      } else {\n"
         "        wgmma_wait<0>();\n      }\n      fence_regs(sc);"),
        ("      // o's last product has completed: rescale it in place\n",
         "      if (j > 0) {\n        wgmma_wait<0>();\n        fence_regs(o);\n"
         "        if (t == 0) mbar_arrive(ring.empty(prev));\n      }\n"),
        ("      uint32_t a[4][4];\n      if (p.dropout) {", "      if (p.dropout) {"),
        (_LAST_PV, _LAST_PV_PIPELINED)],
    "three_stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "no_exponentials": [
        ("sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -(lo ? base_a : base_b)));",
         "sc[i] = fmaf(sc[i], scale_log2, -(lo ? base_a : base_b));")],
    "no_pv": [
        ("        wgmma_rs<T, D>(o, a[kc], desc_mnmajor<D>(v_s(s), kTileRows, kc));",
         "        o[kc] += __uint_as_float(a[kc][0] ^ a[kc][3]);")],
}
SHAPES = {"llama_1b": (4, 32, 8, 2048, 64), "gpt2_large": (8, 20, 20, 1024, 64)}


def _variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: a replacement does not apply once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _time_one(lib: str) -> dict:
    """Device ms of the forward in the library at ``lib`` at each shape,
    and its main-shape output (a fresh process)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.tools.flash_bwd_compare import _device_ms

    _build._LIBS[SRC] = ctypes.CDLL(lib)
    dev = torch.device("cuda", 0)
    out = {}
    with torch.inference_mode():
        for name, (b, h, hk, s, d) in SHAPES.items():
            g = torch.Generator(device=dev).manual_seed(13)
            q, k, v = (torch.randn(s, b, n, d, generator=g, device=dev)
                       .to(torch.bfloat16).permute(1, 2, 0, 3) for n in (h, hk, hk))
            fn = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
            out[name] = [_device_ms(fn) for _ in range(2)]
            if name == "llama_1b":
                o, lse = fn()
                out["digest"] = [float(o.float().abs().sum()), float(lse.sum())]
    return out


def _ptxas(log: str) -> dict:
    """Registers, spills and serialized wgmma of the bf16 d = 64 kernel."""
    out, cur = {"serialized": []}, False
    for line in log.splitlines():
        m = re.search(r"function '([^']+)'", line) if "serialized" in line else None
        if m:
            out["serialized"].append(re.sub(r".*(flash_\w+?)I(\w+?)Li(\d+)E.*",
                                            r"\1 \2 d\3", m.group(1)))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = "flash_fwd_wgmmaI13__nv_bfloat16Li64E" in m.group(1)
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
    work = ROOT / "build" / "flash_fwd_variants"
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
        report[name] = dict(_ptxas(log), **{shape: [] for shape in SHAPES})
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--time", str(jobs[name][0])],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: timing failed\n{proc.stdout[-1000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for shape in SHAPES:
            report[name][shape] += got[shape]
        report[name]["digest"] = got["digest"]
    final = report["final"]["digest"]
    for name in VARIANTS:
        report[name]["same_output_as_final"] = report[name].pop("digest") == final
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
