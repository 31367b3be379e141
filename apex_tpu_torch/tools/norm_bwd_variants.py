"""Build designs the norm backward was chosen over beside the source as it
is, and time them in turns on the card.

    python3 apex_tpu_torch/tools/norm_bwd_variants.py [--dry]

Source variants, ``csrc/layer_norm_bwd.cu`` with a line or two replaced
(``SOURCES`` below):

- ``final``: the source as it is;
- ``three_stages`` / ``two_stages``: three (two) rows in shared memory at
  every vector count, in place of two at 3-4 vectors a thread and three
  at 1-2;
- ``streaming_stores``: dx stored with ``st.global.cs`` (evict first);
- ``l2_prefetch_256``: the row copies ask L2 for 256-byte sectors
  (``cp.async ... .L2::256B``);
- ``weight_after_rows``: the weight's loads issued after the first rows'
  copies, so they arrive behind them;
- ``scalar_epilogue``: the block's column sums written to shared memory
  and added one float at a time (stores 32 bytes apart: bank conflicts).

Grid variants, the final source under another split of a row
(``GRIDS``): ``eight_lanes`` (rows of up to 32 vectors to 8 lanes, the
forward's choice, 2 or 4 vectors a thread at OpenFold's h 128 and 256);
``thirtytwo_lanes`` (those rows to a whole warp, 1 vector a thread);
``four_warps_a_row`` / ``eight_warps_a_row`` (Llama's and GPT-2-large's
rows over 4 or 8 warps, 2 or 1 vectors a thread); ``unbalanced`` (as many
blocks as can be resident, some walking one stride of rows more than
others).

Every variant runs at the paths' shapes (``chip_smoke.NORM_BWD_SHAPES``:
x bf16, Llama-1B's RMSNorm with an fp32 scale, GPT-2-large's LayerNorm
with an fp32 weight and bias, OpenFold's m and z rows with bf16 ones), in
turns (every variant, then every variant in reverse), and prints one JSON
object: per variant and shape the device ms (the least of three CUDA
graphs of 50 calls, a reading each turn) and whether dx, dw, db match the
plain version within 2^-6; and beside them, as the card's practical rate
for the kernel's bytes, ``torch.add`` of two bf16 ``[n, h]`` tensors into
a third (two reads and a write, as dy, x and dx) and a copy.  ``--dry``
only checks that every replacement applies.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "layer_norm_bwd.cu"
SOURCES = {
    "three_stages": [("return nv >= 3 ? 2 : 3;", "return 3;")],
    "two_stages": [("return nv >= 3 ? 2 : 3;", "return 2;")],
    "streaming_stores": [
        ("          store_f32<TX, VEC>(dxr + (int64_t)c * VEC, out);",
         """          {
            Pack<TX, VEC> pk;
#pragma unroll
            for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<TX>(out[i]);
            const uint4 u = *reinterpret_cast<const uint4*>(&pk);
            asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(dxr + (int64_t)c * VEC),
                         "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w) : "memory");
          }""")],
    "l2_prefetch_256": [("cp.async.cg.shared.global [%0], [%1], 16;",
                         "cp.async.cg.shared.global.L2::256B [%0], [%1], 16;")],
    "weight_after_rows": [("""#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st, first + st * step);
  if (has_w) {""", "  if (has_w) {"), ("""  uint32_t wbits[kWLoads], bbits[kWLoads];
""", """  uint32_t wbits[kWLoads], bbits[kWLoads];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st, first + st * step);
""")],
    "scalar_epilogue": [("""#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const size_t at = (size_t)slot * h + c * VEC + 4 * j;
        *reinterpret_cast<float4*>(sw + at) =
            make_float4(aw[k][4 * j], aw[k][4 * j + 1], aw[k][4 * j + 2], aw[k][4 * j + 3]);
        if constexpr (HAS_B)
          *reinterpret_cast<float4*>(sb + at) =
              make_float4(ab[k][4 * j], ab[k][4 * j + 1], ab[k][4 * j + 2], ab[k][4 * j + 3]);
      }""", """#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sw[(size_t)slot * h + c * VEC + i] = aw[k][i];
        if constexpr (HAS_B) sb[(size_t)slot * h + c * VEC + i] = ab[k][i];
      }"""), ("""  const int h4 = h / 4;
  for (int q = tid; q < (1 + HAS_B) * h4; q += threads) {
    const int half = q >= h4, c4 = q - half * h4;
    const float* src = sw + (size_t)half * rows * h + 4 * c4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < rows; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)j * h);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    *reinterpret_cast<float4*>(pw + (size_t)half * h + 4 * c4) = t;
  }""", """  for (int col = tid; col < h; col += threads) {
    float tw = 0.f, tb = 0.f;
    for (int j = 0; j < rows; ++j) {
      tw += sw[(size_t)j * h + col];
      if constexpr (HAS_B) tb += sb[(size_t)j * h + col];
    }
    pw[col] = tw;
    if constexpr (HAS_B) pw[h + col] = tb;
  }""")],
}
# (lanes, warps a row) for the rows each grid variant splits otherwise
GRIDS = {"eight_lanes": ("short", 8, 1), "thirtytwo_lanes": ("short", 32, 1),
         "four_warps_a_row": ("wide", 32, 4), "eight_warps_a_row": ("wide", 32, 8),
         "unbalanced": None}


def _sources() -> dict:
    base = (ROOT / "apex_tpu_torch" / "csrc" / SRC).read_text()
    out = {"final": base}
    for name, edits in SOURCES.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {SRC}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build_all(sources: dict) -> dict:
    from apex_tpu_torch.ops import _build

    out = ROOT / "build" / "norm_bwd_variants"
    jobs = {}
    for name, text in sources.items():
        csrc = out / name
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        (csrc / SRC).write_text(text)
        lib = out / f"{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _grid(name):
    """bwd_grid under the grid variant ``name``."""
    import math

    from apex_tpu_torch.ops import layer_norm as ln

    final = ln.bwd_grid

    def grid(n, h, dtype, affine, bias, mem_eff, aligned, sms):
        lanes, wn, vecs, warps, blocks = final(n, h, dtype, affine, bias, mem_eff,
                                               aligned, sms)
        nvec = h // (16 // dtype.itemsize)
        if name == "unbalanced":
            if vecs:
                rows = warps // wn * (32 // lanes)
                blocks = min(math.ceil(n / rows), ln._bwd_blocks_per_sm(vecs) * sms)
            return lanes, wn, vecs, warps, blocks
        kind, lanes2, wn2 = GRIDS[name]
        if not vecs or (kind == "short") != (wn == 1 and lanes == 16):
            return lanes, wn, vecs, warps, blocks
        vecs2 = math.ceil(nvec / (lanes2 * wn2))
        return (lanes2, wn2, vecs2) + ln._bwd_rows_grid(
            n, h, lanes2, wn2, vecs2, affine, bias, mem_eff, sms)

    return grid


def main(argv) -> int:
    sources = _sources()
    if "--dry" in argv:
        print(json.dumps({"sources": sorted(sources), "grids": sorted(GRIDS)}))
        return 0
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import layer_norm as ln
    from flash_bwd_compare import _device_ms

    libs = _build_all(sources)
    _build.build_all(["layer_norm_fwd.cu"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = chip_smoke.nvidia_smi("name,power.limit")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    g = torch.Generator(device=dev).manual_seed(31)
    shapes, out = {}, {"nvidia_smi": smi, "ms": {}, "ok": {}, "grid": {},
                       "reference_ms": {}}
    for name, n, h, rms, wdt, bdt, _ in chip_smoke.NORM_BWD_SHAPES:
        x = torch.randn(n, h, generator=g, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtypes[wdt])
        b = None if bdt is None else (0.1 * torch.randn(
            h, generator=g, device=dev)).to(dtypes[bdt])
        dy = torch.randn(n, h, generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            _, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-5, rms)
            args = (dy, x, mean, rstd, w, b, rms, False)
            shapes[name] = (args, ln._plain_backward(*args))
            dst = torch.empty_like(x)
            out["reference_ms"][name] = {
                "add": min(_device_ms(lambda: torch.add(dy, x, out=dst), 50)
                           for _ in range(3)),
                "copy": min(_device_ms(lambda: dst.copy_(x), 50) for _ in range(3))}
    variants = list(sources) + list(GRIDS)
    final_grid, final_stages = ln.bwd_grid, ln._bwd_stages
    for name in variants + variants[::-1]:
        _build._LIBS[SRC] = libs.get(name, libs["final"])
        ln.bwd_grid = final_grid
        if name in GRIDS:
            ln.bwd_grid = _grid(name)
        ln._bwd_stages = {"three_stages": lambda v: 3,
                          "two_stages": lambda v: 2}.get(name, final_stages)
        for shape, (args, ref) in shapes.items():
            with torch.no_grad():
                fn = lambda: ln.layer_norm_bwd(*args)
                got = fn()
                out["ok"].setdefault(name, {})[shape] = all(
                    float((a.float() - r.float()).abs().max()) <= 2 ** -6
                    for a, r in zip(got, ref) if a is not None)
                out["ms"].setdefault(name, {}).setdefault(shape, []).append(
                    min(_device_ms(fn, 50) for _ in range(3)))
            dy = args[0]
            out["grid"].setdefault(name, {})[shape] = ln.bwd_grid(
                *dy.shape, dy.dtype, True, args[5] is not None, False, True,
                torch.cuda.get_device_properties(dev).multi_processor_count)
    ln.bwd_grid, ln._bwd_stages = final_grid, final_stages
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
