"""Build designs the pair-bias backward kernels were chosen over side by
side with the source as it is, and time them in turns on the card.

    python3 apex_tpu_torch/tools/pair_bias_bwd_variants.py [--dry] [VARIANT ...]

Each variant is ``csrc/pair_bias_attention_bwd.cu`` with a few lines
replaced (``VARIANTS`` below):

- ``final``: the source as it is;
- ``dq_unpipelined``: dq waits on each tile's dq product within the tile
  instead of running it behind the next tile's s and dp;
- ``dq_pipelined_all``: dq runs each tile's dq product behind the next
  tile's s and dp at d 64 and 128 as well as at d 32;
- ``dkv_scalar_bias_reads``: dk/dv reads its transposed 16-bit bias entries
  one 16-bit load each (32 a tile) in place of four ldmatrix.trans;
- ``dq_bias_ahead`` and ``dkv_bias_ahead``: dq and dk/dv read a tile's 32
  bias words into registers ahead (an unstaged bias's before the stage's
  wait, a staged one's while the products run), as the forward does, in
  place of group by group as p needs them;
- ``dbias_planes_fastest``: dbias's grid with the (batch, head) planes
  fastest, so the blocks in flight are one tile of many planes (the rows'
  operands read by fewer blocks at once) in place of one plane's tiles;
- ``dbias_two_blocks``: dbias held to two blocks an SM (at most 112
  registers a thread);
- ``two_stages`` and ``four_stages``: rings of 2 or 4 stages at d 32;
- ``dkv_d128_whole``: dk/dv at d 128 in one block per 128 keys (all 128
  columns of dk and dv in its registers) in place of two, each with 64;
- ``dbias_release_synced``: dbias's thread 0 hands each row's stage back
  for its warpgroup once the row's dp completes, after a sync of the
  warpgroup (``bar.sync``), in place of each warp handing it back itself
  once past its reads;
- ``dbias_release_unsynced``: the same without the sync, a race (a lagging
  warp may still read the stage's mask bytes when TMA refills it): what
  the first design did, for its time;
- ``dbias_release_deferred``: thread 0 hands row t's stage back once row t
  + 1's s completes (which every warp issues after its reads of row t's
  stage), as dq does with its product behind.

Each builds with ``nvcc -Xptxas -v`` into ``build/pair_bias_bwd_variants/``
(one process each, all together) and then runs in a process of its own, in
turns (every variant, then every variant in reverse), at OpenFold's main
shape (R 128, h 8, s 1024, d 32, bf16, q/k/v/do strided views of [R, s, h,
d], a bf16 bias [1, 8, 1024, 1024], 10% of the keys masked), dq also at d
64 (R 64) and each at d 128 (R 32, the rest alike).  Prints one
JSON object: per variant, the device ms of each (a CUDA graph of 20
launches, two readings a turn), whether their outputs match the final
source's, whether DBIAS_REPEATS more dbias launches at the main shape give
the first one's bits, and ptxas's registers and spill bytes of the bf16
kernels (keys ``dq_registers``, ``dq_d64_registers``, ...) and the kernels
whose wgmma ptxas serialized.  ``--dry`` only checks that every
replacement applies.  Naming variants builds and times only those, beside
``final``.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = "pair_bias_attention_bwd.cu"

_LDSM = """    uint32_t r[4];
    ldsm_x4_trans(r, box + (8 * n + rr) * 128 + (((2 * warp + half) ^ rr) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * (j >> 1) + 2 * (j & 1)] = r[j];"""
_SCALAR = """    (void)n;
    (void)half;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int chunk = 2 * warp + hf;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * (2 * m + nn) + 2 * tig + e;
          v[e] = *reinterpret_cast<const uint16_t*>(
              gbox + row * 128 + ((chunk ^ (row & 7)) << 4) + 2 * (g & 7));
        }
        w[4 * nn + 2 * hf] = v[0] | (v[1] << 16);
      }"""
# reading a tile's 32 bias words ahead, while the products run, into
# registers that then feed p (bw[32])
_COPY_WORDS = """    probs([&](int m, uint32_t (&w)[8]) {
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = bw[8 * m + i];
    });"""


def _words_ahead(global_fill, smem_fill):
    return """    uint32_t bw[32];
    if (!p.staged) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t w[8];
        %s;
#pragma unroll
        for (int i = 0; i < 8; ++i) bw[8 * m + i] = w[i];
      }
    }
""" % global_fill, """    if (p.staged) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t w[8];
        %s;
#pragma unroll
        for (int i = 0; i < 8; ++i) bw[8 * m + i] = w[i];
      }
    }
""" % smem_fill


_DQ_AHEAD = _words_ahead("bias_group_global(w, p, bb, row_a, j * kKeys, tig, m)",
                         "bias_group_smem(w, tile, f32_bias, warp, g, tig, m)")
_DKV_AHEAD = _words_ahead("bias_group_global_t(w, p, bb, it * kKeys, key_a, tig, m)",
                          "bias_group_smem_t(w, box, gbase + (box - base), f32_bias, warp, "
                          "lane, m)")
_DQ_TILE = ("    const unsigned char* tile = gbase + L.bias(st) + c * col_boxes * kBiasBox;\n"
            "    mbar_wait(ring.full(st), phase);\n")
_DKV_TILE = ("    const uint32_t box = base + L.bias(st) + c * col_boxes * kBiasBox;\n"
             "    mbar_wait(ring.full(st), pos.phase);\n")
_DQ_ISSUED = "    if constexpr (kBehind) issue_dq(prev);\n"
_DKV_ISSUED = "    const float* ls = reinterpret_cast<const float*>(gbase + L.vecs(st));\n"
_DQ_GROUPS = """    if (p.staged) {
      probs([&](int m, uint32_t (&w)[8]) { bias_group_smem(w, tile, f32_bias, warp, g, tig, m); });
    } else {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_global(w, p, bb, row_a, j * kKeys, tig, m);
      });
    }"""
_DKV_GROUPS = """    if (p.staged) {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_smem_t(w, box, gbase + (box - base), f32_bias, warp, lane, m);
      });
    } else {
      probs([&](int m, uint32_t (&w)[8]) {
        bias_group_global_t(w, p, bb, it * kKeys, key_a, tig, m);
      });
    }"""
_DBIAS_GRID = (
    "  const int k0 = (blockIdx.x % n_kt) * kKeys, q0 = (blockIdx.x / n_kt) * kBlockQueries;\n"
    "  const int gb = blockIdx.y;",
    "  const int k0 = (blockIdx.y % n_kt) * kKeys, q0 = (blockIdx.y / n_kt) * kBlockQueries;\n"
    "  const int gb = blockIdx.x;")
_DBIAS_LAUNCH = ("kernel<<<dim3(tiles, p.nb * p.h),", "kernel<<<dim3(p.nb * p.h, tiles),")
# dbias's stage release: each warp's, once past its own reads (the
# source); or thread 0's for the warpgroup, once the row's dp completes
# (after a sync of the warpgroup, or without one), or once the next row's
# s completes
_DBIAS_PER_WARP = [
    ("  init_ring(ring, kConsumers * 4);                 // each consumer warp releases\n",
     "  init_ring(ring);\n"),
    ("    walk_ring(ring, r, t, 4);", "    walk_ring(ring, r, t);")]
_DBIAS_WARP_RELEASE = """    // each warp hands the stage back itself, once past its own reads of
    // the stage's mask bytes: dp's completion shows only that every warp
    // issued it, which they do before those reads
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(st));
"""
_SYNC = '    asm volatile("bar.sync %0, 128;\\n" :: "r"(1 + c) : "memory");\n'
_RELEASE_NOW = "    if (t == 0) mbar_arrive(ring.empty(st));\n"
_DBIAS_DEFERRED = _DBIAS_PER_WARP + [
    (_DBIAS_WARP_RELEASE, "    prev = st;\n"),
    ("  RingPos<S> pos;\n  for (int tt = 0; tt < r; ++tt) {",
     "  RingPos<S> pos;\n  int prev = 0;\n  for (int tt = 0; tt < r; ++tt) {"),
    ("    fence_regs(sc);\n    probs_cols(sc, words,",
     "    fence_regs(sc);\n    if (tt > 0 && t == 0) mbar_arrive(ring.empty(prev));\n"
     "    probs_cols(sc, words,")]
_STAGES = "__host__ __device__ constexpr int bwd_stages(int D) { return D == 128 ? 2 : 3; }"

VARIANTS = {
    "final": [],
    "dq_unpipelined": [("template <int D> constexpr bool kDqPipelined = D <= 32;",
                        "template <int D> constexpr bool kDqPipelined = false;")],
    "dkv_scalar_bias_reads": [(_LDSM, _SCALAR)],
    "dq_bias_ahead": [
        (_DQ_TILE, _DQ_TILE.replace("    mbar_wait", _DQ_AHEAD[0] + "    mbar_wait")),
        (_DQ_ISSUED, _DQ_ISSUED + _DQ_AHEAD[1]), (_DQ_GROUPS, _COPY_WORDS)],
    "dkv_bias_ahead": [
        (_DKV_TILE, _DKV_TILE.replace("    mbar_wait", _DKV_AHEAD[0] + "    mbar_wait")),
        (_DKV_ISSUED, _DKV_ISSUED + _DKV_AHEAD[1]), (_DKV_GROUPS, _COPY_WORDS)],
    "dbias_planes_fastest": [_DBIAS_GRID, _DBIAS_LAUNCH],
    "dbias_two_blocks": [("__launch_bounds__(kBwdThreads, 1)\npair_bias_dbias_wgmma",
                          "__launch_bounds__(kBwdThreads, 2)\npair_bias_dbias_wgmma")],
    "two_stages": [(_STAGES, _STAGES.replace("? 2 : 3", "? 2 : 2"))],
    "four_stages": [(_STAGES, _STAGES.replace("? 2 : 3", "? 2 : (D == 32 ? 4 : 3)"))],
    "dkv_d128_whole": [("template <int D> constexpr int kDkvSplit = D == 128 ? 2 : 1;",
                        "template <int D> constexpr int kDkvSplit = 1;")],
    "dq_pipelined_all": [("template <int D> constexpr bool kDqPipelined = D <= 32;",
                          "template <int D> constexpr bool kDqPipelined = true;")],
    "dbias_release_synced": _DBIAS_PER_WARP + [(_DBIAS_WARP_RELEASE, _SYNC + _RELEASE_NOW)],
    "dbias_release_unsynced": _DBIAS_PER_WARP + [(_DBIAS_WARP_RELEASE, _RELEASE_NOW)],
    "dbias_release_deferred": _DBIAS_DEFERRED,
}
SHAPE = dict(R=128, h=8, s=1024, d=32, mask_rate=0.1)
# (R, d, the kernels timed there) after the main shape's three
OTHER_SHAPES = ((64, 64, ("dq",)), (32, 128, ("dq", "dkv", "dbias")))
KERNELS = ("dq", "dkv", "dbias", "dq_d64", "dq_d128", "dkv_d128", "dbias_d128")
DBIAS_REPEATS = 50


def _variant_source(text: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: a replacement does not apply once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _time_one(lib: str) -> dict:
    """Device ms of the three kernels in the library at ``lib`` at the main
    shape, and a digest of their outputs (a fresh process)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import pair_bias_attention as pb
    from apex_tpu_torch.tools.flash_bwd_compare import _device_ms

    _build._LIBS[SRC] = ctypes.CDLL(lib)
    dev = torch.device("cuda", 0)
    R, h, s, d = SHAPE["R"], SHAPE["h"], SHAPE["s"], SHAPE["d"]
    g = torch.Generator(device=dev).manual_seed(17)
    kern = {"dq": pb.PAIR_BIAS_DQ, "dkv": pb.PAIR_BIAS_DKV, "dbias": pb.PAIR_BIAS_DBIAS}
    out = {"digest": []}
    with torch.inference_mode():
        for rows, d, names in ((R, d, KERNELS[:3]),) + OTHER_SHAPES:
            q, k, v, do = (torch.randn(rows, s, h, d, generator=g, device=dev)
                           .mul(0.5).to(torch.bfloat16).transpose(1, 2) for _ in range(4))
            bias = (torch.randn(1, h, s, s, generator=g, device=dev) * 0.5).to(torch.bfloat16)
            mask = torch.rand(rows, s, generator=g, device=dev) >= SHAPE["mask_rate"]
            o, lse = pb.pair_bias_flash_attention_fwd(q, k, v, bias, mask)
            call = pb._Launch(q, k, v, bias, mask, 1.0, o=o, lse=lse, do=do)
            for name in KERNELS[:3]:
                call.launch(kern[name])
            torch.cuda.synchronize()
            out["digest"] += [float(t.float().abs().sum()) for t in
                              (call.dq, call.dk, call.dv, call.dbias)]
            if d == SHAPE["d"]:
                first = call.dbias.clone()
                same = True
                for _ in range(DBIAS_REPEATS):
                    call.launch(kern["dbias"])
                    same &= bool(torch.equal(first, call.dbias))
                out["dbias_repeat_bitwise"] = same
            for name in names:
                key = name if d == SHAPE["d"] else f"{name}_d{d}"
                out[key] = [_device_ms(lambda: call.launch(kern[name])) for _ in range(2)]
    return out


def _ptxas(log: str) -> dict:
    """Registers and spills of the bf16 kernels (``dq``, ``dq_d64``, ...)
    and the kernels whose wgmma ptxas serialized."""
    out, cur = {"serialized": []}, None
    for line in log.splitlines():
        m = re.search(r"function '([^']+)'", line) if "serialized" in line else None
        if m:
            out["serialized"].append(re.sub(r".*(pair_bias_\w+?)I(\w+?)Li(\d+)E.*",
                                            r"\1 \2 d\3", m.group(1)))
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"pair_bias_(dq|dkv|dbias)_wgmmaI13__nv_bfloat16Li(\d+)E", m.group(1))
            cur = k and (k.group(1) if k.group(2) == "32" else f"{k.group(1)}_d{k.group(2)}")
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[f"{cur}_spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[f"{cur}_registers"] = int(m.group(1))
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
    picked = [a for a in argv[1:] if a != "final"]
    unknown = [a for a in picked if a not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    if picked:
        sources = {name: sources[name] for name in ["final", *picked]}
    work = ROOT / "build" / "pair_bias_bwd_variants"
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
        report[name] = dict(_ptxas(log), **{k: [] for k in KERNELS})
    for name in list(sources) + list(sources)[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--time", str(jobs[name][0])],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: timing failed\n{proc.stdout[-1000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for k in KERNELS:
            report[name][k] += got[k]
        report[name]["digest"] = got["digest"]
        report[name]["dbias_repeat_bitwise"] = (got["dbias_repeat_bitwise"] and
                                                report[name].get("dbias_repeat_bitwise", True))
    final = report["final"]["digest"]
    for name in sources:
        report[name]["same_output_as_final"] = report[name].pop("digest") == final
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
